// K9: group-wise int4 weight matrix product for the decode engine.
//
// Replaces the TPU kernel multimodal_colpali_tpu/ops/int4_matmul.py::_kernel_kn4
// (pl.pallas_call at int4_matmul.py:134, int4_matmul_kn):
//
//   C [M, N] = x [M, K] . W [K, N],  W[k, n] = round_x((code[k, n] - 8) * scale[k / G, n])
//
// x is bfloat16; the codes are nibbles packed two to a byte, packed [K/2, N]
// uint8; scale [K/G, N] float32. The packing is split per group, not
// interleaved (ops/quant.py quantize_int4): within group g, byte row
// g*G/2 + r holds the code of K row g*G + r in its low nibble and that of K row
// g*G + G/2 + r in its high nibble, so byte row p feeds K rows k_lo(p) and
// k_lo(p) + G/2, k_lo(p) = (p / (G/2)) * G + p % (G/2). Each weight is widened
// to float32, scaled by its group's scale and rounded to bfloat16 *before* the
// dot, as the TPU kernel does (int4_matmul.py:93-99); the dot accumulates in
// float32 and C is cast to bfloat16 or float32 at the end. There is no
// epilogue scale. The bytes are read as quantize_int4 left them: no repack.
//
// What bounds it on an H100. Decode has M = slots (4-8): each packed byte is
// read once for 4 * M operations, far below the ~295 operations a byte where
// the tensor cores would be the limit, so the kernel is bound by the bytes of
// the codes and scales (for gemma-3-27b about 13.2 GB a decode step, half of
// K8's; 0.018 ms for one [5376, 21504] projection). At that rate an SM must
// turn ~15 code bytes a cycle into bf16 weights, so the dequantization's
// instruction count, not the tensor cores, is the second limit. Prefill has M
// up to 2048 and is bound by the tensor cores.
//
// Decode tile (M <= 16): a register-dequantizing weight stream. The product
// is taken transposed, C^T = W^T . x^T, on mma.sync m16n8k16: 16 of the
// weight's N columns are the 16-row A operand and the slots the 8-wide B
// operand, so M <= 8 wastes no tensor-core rows and M = 9-16 takes a second
// B tile. A block owns 256 columns of one range of byte rows (split-K); each
// stage of its 4-stage cp.async ring holds 64 byte rows of codes (16-byte
// chunks along N), the x columns they feed and, when G/2 is a multiple of 64,
// the stage's group's scales. 8 warps: 4 across the columns (64 each) x 2
// halves of each stage's byte rows, whose sums meet in shared memory at the
// end in a fixed order. One k16 step of the product covers 8 byte rows: its
// k index i < 8 is the low nibble of byte row p0 + i, i >= 8 the high nibble
// of byte row p0 + i - 8, so one byte feeds two A registers and x's B
// fragments come from two runs of x, at k_lo and k_lo + G/2, staged side by
// side. A lane reads 8 bytes (columns 8g .. 8g+7 of its warp's 64, g =
// lane / 4) of each of its two byte rows; byte j < 4 is row g of the warp's A
// tile j, byte j >= 4 its row g + 8. It widens each nibble in registers (a
// byte permute into a float's mantissa, minus 2^23 + 8, times the float32
// scale, rounded to bf16) and packs the pairs straight into the A fragments:
// nothing widened goes back to shared memory and no barrier separates
// widening from the product. What holds it at ~2.4x its byte bound is that
// widening: ~130 instructions a lane for each 512 bytes a warp takes (byte
// permutes at half rate, bf16 packs at quarter rate), at two blocks of 8
// warps an SM (the register cap that allows two), so the stream waits on
// instruction issue, not on memory. Split-K stays deterministic: each split
// writes a float32 partial [splits, M, N] (at least 8 stages a split, so the
// partial is at most 1/16 of the codes' bytes and stays in L2) and
// int4_finalize sums the splits in order.
//
// Prefill tile (M > 16): csrc/wstream.cuh, shared with K8a: the same
// transposed product on wgmma, the codes widened, scaled and rounded in
// registers into A fragments (each feeds 128 tokens of products there, so the
// widening that holds the decode tile is spread over 16x the tensor-core
// work), x's tokens the B operand in shared memory, TMA-fed. On gemma-3's
// G = 256 a stage of 32 byte rows lies in one group: x arrives as the two runs
// k_lo .. k_lo+31 and k_lo + G/2 .. +31 and the group's scales with the codes.
//
// Both tiles take any even G that divides K. When a stage never crosses a
// group (G/2 a multiple of its byte rows) and x's rows are whole 16-byte
// chunks, x arrives by cp.async as two contiguous runs; otherwise (the
// gathered path) each x element is gathered into the same ring and each lane
// loads the scales of its byte rows' groups. Codes arrive by cp.async where N is
// a multiple of 16, else element by element. Ragged M, N and K edges are
// masked. The TPU dispatch's shape gate (N % 512 == 0) does not apply.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "wstream.cuh"

namespace {

using bf16 = __nv_bfloat16;
using wstream::code_of;
using wstream::mma_bf16;
using wstream::pack_bf16;

// ---- decode tile (M <= 16) -------------------------------------------------------

constexpr int kDecCols = 4;              // warps across a block's columns, 64 each
constexpr int kDecWarps = 2 * kDecCols;  // x 2 halves of each stage's byte rows
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecBN = 64 * kDecCols;    // columns a block
constexpr int kDecBR = 64;               // packed byte rows a stage
constexpr int kDecStages = 4;
constexpr int kDecMinBlocks = 2;         // an SM holds two blocks: <= 128 registers a thread
constexpr int kDecLDW = kDecBN + 16;     // code row stride, bytes: two byte rows apart
                                         // are 32 bytes apart modulo 128, so a
                                         // warp's 8-byte reads hit distinct banks
constexpr int kDecLDX = 2 * kDecBR + 8;  // x row stride (bf16): lo run, hi run, pad

// A stage: codes [kDecBR][kDecLDW] bytes, x [MT][kDecLDX] bf16, and the
// stage's group's scales [kDecBN] float32 (when G/2 is a multiple of kDecBR).
template <int MT>
struct DecRing {
  static constexpr int kCodes = kDecBR * kDecLDW;
  static constexpr int kX = MT * kDecLDX * 2;
  static constexpr int kStage = kCodes + kX + kDecBN * 4;
  static constexpr int kBytes = kDecStages * kStage;
  static_assert(kBytes >= kDecCols * 32 * (MT / 8) * 16 * 4, "scratch aliases the ring");
};

// The float32 scales of the 8 columns n .. n+7 in group `grp` (-1: zeros).
__device__ __forceinline__ void load_scales(float (&s)[8], const float* scale, int grp, int n,
                                            int N, bool s_vec) {
  if (grp < 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.f;
    return;
  }
  const float* src = scale + static_cast<size_t>(grp) * N + n;
  if (s_vec && n + 8 <= N) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w, s[4] = b.x, s[5] = b.y, s[6] = b.z, s[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = n + j < N ? __ldg(src + j) : 0.f;
  }
}

// One k16 step of a warp: byte rows ra and ra + 1 of the stage (scales sa,
// sb), the lane's 8 columns `codes`, x rows g and g + 8 at `xr`.
template <int MT>
__device__ __forceinline__ void k16_step(float (&acc)[MT / 8][4][4],
                                         const unsigned char* codes, const bf16* xr, int ra,
                                         const float (&sa)[8], const float (&sb)[8]) {
  const uint2 wa = *reinterpret_cast<const uint2*>(codes + ra * kDecLDW);
  const uint2 wb = *reinterpret_cast<const uint2*>(codes + (ra + 1) * kDecLDW);
  const unsigned la[2] = {wa.x & 0x0F0F0F0Fu, wa.y & 0x0F0F0F0Fu};
  const unsigned ha[2] = {(wa.x >> 4) & 0x0F0F0F0Fu, (wa.y >> 4) & 0x0F0F0F0Fu};
  const unsigned lb[2] = {wb.x & 0x0F0F0F0Fu, wb.y & 0x0F0F0F0Fu};
  const unsigned hb[2] = {(wb.x >> 4) & 0x0F0F0F0Fu, (wb.y >> 4) & 0x0F0F0F0Fu};
  unsigned bx[MT / 8][2];
#pragma unroll
  for (int b = 0; b < MT / 8; ++b) {
    bx[b][0] = *reinterpret_cast<const unsigned*>(xr + 8 * b * kDecLDX + ra);
    bx[b][1] = *reinterpret_cast<const unsigned*>(xr + 8 * b * kDecLDX + kDecBR + ra);
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    // A rows g and g + 8 of tile t are columns 8g + t and 8g + 4 + t
    const unsigned a[4] = {
        pack_bf16(code_of(la[0], t) * sa[t], code_of(lb[0], t) * sb[t]),
        pack_bf16(code_of(la[1], t) * sa[4 + t], code_of(lb[1], t) * sb[4 + t]),
        pack_bf16(code_of(ha[0], t) * sa[t], code_of(hb[0], t) * sb[t]),
        pack_bf16(code_of(ha[1], t) * sa[4 + t], code_of(hb[1], t) * sb[4 + t])};
#pragma unroll
    for (int b = 0; b < MT / 8; ++b) mma_bf16(acc[b][t], a, bx[b][0], bx[b][1]);
  }
}

template <typename TOut>
__device__ __forceinline__ void store8(TOut* dst, const float (&v)[8], int valid, bool vec);

template <>
__device__ __forceinline__ void store8<float>(float* dst, const float (&v)[8], int valid,
                                              bool vec) {
  if (vec && valid >= 8) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < valid) dst[j] = v[j];
  }
}

template <>
__device__ __forceinline__ void store8<bf16>(bf16* dst, const float (&v)[8], int valid, bool vec) {
  if (vec && valid >= 8) {
    const uint4 u = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                               pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    *reinterpret_cast<uint4*>(dst) = u;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < valid) dst[j] = __float2bfloat16(v[j]);
  }
}

// MT = 8 or 16 slots staged (M <= MT). `partial` non-null: write the split's
// float32 sums there instead of C. `grouped`: G/2 is a multiple of kDecBR, so
// a stage lies in one group and its scales ride the ring.
template <int MT, typename TOut>
__global__ void __launch_bounds__(kDecThreads, kDecMinBlocks)
int4_decode_kernel(const bf16* __restrict__ X, const unsigned char* __restrict__ W,
                   const float* __restrict__ scale, TOut* __restrict__ C,
                   float* __restrict__ partial, int M, int N, int K, int G, int p_split,
                   bool grouped, bool a_vec, bool b_vec, bool s_vec, bool c_vec) {
  using R = DecRing<MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int cw = warp % kDecCols;  // the warp's 64 columns
  const int kh = warp / kDecCols;  // and its half of each stage's byte rows
  const int H = G / 2;             // byte rows a group
  const int n0 = blockIdx.x * kDecBN;
  const int pb = blockIdx.z * p_split;
  const int pe = min(K / 2, pb + p_split);
  const int steps = pe > pb ? (pe - pb + kDecBR - 1) / kDecBR : 0;

  // Stage `step`: its byte rows of codes; for each slot, x at k_lo(p) of
  // every byte row p (the lo run) and at k_lo(p) + G/2 (the hi run); and,
  // when grouped, the group's scales of the block's columns.
  auto issue = [&](int step) {
    unsigned char* st = smem + (step % kDecStages) * R::kStage;
    const int p0 = pb + step * kDecBR;
    for (int c = tid; c < kDecBR * kDecBN / 16; c += kDecThreads) {
      const int r = c / (kDecBN / 16), o = (c % (kDecBN / 16)) * 16;
      const int p = p0 + r, col = n0 + o;
      const bool ok = p < pe && col < N;
      unsigned char* dst = st + r * kDecLDW + o;
      const unsigned char* src = W + (ok ? static_cast<size_t>(p) * N + col : 0);
      if (b_vec || !ok) {
        cp_async16(dst, src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) dst[e] = col + e < N ? src[e] : 0;
      }
    }
    bf16* xs = reinterpret_cast<bf16*>(st + R::kCodes);
    if (a_vec) {  // the stage lies in one group: two contiguous, aligned runs of x
      const int k_lo = (p0 / H) * G + p0 % H;
      for (int c = tid; c < MT * 2 * kDecBR / 8; c += kDecThreads) {
        const int m = c / (2 * kDecBR / 8), cc = (c % (2 * kDecBR / 8)) * 8;
        const int k = k_lo + (cc >= kDecBR ? H + cc - kDecBR : cc);
        const bool ok = m < M && p0 + cc % kDecBR < pe;
        cp_async16(xs + m * kDecLDX + cc, X + (ok ? static_cast<size_t>(m) * K + k : 0), ok);
      }
    } else {  // gather element by element
      for (int e = tid; e < MT * 2 * kDecBR; e += kDecThreads) {
        const int m = e / (2 * kDecBR), col = e % (2 * kDecBR);
        const int p = p0 + col % kDecBR;
        bf16 val = __float2bfloat16(0.f);
        if (m < M && p < pe)
          val = X[static_cast<size_t>(m) * K + (p / H) * G + p % H + (col >= kDecBR ? H : 0)];
        xs[m * kDecLDX + col] = val;
      }
    }
    if (grouped) {
      float* ss = reinterpret_cast<float*>(st + R::kCodes + R::kX);
      const float* src = scale + static_cast<size_t>(p0 / H) * N + n0;
      for (int c = tid; c < kDecBN / 4; c += kDecThreads) {
        const bool ok = n0 + 4 * c < N;
        if (s_vec) {
          cp_async16(ss + 4 * c, ok ? src + 4 * c : scale, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) ss[4 * c + e] = n0 + 4 * c + e < N ? src[4 * c + e] : 0.f;
        }
      }
    }
    cp_async_commit();
  };

  float acc[MT / 8][4][4];
#pragma unroll
  for (int b = 0; b < MT / 8; ++b)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[b][t][0] = acc[b][t][1] = acc[b][t][2] = acc[b][t][3] = 0.f;
  const int ncol = n0 + cw * 64 + 8 * g;  // this lane's 8 columns
  int ga = -2, gb = -2;                   // ungrouped: the groups whose scales sa, sb hold
  float sa[8], sb[8];

  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < steps)
      issue(s);
    else
      cp_async_commit();  // one group per step keeps the wait count right
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // this stage has arrived; every warp is done with the last one
    if (step + kDecStages - 1 < steps)
      issue(step + kDecStages - 1);  // refills the stage the last step used
    else
      cp_async_commit();
    const unsigned char* st = smem + (step % kDecStages) * R::kStage;
    const unsigned char* codes = st + cw * 64 + 8 * g;
    const bf16* xr = reinterpret_cast<const bf16*>(st + R::kCodes) + g * kDecLDX;
    if (grouped) {
      const float4* ss =
          reinterpret_cast<const float4*>(st + R::kCodes + R::kX) + (cw * 64 + 8 * g) / 4;
      const float4 s0 = ss[0], s1 = ss[1];
      sa[0] = s0.x, sa[1] = s0.y, sa[2] = s0.z, sa[3] = s0.w;
      sa[4] = s1.x, sa[5] = s1.y, sa[6] = s1.z, sa[7] = s1.w;
#pragma unroll
      for (int kk = 0; kk < kDecBR / 16; ++kk)
        k16_step<MT>(acc, codes, xr, 8 * (kh * kDecBR / 16 + kk) + 2 * t4, sa, sa);
    } else {
      const int p0 = pb + step * kDecBR;
      for (int kk = 0; kk < kDecBR / 16; ++kk) {
        const int ra = 8 * (kh * kDecBR / 16 + kk) + 2 * t4;
        const int pa = p0 + ra;
        const int want_a = pa < pe ? pa / H : -1, want_b = pa + 1 < pe ? (pa + 1) / H : -1;
        if (want_a != ga) {
          ga = want_a;
          load_scales(sa, scale, ga, ncol, N, s_vec);
        }
        if (want_b != gb) {
          gb = want_b;
          load_scales(sb, scale, gb, ncol, N, s_vec);
        }
        k16_step<MT>(acc, codes, xr, ra, sa, sb);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the second half's sums go through it

  float* scratch = reinterpret_cast<float*>(smem) + (cw * 32 + lane) * (MT / 8) * 16;
  if (kh == 1) {
#pragma unroll
    for (int b = 0; b < MT / 8; ++b)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) scratch[(b * 4 + t) * 4 + e] = acc[b][t][e];
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int b = 0; b < MT / 8; ++b)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][t][e] += scratch[(b * 4 + t) * 4 + e];

  // c[0], c[1]: slots 2t4, 2t4 + 1 at column 8g + t; c[2], c[3]: at 8g + 4 + t
  const int valid = N - ncol;
  if (valid <= 0) return;
#pragma unroll
  for (int b = 0; b < MT / 8; ++b)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * b + 2 * t4 + e;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        v[t] = acc[b][t][e];
        v[4 + t] = acc[b][t][2 + e];
      }
      const size_t at = static_cast<size_t>(m) * N + ncol;
      if (partial != nullptr)
        store8<float>(partial + static_cast<size_t>(blockIdx.z) * M * N + at, v, valid, c_vec);
      else
        store8<TOut>(C + at, v, valid, c_vec);
    }
}

// C = sum over the splits of partial, cast.
template <typename TOut>
__global__ void int4_finalize(const float* __restrict__ partial, TOut* __restrict__ C, int M,
                              int N, int splits) {
  const size_t total = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * total + i];
    C[i] = from_f32<TOut>(s);
  }
}

template <typename TOut>
cudaError_t finalize(const float* partial, TOut* C, int M, int N, int splits, cudaStream_t s) {
  const long long total = static_cast<long long>(M) * N;
  const int blocks = static_cast<int>(std::min<long long>((total + 255) / 256, 4096));
  int4_finalize<TOut><<<blocks, 256, 0, s>>>(partial, C, M, N, splits);
  return cudaGetLastError();
}

using wstream::aligned16;

template <int MT, typename TOut>
cudaError_t launch_decode(const bf16* X, const unsigned char* W, const float* scale, TOut* C,
                          float* partial, int M, int N, int K, int G, int splits,
                          cudaStream_t s) {
  using R = DecRing<MT>;
  const int steps = (K / 2 + kDecBR - 1) / kDecBR;
  const int p_split = ((steps + splits - 1) / splits) * kDecBR;  // each split whole stages
  const dim3 grid((N + kDecBN - 1) / kDecBN, 1, splits);
  const bool grouped = (G / 2) % kDecBR == 0;
  const bool a_vec = grouped && K % 8 == 0 && aligned16(X);
  const bool b_vec = N % 16 == 0 && aligned16(W);
  const bool s_vec = N % 4 == 0 && aligned16(scale);
  const bool c_vec = N % 8 == 0 && aligned16(splits > 1 ? static_cast<const void*>(partial)
                                                        : static_cast<const void*>(C));
  // the opt-in belongs to the current device, so it is set at every launch
  cudaError_t e = cudaFuncSetAttribute(int4_decode_kernel<MT, TOut>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
  if (e != cudaSuccess) return e;
  int4_decode_kernel<MT, TOut><<<grid, kDecThreads, R::kBytes, s>>>(
      X, W, scale, C, splits > 1 ? partial : nullptr, M, N, K, G, p_split, grouped, a_vec, b_vec,
      s_vec, c_vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return finalize<TOut>(partial, C, M, N, splits, s);
}

template <typename TOut>
cudaError_t launch(const bf16* X, const unsigned char* W, const float* scale, TOut* C,
                   float* partial, int M, int N, int K, int G, int splits, cudaStream_t s) {
  if (M <= 8) return launch_decode<8, TOut>(X, W, scale, C, partial, M, N, K, G, splits, s);
  if (M <= 16) return launch_decode<16, TOut>(X, W, scale, C, partial, M, N, K, G, splits, s);
  const cudaError_t e =
      wstream::launch_prefill<true, TOut>(X, W, scale, C, partial, M, N, K, G, splits, s);
  if (e != cudaSuccess || splits == 1) return e;
  return finalize<TOut>(partial, C, M, N, splits, s);
}

}  // namespace

// C [M, N] = x [M, K] . dequant(packed [K/2, N], scale [K/G, N]); x bfloat16,
// packed uint8, scale float32; C float32 (out_dtype 0) or bfloat16 (1). G is
// even and divides K. M <= 16 takes the decode tile (K steps of 64 byte rows),
// larger M the prefill tile (32; csrc/wstream.cuh). splits > 1 needs
// `partial`, a float32 workspace of splits * M * N; the splits must not
// outnumber the K steps. Any M, N >= 1.
extern "C" int int4_matmul_launch(const void* x, const void* packed, const void* scale,
                                  void* out, void* partial, int M, int N, int K, int G,
                                  int out_dtype, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || G < 2 || G % 2 != 0 || K % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int br = M <= 16 ? kDecBR : wstream::PreRing<true>::kRows;
  if (splits < 1 || splits > (K / 2 + br - 1) / br || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* X = static_cast<const bf16*>(x);
  const unsigned char* W = static_cast<const unsigned char*>(packed);
  const float* S = static_cast<const float*>(scale);
  float* P = static_cast<float*>(partial);
  return static_cast<int>(out_dtype == 0
                              ? launch<float>(X, W, S, static_cast<float*>(out), P, M, N, K, G,
                                              splits, s)
                              : launch<bf16>(X, W, S, static_cast<bf16*>(out), P, M, N, K, G,
                                             splits, s));
}
