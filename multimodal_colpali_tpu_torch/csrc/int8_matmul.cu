// K8a / K8b: weight-only int8 matrix products for the decode engine.
//
// Replaces the two TPU kernels of multimodal_colpali_tpu/ops/int8_matmul.py:
//   K8a _kernel_kn (pl.pallas_call at int8_matmul.py:145, int8_matmul_kn):
//       C [M, N] = x [M, K] . codes [K, N] * scale [N]   (every projection)
//   K8b _kernel_nk (int8_matmul.py:179, int8_matmul_nk):
//       C [M, N] = x [M, K] . codes [N, K]^T * scale [N] (the tied LM head over
//       the row-quantized embed table)
// x is bfloat16, codes int8, scale float32; the product accumulates in float32,
// the scale multiplies the accumulator in the epilogue, and C is bfloat16 or
// float32 (the TPU kernels' order: dot on the codes, then scale, then cast).
//
// What bounds it on an H100. Decode has M = slots (4-8): every weight byte is
// read once for 2 * M operations, far below the ~295 operations per byte where
// the tensor cores would become the limit, so the kernel is bound by the bytes
// of the codes (half of bf16's; for gemma-3-27b about 27 GB per step; 0.035 ms
// for one [5376, 21504] projection). Prefill has M up to 2048 and is bound by
// the tensor cores (0.120 ms for 512 tokens through the same projection).
//
// K8a, decode tile (M <= 16): a register-dequantizing weight stream, K9's
// decode design (csrc/int4_matmul.cu) for int8 codes. The product is taken
// transposed, C^T = codes^T . x^T, on mma.sync m16n8k16: 16 of the weight's N
// columns are the 16-row A operand and the slots the 8-wide B operand (a
// second B tile for M = 9-16). A block owns 256 columns of one range of K rows
// (split-K); each stage of its 4-stage cp.async ring holds 64 K rows of codes
// (16-byte chunks along N) and the x columns they feed. 8 warps: 4 across the
// columns (64 each) x 2 halves of each stage's rows, whose sums meet in shared
// memory at the end in a fixed order. An A fragment needs pairs of K rows of
// one column, which sit in two byte rows of codes [K, N]: a lane reads 8 bytes
// (columns 8g .. 8g+7 of its warp's 64, g = lane / 4) of each of the four rows
// of its k16 step (2t, 2t+1, 2t+8, 2t+9); byte j < 4 is row g of the warp's A
// tile j, byte j >= 4 its row g + 8. It widens each code in registers (code +
// 128, a byte permute into 2^23's mantissa, minus 2^23 + 128: exact) and packs
// the top halves of two rows' floats into one A register (bf16 holds every
// |code| <= 127 exactly): nothing widened goes back to shared memory and the
// codes are read as the quantizer left them. Widening costs ~2.8 instruction
// issues a byte, well under what the memory rate leaves an SM, so the stream
// waits on memory, not on issue. The column scale multiplies the float32
// accumulator before the cast. Split-K stays deterministic: each split writes
// a float32 partial [splits, M, N] and int8_finalize sums them in order, then
// scales and casts.
//
// K8a, prefill tile (M > 16): csrc/wstream.cuh, shared with K9: the same
// register-widened A fragments on wgmma against TMA-fed tiles of 128 tokens,
// 256 columns a block.
//
// K8b: one kernel template, the tied head's [N, K] codes. A block computes a
// BM x 128 tile of C with 8 warps of 16 x 16 x 16 bf16 WMMA products and
// float32 accumulators; K advances in steps of BK. x and the int8 codes of the
// next steps arrive through a cp.async ring in shared memory (4 stages at
// decode's 16 rows, 3 stages at 128 rows), so loads overlap the tensor cores.
// Each step's codes are widened from the ring to bf16 (exact for |code| <=
// 127) into the [n][k] tile (col-major B) WMMA reads.
//   - BM = 16 for M <= 16 (decode): one row tile, each warp owns 16 columns,
//     so every block streams its weights once for all M rows; BK = 64.
//   - BM = 128 for larger M (prefill): 2 x 4 warps of 64 x 32, BK = 32.
//   - Split-K: the wrapper splits K into `splits` ranges; each block writes its
//     float32 partial tile to a workspace and int8_finalize sums them, scales
//     and casts.
//
// Every tile masks ragged M, N and K edges (zero-filled copies, guarded
// stores). Rows that are not whole 16-byte chunks (K not a multiple of 8 for
// x, of 16 for K8b's codes, N not a multiple of 16 for K8a's; no gemma-3 or
// PaliGemma shape) are copied element by element into the same ring. The TPU
// dispatch's shape gate (K, N multiples of 512, M <= 2048) does not apply.
#include <mma.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "wstream.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BN = 128;
constexpr int kThreads = 256;  // 8 warps

union Pack8 {
  uint4 u;
  bf16 h[8];
};

union Codes16 {
  uint4 u;
  signed char c[16];
};

template <bool kNK, int BM>
struct Tile {
  static constexpr int BK = BM == 16 ? 64 : 32;  // the K step
  static constexpr int LDA = BK + 8;             // shared row stride of A and [n][k] B
  static constexpr int kWarpsM = BM == 16 ? 1 : 2;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int WM = BM / kWarpsM;
  static constexpr int WN = BN / kWarpsN;
  static constexpr int FM = WM / 16;
  static constexpr int FN = WN / 16;
  static constexpr int kAChunks = BM * BK / 8;  // 16-byte chunks of A per step
  static constexpr int kAPer = (kAChunks + kThreads - 1) / kThreads;
  static constexpr int LDB = kNK ? LDA : BN + 8;  // [n][k] or [k][n] rows
  static constexpr int kBRows = kNK ? BN : BK;
  static constexpr int kBPer = BN * BK / 16 / kThreads;  // 16-byte code chunks a thread
};

// The ring: x and codes of the next steps arrive by cp.async while the
// tensor cores work on this one (4 stages of BK = 64 for the 16-row decode
// tile, 3 of BK = 32 for the 128-row tile).
template <bool kNK, int BM>
struct Ring {
  using T = Tile<kNK, BM>;
  static constexpr int kStages = BM == 16 ? 4 : 3;
  static constexpr int kA = BM * T::LDA * 2;         // a stage of x (bf16), bytes
  static constexpr int kStage = kA + BN * T::BK;     // + a stage of codes (int8)
  static constexpr int kBytes = kStages * kStage + T::kBRows * T::LDB * 2;  // + widened codes
  static_assert(kStages * kStage >= (kThreads / 32) * 256 * 4, "scratch aliases the ring");
};

template <bool kNK, int BM, typename TOut>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const bf16* __restrict__ X, const signed char* __restrict__ W,
                   const float* __restrict__ scale, TOut* __restrict__ C,
                   float* __restrict__ partial, int M, int N, int K, int k_split, bool a_vec,
                   bool b_vec) {
  using T = Tile<kNK, BM>;
  using R = Ring<kNK, BM>;
  constexpr int BK = T::BK, LDA = T::LDA, kStages = R::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Bw = reinterpret_cast<bf16*>(smem + kStages * R::kStage);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);
  const int steps = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  const int wm = warp / T::kWarpsN;
  const int wn = warp % T::kWarpsN;

  // Step `step`'s x and codes into its stage of the ring: cp.async for whole
  // 16-byte chunks (zero-filled past the edges), element copies where a row
  // is not made of them (a_vec / b_vec false).
  auto issue = [&](int step) {
    unsigned char* st = smem + (step % kStages) * R::kStage;
    const int k0 = kb + step * BK;
#pragma unroll
    for (int i = 0; i < T::kAPer; ++i) {
      const int c = tid + i * kThreads;
      if (c >= T::kAChunks) continue;
      const int m = m0 + c / (BK / 8), k = k0 + (c % (BK / 8)) * 8;
      bf16* dst = reinterpret_cast<bf16*>(st) + (c / (BK / 8)) * LDA + (c % (BK / 8)) * 8;
      const bool ok = m < M && k < ke;
      const bf16* src = X + (ok ? static_cast<size_t>(m) * K + k : 0);
      if (a_vec || !ok) {
        cp_async16(dst, src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = k + e < ke ? src[e] : __float2bfloat16(0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < T::kBPer; ++i) {
      const int c = tid + i * kThreads;
      // K8b: rows n of BK codes, ending at ke; K8a: rows k of 128 codes, ending at N
      const int r = kNK ? c / (BK / 16) : c / 8;
      const int o = kNK ? (c % (BK / 16)) * 16 : (c % 8) * 16;
      const int row = kNK ? n0 + r : k0 + r;
      const int col = kNK ? k0 + o : n0 + o;
      const bool ok = kNK ? row < N && col < ke : row < ke && col < N;
      const int col_end = kNK ? ke : N;
      signed char* dst = reinterpret_cast<signed char*>(st + R::kA) + r * (kNK ? BK : BN) + o;
      const signed char* src = W + (ok ? static_cast<size_t>(row) * (kNK ? K : N) + col : 0);
      if (b_vec || !ok) {
        cp_async16(dst, src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) dst[e] = col + e < col_end ? src[e] : 0;
      }
    }
    cp_async_commit();
  };

  using BLayout = typename std::conditional<kNK, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      issue(s);
    else
      cp_async_commit();  // one group per step keeps the wait count right
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's stage has arrived; the last step's WMMA is done
    if (step + kStages - 1 < steps)
      issue(step + kStages - 1);  // refills the stage the last step used
    else
      cp_async_commit();
    const unsigned char* st = smem + (step % kStages) * R::kStage;
#pragma unroll
    for (int i = 0; i < T::kBPer; ++i) {  // widen the codes
      const int c = tid + i * kThreads;
      const int r = kNK ? c / (BK / 16) : c / 8;
      const int o = kNK ? (c % (BK / 16)) * 16 : (c % 8) * 16;
      Codes16 b;
      b.u = *reinterpret_cast<const uint4*>(st + R::kA + r * (kNK ? BK : BN) + o);
      Pack8 lo, hi;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        lo.h[e] = __float2bfloat16(static_cast<float>(b.c[e]));
        hi.h[e] = __float2bfloat16(static_cast<float>(b.c[e + 8]));
      }
      bf16* dst = Bw + r * T::LDB + o;
      *reinterpret_cast<uint4*>(dst) = lo.u;
      *reinterpret_cast<uint4*>(dst + 8) = hi.u;
    }
    __syncthreads();
    const bf16* As = reinterpret_cast<const bf16*>(st);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[T::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bfr[T::FN];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * T::WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < T::FN; ++j) {
        const int nn = wn * T::WN + j * 16;
        if constexpr (kNK)
          wmma::load_matrix_sync(bfr[j], Bw + nn * T::LDB + kk, T::LDB);
        else
          wmma::load_matrix_sync(bfr[j], Bw + kk * T::LDB + nn, T::LDB);
      }
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: its first 8 KB hold each warp's 16 x 16 scratch
  float* sc = reinterpret_cast<float*>(smem) + warp * 256;
  const int rr = lane / 2;
  const int cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < T::FM; ++i) {
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * T::WM + i * 16 + rr;
      const int n = n0 + wn * T::WN + j * 16 + cc;
      if (m < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (n + e >= N) break;
          const float v = sc[rr * 16 + cc + e];
          const size_t at = static_cast<size_t>(m) * N + n + e;
          if (partial != nullptr)
            partial[static_cast<size_t>(blockIdx.z) * M * N + at] = v;
          else
            C[at] = from_f32<TOut>(v * scale[n + e]);
        }
      }
      __syncwarp();  // the scratch tile is rewritten next
    }
  }
}

// ---- K8a decode tile (M <= 16) ---------------------------------------------------

constexpr int kDecCols = 4;              // warps across a block's columns, 64 each
constexpr int kDecWarps = 2 * kDecCols;  // x 2 halves of each stage's K rows
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecBN = 64 * kDecCols;    // columns a block
constexpr int kDecBK = 64;               // K rows a stage
constexpr int kDecStages = 4;
constexpr int kDecMinBlocks = 2;         // an SM holds two blocks: <= 128 registers a thread
constexpr int kDecLDW = kDecBN + 16;     // code row stride, bytes: two rows apart are
                                         // 32 bytes apart modulo 128, so a half warp's
                                         // 8-byte reads hit distinct banks
constexpr int kDecLDX = kDecBK + 8;      // x row stride (bf16)

template <int MT>
struct DecRing {
  static constexpr int kCodes = kDecBK * kDecLDW;
  static constexpr int kStage = kCodes + MT * kDecLDX * 2;
  static constexpr int kBytes = kDecStages * kStage;
  static_assert(kBytes >= kDecCols * 32 * (MT / 8) * 16 * 4, "scratch aliases the ring");
};

template <typename TOut>
__device__ __forceinline__ void store8(TOut* dst, const float (&v)[8], int valid, bool vec) {
  const float lo[4] = {v[0], v[1], v[2], v[3]}, hi[4] = {v[4], v[5], v[6], v[7]};
  wstream::store4<TOut>(dst, lo, valid, vec);
  wstream::store4<TOut>(dst + 4, hi, valid - 4, vec);
}

// MT = 8 or 16 slots staged (M <= MT). `partial` non-null: write the split's
// float32 sums there instead of scaled C.
template <int MT, typename TOut>
__global__ void __launch_bounds__(kDecThreads, kDecMinBlocks)
int8_decode_kernel(const bf16* __restrict__ X, const signed char* __restrict__ W,
                   const float* __restrict__ scale, TOut* __restrict__ C,
                   float* __restrict__ partial, int M, int N, int K, int k_split, bool a_vec,
                   bool b_vec, bool c_vec) {
  using R = DecRing<MT>;
  using wstream::int8_of;
  using wstream::pack_exact;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int cw = warp % kDecCols;  // the warp's 64 columns
  const int kh = warp / kDecCols;  // and its half of each stage's K rows
  const int n0 = blockIdx.x * kDecBN;
  const int kb = blockIdx.z * k_split;
  const int ke = min(K, kb + k_split);
  const int steps = ke > kb ? (ke - kb + kDecBK - 1) / kDecBK : 0;

  auto issue = [&](int step) {
    unsigned char* st = smem + (step % kDecStages) * R::kStage;
    const int k0 = kb + step * kDecBK;
    for (int c = tid; c < kDecBK * kDecBN / 16; c += kDecThreads) {
      const int r = c / (kDecBN / 16), o = (c % (kDecBN / 16)) * 16;
      const int k = k0 + r, col = n0 + o;
      const bool ok = k < ke && col < N;
      unsigned char* dst = st + r * kDecLDW + o;
      const signed char* src = W + (ok ? static_cast<size_t>(k) * N + col : 0);
      if (b_vec || !ok) {
        cp_async16(dst, src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) dst[e] = col + e < N ? src[e] : 0;
      }
    }
    bf16* xs = reinterpret_cast<bf16*>(st + R::kCodes);
    if (a_vec) {
      for (int c = tid; c < MT * kDecBK / 8; c += kDecThreads) {
        const int m = c / (kDecBK / 8), cc = (c % (kDecBK / 8)) * 8;
        const bool ok = m < M && k0 + cc < ke;
        cp_async16(xs + m * kDecLDX + cc, X + (ok ? static_cast<size_t>(m) * K + k0 + cc : 0),
                   ok);
      }
    } else {
      for (int e = tid; e < MT * kDecBK; e += kDecThreads) {
        const int m = e / kDecBK, cc = e % kDecBK;
        xs[m * kDecLDX + cc] = m < M && k0 + cc < ke ? X[static_cast<size_t>(m) * K + k0 + cc]
                                                     : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
  };

  float acc[MT / 8][4][4];
#pragma unroll
  for (int b = 0; b < MT / 8; ++b)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[b][t][0] = acc[b][t][1] = acc[b][t][2] = acc[b][t][3] = 0.f;

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
#pragma unroll
    for (int kk = 0; kk < kDecBK / 32; ++kk) {
      const int r = 16 * (kh * kDecBK / 32 + kk) + 2 * t4;  // rows r, r+1, r+8, r+9
      uint2 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = *reinterpret_cast<const uint2*>(codes + (r + (i & 1) + 8 * (i >> 1)) * kDecLDW);
        w[i].x ^= 0x80808080u;
        w[i].y ^= 0x80808080u;
      }
      unsigned bx[MT / 8][2];
#pragma unroll
      for (int b = 0; b < MT / 8; ++b) {
        bx[b][0] = *reinterpret_cast<const unsigned*>(xr + 8 * b * kDecLDX + r);
        bx[b][1] = *reinterpret_cast<const unsigned*>(xr + 8 * b * kDecLDX + r + 8);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        // A rows g and g + 8 of tile t are columns 8g + t and 8g + 4 + t
        const unsigned a[4] = {pack_exact(int8_of(w[0].x, t), int8_of(w[1].x, t)),
                               pack_exact(int8_of(w[0].y, t), int8_of(w[1].y, t)),
                               pack_exact(int8_of(w[2].x, t), int8_of(w[3].x, t)),
                               pack_exact(int8_of(w[2].y, t), int8_of(w[3].y, t))};
#pragma unroll
        for (int b = 0; b < MT / 8; ++b) wstream::mma_bf16(acc[b][t], a, bx[b][0], bx[b][1]);
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
  const int ncol = n0 + cw * 64 + 8 * g;
  const int valid = N - ncol;
  if (valid <= 0) return;
  float cs[8];
  {
    float lo[4], hi[4];
    wstream::load_scales4(lo, scale, 0, ncol, N, c_vec);
    wstream::load_scales4(hi, scale, 0, ncol + 4, N, c_vec);
#pragma unroll
    for (int j = 0; j < 4; ++j) cs[j] = lo[j], cs[4 + j] = hi[j];
  }
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
      if (partial != nullptr) {
        store8<float>(partial + static_cast<size_t>(blockIdx.z) * M * N + at, v, valid, c_vec);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] *= cs[j];
        store8<TOut>(C + at, v, valid, c_vec);
      }
    }
}

// C = (sum over the splits of partial) * scale, cast.
template <typename TOut>
__global__ void int8_finalize(const float* __restrict__ partial, const float* __restrict__ scale,
                              TOut* __restrict__ C, int M, int N, int splits) {
  const size_t total = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * total + i];
    C[i] = from_f32<TOut>(s * scale[i % N]);
  }
}

template <typename TOut>
cudaError_t finalize(const float* partial, const float* scale, TOut* C, int M, int N, int splits,
                     cudaStream_t s) {
  const long long total = static_cast<long long>(M) * N;
  const int blocks = static_cast<int>(std::min<long long>((total + 255) / 256, 4096));
  int8_finalize<TOut><<<blocks, 256, 0, s>>>(partial, scale, C, M, N, splits);
  return cudaGetLastError();
}

// K8b
template <bool kNK, int BM, typename TOut>
cudaError_t launch(const bf16* X, const signed char* W, const float* scale, TOut* C,
                   float* partial, int M, int N, int K, int splits, cudaStream_t s) {
  // each split covers a whole number of K steps
  constexpr int BK = Tile<kNK, BM>::BK;
  const int steps = (K + BK - 1) / BK;
  const int k_split = ((steps + splits - 1) / splits) * BK;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  // rows that are whole 16-byte chunks from a 16-byte aligned start go by cp.async
  const bool a_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const bool b_vec = (kNK ? K : N) % 16 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  auto kernel = int8_matmul_kernel<kNK, BM, TOut>;
  // The ring needs more than the default 48 KB of shared memory. The opt-in
  // belongs to the current device, so it is set at every launch.
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Ring<kNK, BM>::kBytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, Ring<kNK, BM>::kBytes, s>>>(
      X, W, scale, C, splits > 1 ? partial : nullptr, M, N, K, k_split, a_vec, b_vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return finalize<TOut>(partial, scale, C, M, N, splits, s);
}

template <int MT, typename TOut>
cudaError_t launch_decode(const bf16* X, const signed char* W, const float* scale, TOut* C,
                          float* partial, int M, int N, int K, int splits, cudaStream_t s) {
  using R = DecRing<MT>;
  const int steps = (K + kDecBK - 1) / kDecBK;
  const int k_split = ((steps + splits - 1) / splits) * kDecBK;  // each split whole stages
  const dim3 grid((N + kDecBN - 1) / kDecBN, 1, splits);
  const bool a_vec = K % 8 == 0 && wstream::aligned16(X);
  const bool b_vec = N % 16 == 0 && wstream::aligned16(W);
  const bool c_vec = N % 4 == 0 && wstream::aligned16(scale) &&
                     wstream::aligned16(splits > 1 ? static_cast<const void*>(partial)
                                                   : static_cast<const void*>(C));
  // the opt-in belongs to the current device, so it is set at every launch
  cudaError_t e = cudaFuncSetAttribute(int8_decode_kernel<MT, TOut>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
  if (e != cudaSuccess) return e;
  int8_decode_kernel<MT, TOut><<<grid, kDecThreads, R::kBytes, s>>>(
      X, W, scale, C, splits > 1 ? partial : nullptr, M, N, K, k_split, a_vec, b_vec, c_vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return finalize<TOut>(partial, scale, C, M, N, splits, s);
}

// K8a: the decode tile for M <= 16, else the prefill tile (csrc/wstream.cuh).
template <typename TOut>
cudaError_t launch_kn(const bf16* X, const signed char* W, const float* scale, TOut* C,
                      float* partial, int M, int N, int K, int splits, cudaStream_t s) {
  if (M <= 8) return launch_decode<8, TOut>(X, W, scale, C, partial, M, N, K, splits, s);
  if (M <= 16) return launch_decode<16, TOut>(X, W, scale, C, partial, M, N, K, splits, s);
  const cudaError_t e = wstream::launch_prefill<false, TOut>(
      X, reinterpret_cast<const unsigned char*>(W), scale, C, partial, M, N, K, 0, splits, s);
  if (e != cudaSuccess || splits == 1) return e;
  return finalize<TOut>(partial, scale, C, M, N, splits, s);
}

}  // namespace

// C [M, N] = x [M, K] . B * scale [N], with B = codes [K, N] (layout 0, K8a)
// or codes [N, K]^T (layout 1, K8b). x bfloat16, codes int8, scale float32;
// C float32 (out_dtype 0) or bfloat16 (1). splits > 1 needs `partial`, a
// float32 workspace of splits * M * N; the splits must not outnumber the K
// steps (K8a: 64 wide; K8b: 64 wide for M <= 16, else 32). Any M, N, K >= 1.
extern "C" int int8_matmul_launch(const void* x, const void* codes, const void* scale, void* out,
                                  void* partial, int M, int N, int K, int layout, int out_dtype,
                                  int splits, void* stream) {
  const int bk = layout == 0 ? kDecBK : M <= 16 ? Tile<true, 16>::BK : Tile<true, 128>::BK;
  static_assert(kDecBK == wstream::kPreK, "K8a's two tiles step K alike");
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || splits > (K + bk - 1) / bk)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((layout != 0 && layout != 1) || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* X = static_cast<const bf16*>(x);
  const signed char* W = static_cast<const signed char*>(codes);
  const float* S = static_cast<const float*>(scale);
  float* P = static_cast<float*>(partial);
  if (layout == 0)
    return static_cast<int>(
        out_dtype == 0 ? launch_kn<float>(X, W, S, static_cast<float*>(out), P, M, N, K, splits, s)
                       : launch_kn<bf16>(X, W, S, static_cast<bf16*>(out), P, M, N, K, splits, s));
  const bool small = M <= 16;
#define INT8_CASE(BM)                                                                         \
  return static_cast<int>(out_dtype == 0                                                      \
                              ? launch<true, BM, float>(X, W, S, static_cast<float*>(out), P, \
                                                        M, N, K, splits, s)                   \
                              : launch<true, BM, bf16>(X, W, S, static_cast<bf16*>(out), P,   \
                                                       M, N, K, splits, s));
  if (small) INT8_CASE(16)
  INT8_CASE(128)
#undef INT8_CASE
}
