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
// g*G + G/2 + r in its high nibble. Each weight is widened to float32, scaled by
// its group's scale and rounded to bfloat16 *before* the dot, as the TPU kernel
// does (int4_matmul.py:93-99); the dot accumulates in float32 and C is cast to
// bfloat16 or float32 at the end. There is no epilogue scale.
//
// What bounds it on an H100. Decode has M = slots (4-8): each packed byte is
// read once for 4 * M operations, far below the ~295 operations a byte where the
// tensor cores would be the limit, so the kernel is bound by the bytes of the
// codes and scales (for gemma-3-27b about 13.2 GB a decode step, half of K8's).
// Prefill has M up to 2048 and is bound by the tensor cores.
//
// Design: K8a's kernel (csrc/int8_matmul.cu) with a K step of BR packed byte
// rows. A block computes a BM x 128 tile of C with 8 warps of 16 x 16 x 16 bf16
// WMMA products and float32 accumulators. One step takes BR consecutive byte
// rows p0 .. p0+BR-1; they feed 2*BR K rows, so the step's A tile is
// [BM, 2*BR]: column i holds x[:, k_lo(p0+i)], column BR+i holds x[:, k_lo(p0+i)
// + G/2], with k_lo(p) = (p / (G/2)) * G + p % (G/2). No interleave is needed:
// the widened B tile has the low nibbles of the BR byte rows in its first BR
// rows and the high nibbles in the next BR, scaled by the group of each row.
//   - BR = 32 byte rows (64 K rows) a step.
//   - BM = 16 for M <= 16 (decode), 4-stage cp.async ring. Each warp
//     owns 16 columns of C and widens exactly those columns of the step's 32
//     byte rows (lane = byte row), so a warp barrier, not a block barrier,
//     separates the widening from its WMMA.
//   - BM = 128 (2 x 4 warps of 64 x 32), 3 stages for larger M; the block
//     widens together. Its ring takes 85 KB of shared memory, past the default
//     48 KB, so the launch opts in.
//   - Split-K over the byte rows, as in K8: each block writes a float32 partial
//     tile and int4_finalize sums and casts.
//   - Any even G that divides K. When the steps never cross a group (G/2 a
//     multiple of BR) and x's rows are whole 16-byte chunks, x arrives by
//     cp.async as two contiguous runs; otherwise each x element is gathered
//     into the same ring. Codes arrive by cp.async where N is a multiple of 16,
//     else element by element. Ragged M, N and K edges are masked. The TPU
//     dispatch's shape gate (N % 512 == 0) does not apply.
#include <mma.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BN = 128;
constexpr int kThreads = 256;  // 8 warps

union Pack8 {
  uint4 u;
  bf16 h[8];
};

union Bytes16 {
  uint4 u;
  unsigned char b[16];
};

template <int BM>
struct Tile {
  static constexpr int BR = 32;                  // packed byte rows a K step
  static constexpr int BK = 2 * BR;              // K rows a step: BR low + BR high nibbles
  static constexpr int LDA = BK + 8;             // shared row stride of A
  static constexpr int LDB = BN + 8;             // shared row stride of the widened B
  static constexpr int kWarpsM = BM == 16 ? 1 : 2;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int WM = BM / kWarpsM;
  static constexpr int WN = BN / kWarpsN;
  static constexpr int FM = WM / 16;
  static constexpr int FN = WN / 16;
  static constexpr int kAChunks = BM * BK / 8;  // 16-byte chunks of A a step
  static constexpr int kAPer = (kAChunks + kThreads - 1) / kThreads;
  static constexpr int kBChunks = BR * BN / 16;  // 16-byte chunks of packed codes a step
  static constexpr int kBPer = (kBChunks + kThreads - 1) / kThreads;
  static constexpr int LDW = BN + 16;  // packed row stride in the ring, bytes: 32 lanes
                                       // reading one row each hit distinct banks
};

template <int BM>
struct Ring {
  using T = Tile<BM>;
  static constexpr int kStages = BM == 16 ? 4 : 3;
  static constexpr int kA = BM * T::LDA * 2;     // a stage of x (bf16), bytes
  static constexpr int kStage = kA + T::BR * T::LDW;  // + a stage of packed codes
  static constexpr int kBytes = kStages * kStage + T::BK * T::LDB * 2;  // + widened codes
  static_assert(kStages * kStage >= (kThreads / 32) * 256 * 4, "scratch aliases the ring");
};

template <int BM, typename TOut>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const bf16* __restrict__ X, const unsigned char* __restrict__ W,
                   const float* __restrict__ scale, TOut* __restrict__ C,
                   float* __restrict__ partial, int M, int N, int K, int G, int p_split,
                   bool a_vec, bool b_vec, bool s_vec) {
  using T = Tile<BM>;
  using R = Ring<BM>;
  constexpr int BR = T::BR, BK = T::BK, LDA = T::LDA, kStages = R::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Bw = reinterpret_cast<bf16*>(smem + kStages * R::kStage);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int H = G / 2;  // byte rows a group
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int pb = blockIdx.z * p_split;
  const int pe = min(K / 2, pb + p_split);
  const int steps = pe > pb ? (pe - pb + BR - 1) / BR : 0;
  const int wm = warp / T::kWarpsN;
  const int wn = warp % T::kWarpsN;

  // Step `step`'s x columns and packed codes into its stage of the ring.
  auto issue = [&](int step) {
    unsigned char* st = smem + (step % kStages) * R::kStage;
    const int p0 = pb + step * BR;
    bf16* As = reinterpret_cast<bf16*>(st);
    if (a_vec) {  // the step lies in one group: two contiguous, aligned runs of x
      const int k_lo = (p0 / H) * G + p0 % H;
#pragma unroll
      for (int i = 0; i < T::kAPer; ++i) {
        const int c = tid + i * kThreads;
        if (c >= T::kAChunks) continue;
        const int row = c / (BK / 8), cc = (c % (BK / 8)) * 8;  // cc: column in the A tile
        const int m = m0 + row;
        const int k = k_lo + (cc >= BR ? H + cc - BR : cc);
        const bool ok = m < M && p0 < pe;
        cp_async16(As + row * LDA + cc, X + (ok ? static_cast<size_t>(m) * K + k : 0), ok);
      }
    } else {  // gather element by element
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int row = e / BK, col = e % BK;
        const int m = m0 + row;
        const int p = p0 + (col >= BR ? col - BR : col);
        bf16 val = __float2bfloat16(0.f);
        if (m < M && p < pe) {
          const int k = (p / H) * G + p % H + (col >= BR ? H : 0);
          val = X[static_cast<size_t>(m) * K + k];
        }
        As[row * LDA + col] = val;
      }
    }
    unsigned char* Bs = st + R::kA;
#pragma unroll
    for (int i = 0; i < T::kBPer; ++i) {
      const int c = tid + i * kThreads;
      if (c >= T::kBChunks) continue;
      const int r = c / (BN / 16), o = (c % (BN / 16)) * 16;
      const int p = p0 + r, col = n0 + o;
      const bool ok = p < pe && col < N;
      unsigned char* dst = Bs + r * T::LDW + o;
      const unsigned char* src = W + (ok ? static_cast<size_t>(p) * N + col : 0);
      if (b_vec || !ok) {
        cp_async16(dst, src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) dst[e] = col + e < N ? src[e] : 0;
      }
    }
    cp_async_commit();
  };

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
    const int p0 = pb + step * BR;
#pragma unroll
    for (int i = 0; i < T::kBPer; ++i) {  // widen, scale, round to bf16
      const int c = tid + i * kThreads;
      if (c >= T::kBChunks) continue;
      // decode: warp w widens the 16 columns its own WMMA reads, lane = byte row
      const int r = BM == 16 ? lane : c / (BN / 16);
      const int o = BM == 16 ? warp * 16 : (c % (BN / 16)) * 16;
      const int p = p0 + r, n = n0 + o;
      Bytes16 b;
      b.u = *reinterpret_cast<const uint4*>(st + R::kA + r * T::LDW + o);
      float s[16];
      const float* srow = scale + static_cast<size_t>(p / H) * N + n;
      if (p < pe && s_vec && n + 16 <= N) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(srow) + q);
          s[4 * q] = v.x, s[4 * q + 1] = v.y, s[4 * q + 2] = v.z, s[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) s[e] = p < pe && n + e < N ? __ldg(srow + e) : 0.f;
      }
      Pack8 lo[2], hi[2];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        lo[e / 8].h[e % 8] = __float2bfloat16(static_cast<float>((b.b[e] & 15) - 8) * s[e]);
        hi[e / 8].h[e % 8] = __float2bfloat16(static_cast<float>((b.b[e] >> 4) - 8) * s[e]);
      }
      bf16* dlo = Bw + r * T::LDB + o;
      bf16* dhi = Bw + (BR + r) * T::LDB + o;
      *reinterpret_cast<uint4*>(dlo) = lo[0].u;
      *reinterpret_cast<uint4*>(dlo + 8) = lo[1].u;
      *reinterpret_cast<uint4*>(dhi) = hi[0].u;
      *reinterpret_cast<uint4*>(dhi + 8) = hi[1].u;
    }
    if constexpr (BM == 16)
      __syncwarp();  // each warp reads only the columns it widened
    else
      __syncthreads();
    const bf16* As = reinterpret_cast<const bf16*>(st);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[T::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[T::FN];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * T::WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::load_matrix_sync(bfr[j], Bw + kk * T::LDB + wn * T::WN + j * 16, T::LDB);
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
            C[at] = from_f32<TOut>(v);
        }
      }
      __syncwarp();  // the scratch tile is rewritten next
    }
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

template <int BM, typename TOut>
cudaError_t launch(const bf16* X, const unsigned char* W, const float* scale, TOut* C,
                   float* partial, int M, int N, int K, int G, int splits, cudaStream_t s) {
  constexpr int BR = Tile<BM>::BR;
  const int steps = (K / 2 + BR - 1) / BR;
  const int p_split = ((steps + splits - 1) / splits) * BR;  // each split whole steps
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  const bool a_vec = (G / 2) % BR == 0 && K % 8 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const bool b_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  const bool s_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  // the opt-in belongs to the current device, so it is set at every launch
  cudaError_t e = cudaFuncSetAttribute(int4_matmul_kernel<BM, TOut>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Ring<BM>::kBytes);
  if (e != cudaSuccess) return e;
  int4_matmul_kernel<BM, TOut><<<grid, kThreads, Ring<BM>::kBytes, s>>>(
      X, W, scale, C, splits > 1 ? partial : nullptr, M, N, K, G, p_split, a_vec, b_vec, s_vec);
  if (splits > 1) {
    const long long total = static_cast<long long>(M) * N;
    const int blocks = static_cast<int>(std::min<long long>((total + 255) / 256, 4096));
    int4_finalize<TOut><<<blocks, 256, 0, s>>>(partial, C, M, N, splits);
  }
  return cudaGetLastError();
}

}  // namespace

// C [M, N] = x [M, K] . dequant(packed [K/2, N], scale [K/G, N]); x bfloat16,
// packed uint8, scale float32; C float32 (out_dtype 0) or bfloat16 (1). G is
// even and divides K. splits > 1 needs `partial`, a float32 workspace of
// splits * M * N; the splits must not outnumber the K steps of 32 byte rows.
// Any M, N >= 1.
extern "C" int int4_matmul_launch(const void* x, const void* packed, const void* scale,
                                  void* out, void* partial, int M, int N, int K, int G,
                                  int out_dtype, int splits, void* stream) {
  constexpr int br = Tile<16>::BR;
  if (M <= 0 || N <= 0 || K <= 0 || G < 2 || G % 2 != 0 || K % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || splits > (K / 2 + br - 1) / br || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* X = static_cast<const bf16*>(x);
  const unsigned char* W = static_cast<const unsigned char*>(packed);
  const float* S = static_cast<const float*>(scale);
  float* P = static_cast<float*>(partial);
#define INT4_CASE(BM)                                                                          \
  return static_cast<int>(out_dtype == 0                                                       \
                              ? launch<BM, float>(X, W, S, static_cast<float*>(out), P, M, N, \
                                                  K, G, splits, s)                             \
                              : launch<BM, bf16>(X, W, S, static_cast<bf16*>(out), P, M, N, K, \
                                                 G, splits, s));
  if (M <= 16) INT4_CASE(16)
  INT4_CASE(128)
#undef INT4_CASE
}
