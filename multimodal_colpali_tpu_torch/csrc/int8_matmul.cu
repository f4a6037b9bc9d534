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
// of the codes (half of bf16's; for gemma-3-27b about 27 GB per step). Prefill
// has M up to 2048 and is bound by the tensor cores.
//
// Design. One kernel template, two weight layouts. A block computes a BM x 128
// tile of C with 8 warps of 16 x 16 x 16 bf16 WMMA products and float32
// accumulators; K advances in steps of BK. x and the int8 codes of the next
// steps arrive through a cp.async ring in shared memory (4 stages at decode's
// 16 rows, three steps of codes = 24 KB in flight a block; 3 stages at 128
// rows), so loads overlap the tensor cores. Each step's codes are widened from
// the ring to bf16 (exact for |code| <= 127) into the tile WMMA reads: [n][k]
// (col-major B) for K8b, [k][n] (row-major B) for K8a.
//   - BM = 16 for M <= 16 (decode): one row tile, each warp owns 16 columns,
//     so no 128-row tile wastes the tensor cores 8x and, more to the point,
//     every block streams its weights once for all M rows; BK = 64.
//   - BM = 128 for larger M (prefill): 2 x 4 warps of 64 x 32, BK = 32.
//   - Split-K: at decode's M the N tiles alone give too few blocks to keep
//     enough bytes in flight (N = 5376 is 42 tiles on an H100's 132 SMs), so
//     the wrapper splits K into `splits` ranges; each block writes its float32
//     partial tile to a workspace and int8_finalize sums them, scales and casts.
//   - Ragged M, N and K edges are masked here (zero-filled copies, guarded
//     stores). Rows that are not whole 16-byte chunks (K not a multiple of 8
//     for x, of 16 for K8b's codes, N not a multiple of 16 for K8a's; no
//     gemma-3 or PaliGemma shape) are copied element by element into the same
//     ring. The TPU dispatch's shape gate (K, N multiples of 512, M <= 2048)
//     does not apply.
#include <mma.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

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
  if (splits > 1) {
    const long long total = static_cast<long long>(M) * N;
    const int blocks = static_cast<int>(std::min<long long>((total + 255) / 256, 4096));
    int8_finalize<TOut><<<blocks, 256, 0, s>>>(partial, scale, C, M, N, splits);
  }
  return cudaGetLastError();
}

}  // namespace

// C [M, N] = x [M, K] . B * scale [N], with B = codes [K, N] (layout 0, K8a)
// or codes [N, K]^T (layout 1, K8b). x bfloat16, codes int8, scale float32;
// C float32 (out_dtype 0) or bfloat16 (1). splits > 1 needs `partial`, a
// float32 workspace of splits * M * N; the splits must not outnumber the K
// steps (64 wide for M <= 16, else 32). Any M, N, K >= 1.
extern "C" int int8_matmul_launch(const void* x, const void* codes, const void* scale, void* out,
                                  void* partial, int M, int N, int K, int layout, int out_dtype,
                                  int splits, void* stream) {
  const int bk = M <= 16 ? Tile<true, 16>::BK : Tile<true, 128>::BK;
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
  const bool small = M <= 16;
#define INT8_CASE(NK, BM)                                                                   \
  return static_cast<int>(out_dtype == 0                                                    \
                              ? launch<NK, BM, float>(X, W, S, static_cast<float*>(out), P, \
                                                      M, N, K, splits, s)                   \
                              : launch<NK, BM, bf16>(X, W, S, static_cast<bf16*>(out), P,   \
                                                     M, N, K, splits, s));
  if (layout == 1) {
    if (small) INT8_CASE(true, 16)
    INT8_CASE(true, 128)
  }
  if (small) INT8_CASE(false, 16)
  INT8_CASE(false, 128)
#undef INT8_CASE
}
