// K1: MaxSim late-interaction scores.
//
// Replaces the TPU kernel multimodal_colpali_tpu/ops/maxsim.py::_maxsim_kernel
// (pl.pallas_call at maxsim.py:196, wrapper maxsim_scores_pallas):
//
//   out[b, p] = sum_{i < q_len[b]} max_{j < d_len[p]} <Q[b, i], D[p, j]>
//
// Q [B, NQ, DIM] and D [P, NT, DIM] are both float32 or both bfloat16; every
// product and sum is taken in float32. Invalid page tokens count as -1e30, so a
// page with d_len = 0 scores -(valid query tokens) * 1e30: finite, never NaN.
// Filtered store pages depend on that value.
//
// Design. On the TPU the grid ran in order and one program scored a block of
// pages against all queries. Here blocks run in parallel in no order, so each
// block owns one page outright and writes out[:, p] itself: no reduction
// crosses blocks. The block holds up to 128 query rows in registers (one row
// per pair of threads, DIM floats each) and streams the page's valid tokens
// through shared memory in tiles of 64, converted to float32 once on load. All
// threads of a warp read the same token, so the shared-memory reads are
// broadcasts. The two threads of a row scan the even and the odd tokens; their
// maxima are combined before the per-query sum, which runs in row order, so
// the result does not depend on scheduling. More than 128 rows take several
// passes over the page.
//
// What bounds it on an H100. A page byte is read from device memory once per
// 128 query rows, so at the retrieval shapes (B*NQ = 128, DIM = 128, bf16) the
// kernel does 64 multiply-adds per byte read: far past the memory roofline.
// This first version runs them on the float32 CUDA cores, so it is bound by
// their instruction throughput. Moving the dot products to the tensor cores (wgmma on
// TMA-fed page tiles) makes it bandwidth-bound; that is later work.
#include "common.cuh"

namespace {

constexpr float kMask = -1e30f;
constexpr int kRows = 128;           // query rows per pass
constexpr int kThreads = 2 * kRows;  // two threads per row
constexpr int kTile = 64;            // page tokens staged per step

template <typename T, int DIM>
__global__ void __launch_bounds__(kThreads)
maxsim_kernel(const T* __restrict__ q, const T* __restrict__ d,
              const int* __restrict__ q_lens, const int* __restrict__ d_lens,
              float* __restrict__ out, int B, int NQ, int P, int NT) {
  __shared__ __align__(16) float tile[kTile][DIM];
  __shared__ float rowmax[2][kRows];
  extern __shared__ float qsum[];  // [B] running per-query sums

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int half = tid / kRows;  // 0: even tokens, 1: odd tokens
  const int lr = tid % kRows;
  const int rows = B * NQ;
  const int dl = min(max(d_lens[p], 0), NT);
  const T* page = d + static_cast<size_t>(p) * NT * DIM;

  for (int b = tid; b < B; b += kThreads) qsum[b] = 0.f;

  for (int r0 = 0; r0 < rows; r0 += kRows) {
    const int r = r0 + lr;
    float qr[DIM];
    if (r < rows) {
      const T* src = q + static_cast<size_t>(r) * DIM;
#pragma unroll
      for (int c = 0; c < DIM; ++c) qr[c] = to_f32(src[c]);
    } else {
#pragma unroll
      for (int c = 0; c < DIM; ++c) qr[c] = 0.f;
    }

    float best = kMask;
    for (int t0 = 0; t0 < dl; t0 += kTile) {
      const int n = min(kTile, dl - t0);
      __syncthreads();  // the previous tile has been read
      const T* src = page + static_cast<size_t>(t0) * DIM;
      for (int i = tid; i < n * DIM; i += kThreads) tile[i / DIM][i % DIM] = to_f32(src[i]);
      __syncthreads();
      for (int j = half; j < n; j += 2) {
        const float4* tok = reinterpret_cast<const float4*>(tile[j]);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int c = 0; c < DIM / 4; ++c) {
          const float4 v = tok[c];
          a0 = fmaf(qr[4 * c + 0], v.x, a0);
          a1 = fmaf(qr[4 * c + 1], v.y, a1);
          a2 = fmaf(qr[4 * c + 2], v.z, a2);
          a3 = fmaf(qr[4 * c + 3], v.w, a3);
        }
        best = fmaxf(best, (a0 + a1) + (a2 + a3));
      }
    }
    rowmax[half][lr] = best;
    __syncthreads();

    // Fold this pass's rows into their queries' sums, in row order.
    const int r_end = min(rows, r0 + kRows);
    const int b_first = r0 / NQ;
    const int b_last = (r_end - 1) / NQ;
    for (int b = b_first + tid; b <= b_last; b += kThreads) {
      const int q_valid = min(max(q_lens[b], 0), NQ);
      const int lo = max(b * NQ, r0);
      const int hi = min(b * NQ + q_valid, r_end);
      float s = qsum[b];
      for (int rr = lo; rr < hi; ++rr) s += fmaxf(rowmax[0][rr - r0], rowmax[1][rr - r0]);
      qsum[b] = s;
    }
    __syncthreads();  // rowmax is rewritten by the next pass
  }

  for (int b = tid; b < B; b += kThreads) out[static_cast<size_t>(b) * P + p] = qsum[b];
}

template <typename T, int DIM>
cudaError_t launch(const void* q, const void* d, const int* q_lens, const int* d_lens,
                   float* out, int B, int NQ, int P, int NT, cudaStream_t stream) {
  const size_t dyn = static_cast<size_t>(B) * sizeof(float);
  maxsim_kernel<T, DIM><<<P, kThreads, dyn, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(d), q_lens, d_lens, out, B, NQ, P, NT);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* d, const int* q_lens, const int* d_lens,
                       float* out, int B, int NQ, int P, int NT, int DIM, cudaStream_t stream) {
  switch (DIM) {
#define MAXSIM_DIM_CASE(N) \
  case N:                  \
    return launch<T, N>(q, d, q_lens, d_lens, out, B, NQ, P, NT, stream);
    MAXSIM_DIM_CASE(8)
    MAXSIM_DIM_CASE(16)
    MAXSIM_DIM_CASE(24)
    MAXSIM_DIM_CASE(32)
    MAXSIM_DIM_CASE(40)
    MAXSIM_DIM_CASE(48)
    MAXSIM_DIM_CASE(56)
    MAXSIM_DIM_CASE(64)
    MAXSIM_DIM_CASE(72)
    MAXSIM_DIM_CASE(80)
    MAXSIM_DIM_CASE(88)
    MAXSIM_DIM_CASE(96)
    MAXSIM_DIM_CASE(104)
    MAXSIM_DIM_CASE(112)
    MAXSIM_DIM_CASE(120)
    MAXSIM_DIM_CASE(128)
#undef MAXSIM_DIM_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Scores B queries against P pages into out [B, P] (float32, row-major).
// q [B, NQ, DIM] and d [P, NT, DIM] contiguous, of the type named by dtype;
// q_lens [B] and d_lens [P] int32. DIM is a multiple of 8 up to 128, and
// B * 4 bytes of per-query sums must fit in shared memory beside the tile.
extern "C" int maxsim_launch(const void* q, const void* d, const int* q_lens,
                             const int* d_lens, float* out, int B, int NQ, int P, int NT,
                             int DIM, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBFloat16) {
    err = launch_dim<__nv_bfloat16>(q, d, q_lens, d_lens, out, B, NQ, P, NT, DIM, s);
  } else if (dtype == kFloat32) {
    err = launch_dim<float>(q, d, q_lens, d_lens, out, B, NQ, P, NT, DIM, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
