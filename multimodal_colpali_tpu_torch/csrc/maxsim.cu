// K1 and K4: MaxSim late-interaction scores over a float or an int8 corpus.
//
// K1 replaces the TPU kernel multimodal_colpali_tpu/ops/maxsim.py::_maxsim_kernel
// (pl.pallas_call at maxsim.py:196, wrapper maxsim_scores_pallas):
//
//   out[b, p] = sum_{i < q_len[b]} max_{j < d_len[p]} <Q[b, i], D[p, j]>
//
// Q [B, NQ, DIM] and D [P, NT, DIM] are both float32 or both bfloat16; every
// product and sum is taken in float32. Invalid page tokens count as -1e30, so a
// page with d_len = 0 scores -(valid query tokens) * 1e30: finite, never NaN.
// Filtered store pages depend on that value.
//
// K4 replaces multimodal_colpali_tpu/ops/maxsim.py::_maxsim_int8_kernel
// (pl.pallas_call at maxsim.py:307, wrapper maxsim_scores_int8_pallas): the
// same sum over int8 codes C [P, NT, DIM] with a float32 scale S [P, NT] per
// page token,
//
//   out[b, p] = sum_i max_j  S[p, j] * <bf16(Q[b, i]), C[p, j]>
//
// The float32 query is rounded to bfloat16 here, as the TPU kernel does
// (maxsim.py:239); each code is exact in float32; the scale multiplies the dot
// before the mask and the max (maxsim.py:256), so it cannot leave the max.
//
// Design. On the TPU the grid ran in order and one program scored a block of
// pages against all queries. Here blocks run in parallel in no order, so each
// block owns one page outright and writes out[:, p] itself: no reduction
// crosses blocks. The block holds up to 128 query rows in registers (one row
// per pair of threads, DIM floats each) and streams the page's valid tokens
// through shared memory in tiles of 64, converted to float32 once on load (K4
// stages the tile's scales beside it). All threads of a warp read the same
// token, so the shared-memory reads are broadcasts. The two threads of a row
// scan the even and the odd tokens; their maxima are combined before the
// per-query sum, which runs in row order, so the result does not depend on
// scheduling or on which other pages share the launch: a page scores the same
// alone as in the whole corpus. More than 128 rows take several passes.
//
// What bounds it on an H100. A page byte is read from device memory once per
// 128 query rows, so at the retrieval shapes (B*NQ = 128, DIM = 128) the kernel
// does 64 multiply-adds per byte read for bf16 and 128 for int8: far past the
// memory roofline. This first version runs them on the float32 CUDA cores, so
// it is bound by their instruction throughput; int8 halves the bytes but not
// the work. Moving the dot products to the tensor cores (wgmma on TMA-fed page
// tiles) makes it bandwidth-bound; that is later work.
#include "common.cuh"

namespace {

constexpr float kMask = -1e30f;
constexpr int kRows = 128;           // query rows per pass
constexpr int kThreads = 2 * kRows;  // two threads per row
constexpr int kTile = 64;            // page tokens staged per step

// TQ: query element type; TD: corpus element type. kInt8: the corpus is int8
// codes with per-token scales and the query is rounded to bfloat16.
template <typename TQ, typename TD, int DIM, bool kInt8>
__global__ void __launch_bounds__(kThreads)
maxsim_kernel(const TQ* __restrict__ q, const TD* __restrict__ d,
              const float* __restrict__ d_scale, const int* __restrict__ q_lens,
              const int* __restrict__ d_lens, float* __restrict__ out, int B, int NQ, int P,
              int NT) {
  __shared__ __align__(16) float tile[kTile][DIM];
  __shared__ float tile_scale[kInt8 ? kTile : 1];
  __shared__ float rowmax[2][kRows];
  extern __shared__ float qsum[];  // [B] running per-query sums

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int half = tid / kRows;  // 0: even tokens, 1: odd tokens
  const int lr = tid % kRows;
  const int rows = B * NQ;
  const int dl = min(max(d_lens[p], 0), NT);
  const TD* page = d + static_cast<size_t>(p) * NT * DIM;

  for (int b = tid; b < B; b += kThreads) qsum[b] = 0.f;

  for (int r0 = 0; r0 < rows; r0 += kRows) {
    const int r = r0 + lr;
    float qr[DIM];
    if (r < rows) {
      const TQ* src = q + static_cast<size_t>(r) * DIM;
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        qr[c] = kInt8 ? round_bf16(to_f32(src[c])) : to_f32(src[c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < DIM; ++c) qr[c] = 0.f;
    }

    float best = kMask;
    for (int t0 = 0; t0 < dl; t0 += kTile) {
      const int n = min(kTile, dl - t0);
      __syncthreads();  // the previous tile has been read
      const TD* src = page + static_cast<size_t>(t0) * DIM;
      for (int i = tid; i < n * DIM; i += kThreads) tile[i / DIM][i % DIM] = to_f32(src[i]);
      if (kInt8) {
        const float* sc = d_scale + static_cast<size_t>(p) * NT + t0;
        for (int i = tid; i < n; i += kThreads) tile_scale[i] = sc[i];
      }
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
        float s = (a0 + a1) + (a2 + a3);
        if (kInt8) s *= tile_scale[j];
        best = fmaxf(best, s);
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

template <typename TQ, typename TD, bool kInt8, int DIM>
cudaError_t launch(const void* q, const void* d, const float* d_scale, const int* q_lens,
                   const int* d_lens, float* out, int B, int NQ, int P, int NT,
                   cudaStream_t stream) {
  const size_t dyn = static_cast<size_t>(B) * sizeof(float);
  maxsim_kernel<TQ, TD, DIM, kInt8><<<P, kThreads, dyn, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TD*>(d), d_scale, q_lens, d_lens, out, B,
      NQ, P, NT);
  return cudaGetLastError();
}

template <typename TQ, typename TD, bool kInt8>
cudaError_t launch_dim(const void* q, const void* d, const float* d_scale, const int* q_lens,
                       const int* d_lens, float* out, int B, int NQ, int P, int NT, int DIM,
                       cudaStream_t stream) {
  switch (DIM) {
#define MAXSIM_DIM_CASE(N) \
  case N:                  \
    return launch<TQ, TD, kInt8, N>(q, d, d_scale, q_lens, d_lens, out, B, NQ, P, NT, stream);
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

// K1: scores B queries against P pages into out [B, P] (float32, row-major).
// q [B, NQ, DIM] and d [P, NT, DIM] contiguous, of the type named by dtype;
// q_lens [B] and d_lens [P] int32. DIM is a multiple of 8 up to 128, and
// B * 4 bytes of per-query sums must fit in shared memory beside the tile.
extern "C" int maxsim_launch(const void* q, const void* d, const int* q_lens,
                             const int* d_lens, float* out, int B, int NQ, int P, int NT,
                             int DIM, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBFloat16) {
    err = launch_dim<__nv_bfloat16, __nv_bfloat16, false>(q, d, nullptr, q_lens, d_lens, out,
                                                           B, NQ, P, NT, DIM, s);
  } else if (dtype == kFloat32) {
    err = launch_dim<float, float, false>(q, d, nullptr, q_lens, d_lens, out, B, NQ, P, NT,
                                          DIM, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// K4: as maxsim_launch over int8 codes [P, NT, DIM] with float32 scales
// [P, NT]; q [B, NQ, DIM] is float32 and is rounded to bfloat16 in the kernel.
extern "C" int maxsim_int8_launch(const float* q, const signed char* codes,
                                  const float* scales, const int* q_lens, const int* d_lens,
                                  float* out, int B, int NQ, int P, int NT, int DIM,
                                  void* stream) {
  return static_cast<int>(launch_dim<float, signed char, true>(
      q, codes, scales, q_lens, d_lens, out, B, NQ, P, NT, DIM,
      static_cast<cudaStream_t>(stream)));
}
