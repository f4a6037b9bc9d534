// K2's backward: the gradient of masked multi-head attention, float32.
//
// Replaces no pl.pallas_call. The TPU kernel multimodal_colpali_tpu/ops/
// attention.py::_attn_kernel has no backward, and jax.grad through it raises
// (pallas_call has no reverse mode); the JAX trainer's gradient is autodiff of
// the einsum branch of models/layers.attention (layers.py:210-231), of which
// this is the counterpart (jax.vjp of it). Plain version:
// ops/attention.attention_backward_reference.
//
// For [B, S, H, D] q, k, v, the forward's o and the output gradient dO:
//
//   P = softmax_t(scale * <q_i, k_t> | masks)      (a masked logit is the finite -1e30)
//   dV_t = sum_i P_it dO_i
//   dS_it = P_it (<dO_i, v_t> - D_i),  D_i = <dO_i, o_i>,  0 on a masked pair
//   dQ_i = scale sum_t dS_it k_t,      dK_t = scale sum_i dS_it q_i
//
// A masked pair gets dS = 0, as jnp.where / masked_fill pass no gradient to the
// filled logit. A row whose keys are all masked has all logits -1e30 and
// uniform P = 1 / S: it still sends P dO to dV, and nothing to dQ or dK. So the
// row statistics are kept as the max m and the sum l of exp(logit - m), not as
// one log-sum-exp: in float32, -1e30 + log(S) rounds back to -1e30, which
// would give such a row P = 1 instead of 1 / S.
//
// Two launches, FlashAttention-2's split, no atomics (a repeat is
// bit-identical):
//   1. bwd_dq_kernel, over query blocks: a thread owns a query row. It takes
//      D_i, then m_i and l_i in one pass over the key tiles (the forward's
//      online softmax, in the forward's order), then dQ_i in a second pass,
//      recomputing the logits tile by tile. It writes m, l and D for launch 2.
//   2. bwd_dkdv_kernel, over key blocks: a thread owns a key row and walks
//      every query tile, recomputing P from q, k and the row statistics.
// Tiles of 32 rows are staged in shared memory as float32 and read by every
// thread of a warp at one address (16-byte broadcasts); a thread's own dO
// (launch 1) or k and v rows (launch 2) sit in shared memory at a stride of
// D + 4 words, so the 16-byte reads of 8 neighbouring threads fall in 8
// distinct bank groups (D / 4 + 1 is odd). D is rounded up to a multiple of 8
// with zero columns (72 stays 72).
//
// What bounds it on an H100. At the training path's [2, 1024, 16, 72] the
// gradient needs five S x S x D products (Q K^T again, dO V^T, P^T dO, dS K,
// dS^T Q): 10 B H S^2 D = 24.2 GFLOP against 75 MB of inputs and outputs, so
// it is bound by operations, 0.36 ms at the 67 TFLOP/s of float32 on the CUDA
// cores. This kernel does 16 B H S^2 D (the logits three times, the row
// statistics' pass once more) as scalar FMAs from shared memory; float32 on
// the tensor cores (TF32) would round the operands, which the JAX trainer's
// float32 gradient does not. wgmma tiles and TMA are later work.
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 64;  // query rows (launch 1) or key rows (launch 2) a block, a thread each
constexpr int kTile = 32;  // rows of a staged key (launch 1) or query (launch 2) tile

// four floats of shared memory at a 16-byte aligned p + 4c
__device__ __forceinline__ float4 ld4(const float* p, int c) {
  return reinterpret_cast<const float4*>(p)[c];
}

// <a, b> over DP columns as the forward's CUDA-core kernel sums it: four
// partial sums over columns 4c .. 4c + 3, then (a0 + a1) + (a2 + a3). `a` is a
// register array (dot4_reg) or a 16-byte aligned row of shared memory (dot4),
// `b` the latter.
template <int DP>
__device__ __forceinline__ float dot4_reg(const float (&a)[DP], const float* b) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int c = 0; c < DP / 4; ++c) {
    const float4 y = ld4(b, c);
    a0 = fmaf(a[4 * c + 0], y.x, a0);
    a1 = fmaf(a[4 * c + 1], y.y, a1);
    a2 = fmaf(a[4 * c + 2], y.z, a2);
    a3 = fmaf(a[4 * c + 3], y.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

template <int DP>
__device__ __forceinline__ float dot4(const float* a, const float* b) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int c = 0; c < DP / 4; ++c) {
    const float4 x = ld4(a, c), y = ld4(b, c);
    a0 = fmaf(x.x, y.x, a0);
    a1 = fmaf(x.y, y.y, a1);
    a2 = fmaf(x.z, y.z, a2);
    a3 = fmaf(x.w, y.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// acc += s * row, the row 16-byte aligned in shared memory
template <int DP>
__device__ __forceinline__ void axpy4(float (&acc)[DP], float s, const float* row) {
#pragma unroll
  for (int c = 0; c < DP / 4; ++c) {
    const float4 y = ld4(row, c);
    acc[4 * c + 0] = fmaf(s, y.x, acc[4 * c + 0]);
    acc[4 * c + 1] = fmaf(s, y.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(s, y.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(s, y.w, acc[4 * c + 3]);
  }
}

// rows [t0, t0 + n) of one (batch, head) into dst [kTile][DP], zero past D
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int t0,
                                           int n, int D, int DP, size_t row) {
  for (int idx = threadIdx.x; idx < n * DP; idx += blockDim.x) {
    const int r = idx / DP, c = idx % DP;
    dst[idx] = c < D ? src[static_cast<size_t>(t0 + r) * row + c] : 0.f;
  }
}

// this block's kRows rows from r0 into dst [kRows][DP + 4], zero past S and D
__device__ __forceinline__ void stage_own(float* dst, const float* __restrict__ src, int r0,
                                          int S, int D, int DP, size_t row) {
  for (int idx = threadIdx.x; idx < kRows * DP; idx += blockDim.x) {
    const int r = idx / DP, c = idx % DP;
    const int t = r0 + r;
    dst[r * (DP + 4) + c] = (t < S && c < D) ? src[static_cast<size_t>(t) * row + c] : 0.f;
  }
}

__device__ __forceinline__ bool key_open(const int* __restrict__ kv_valid, int b, int S,
                                         int kv_len, int t) {
  return t < kv_len && (kv_valid == nullptr || kv_valid[static_cast<size_t>(b) * S + t] != 0);
}

// Launch 1: dQ, and each row's max, sum and D into stats [3][B * H * S].
template <int DP>
__global__ void __launch_bounds__(kRows)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, float* __restrict__ dq,
              float* __restrict__ stats, const int* __restrict__ kv_lens,
              const int* __restrict__ kv_valid, int S, int H, int D, float scale,
              int causal) {
  constexpr int LD = DP + 4;
  extern __shared__ __align__(16) float smem[];
  float* dos = smem;                // [kRows][LD]: the block's dO rows
  float* ks = dos + kRows * LD;     // [kTile][DP]
  float* vs = ks + kTile * DP;      // [kTile][DP]
  int* key_ok = reinterpret_cast<int*>(vs + kTile * DP);  // [kTile]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int i = r0 + tid;
  const size_t row = static_cast<size_t>(H) * D;  // elements between tokens
  const size_t base = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * D;
  const int kv_len = kv_lens[b];

  stage_own(dos, dout + base, r0, S, D, DP, row);
  float qr[DP], acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qr[c] = (i < S && c < D) ? q[base + static_cast<size_t>(i) * row + c] : 0.f;
    acc[c] = 0.f;
  }
  __syncthreads();
  const float* my_do = dos + tid * LD;
  float delta = 0.f;  // D_i = <dO_i, o_i>
  if (i < S) {
#pragma unroll
    for (int c = 0; c < DP; ++c)
      if (c < D) delta = fmaf(my_do[c], o[base + static_cast<size_t>(i) * row + c], delta);
  }

  // pass 1: the row's max m and sum l of exp(logit - m), as the forward takes them
  float m = -FLT_MAX, l = 0.f;
  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int n = min(kTile, S - t0);
    __syncthreads();  // the previous tile has been read
    stage_tile(ks, k + base, t0, n, D, DP, row);
    for (int j = tid; j < n; j += kRows) key_ok[j] = key_open(kv_valid, b, S, kv_len, t0 + j);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float s = dot4_reg<DP>(qr, ks + j * DP) * scale;
      if (!key_ok[j] || (causal && t0 + j > i)) s = kNeg;
      if (s > m) {
        l *= expf(m - s);
        m = s;
      }
      l += expf(s - m);
    }
  }

  // pass 2: dS and dQ, the logits recomputed
  const float inv_l = 1.f / l;
  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int n = min(kTile, S - t0);
    __syncthreads();
    stage_tile(ks, k + base, t0, n, D, DP, row);
    stage_tile(vs, v + base, t0, n, D, DP, row);
    for (int j = tid; j < n; j += kRows) key_ok[j] = key_open(kv_valid, b, S, kv_len, t0 + j);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* kt = ks + j * DP;
      const bool ok = key_ok[j] && !(causal && t0 + j > i);
      const float s = ok ? dot4_reg<DP>(qr, kt) * scale : kNeg;
      const float p = expf(s - m) * inv_l;
      const float dp = dot4<DP>(my_do, vs + j * DP);
      const float ds = ok ? p * (dp - delta) : 0.f;
      axpy4<DP>(acc, ds, kt);
    }
  }

  if (i < S) {
    float* dst = dq + base + static_cast<size_t>(i) * row;
#pragma unroll
    for (int c = 0; c < DP; ++c)
      if (c < D) dst[c] = acc[c] * scale;
    const size_t n_rows = static_cast<size_t>(gridDim.y) * S;
    const size_t at = static_cast<size_t>(bh) * S + i;
    stats[at] = m;
    stats[n_rows + at] = l;
    stats[2 * n_rows + at] = delta;
  }
}

// Launch 2: dK and dV from the row statistics of launch 1.
template <int DP>
__global__ void __launch_bounds__(kRows)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                float* __restrict__ dk, float* __restrict__ dv,
                const float* __restrict__ stats, const int* __restrict__ kv_lens,
                const int* __restrict__ kv_valid, int S, int H, int D, float scale,
                int causal) {
  constexpr int LD = DP + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kTile][DP]
  float* gs = qs + kTile * DP;       // [kTile][DP]: dO
  float* kown = gs + kTile * DP;     // [kRows][LD]
  float* vown = kown + kRows * LD;   // [kRows][LD]
  float* rmax = vown + kRows * LD;   // [kTile]
  float* rinv = rmax + kTile;        // [kTile]: 1 / l
  float* rdelta = rinv + kTile;      // [kTile]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int j = r0 + tid;  // this thread's key
  const size_t row = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * D;
  const size_t n_rows = static_cast<size_t>(gridDim.y) * S;
  const float* st = stats + static_cast<size_t>(bh) * S;
  const bool live = j < S && key_open(kv_valid, b, S, kv_lens[b], j);

  stage_own(kown, k + base, r0, S, D, DP, row);
  stage_own(vown, v + base, r0, S, D, DP, row);
  const float* my_k = kown + tid * LD;
  const float* my_v = vown + tid * LD;
  float dka[DP], dva[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) dka[c] = dva[c] = 0.f;

  for (int i0 = 0; i0 < S; i0 += kTile) {
    const int n = min(kTile, S - i0);
    __syncthreads();  // the previous tile has been read (and, first, the own rows staged)
    stage_tile(qs, q + base, i0, n, D, DP, row);
    stage_tile(gs, dout + base, i0, n, D, DP, row);
    for (int r = tid; r < n; r += kRows) {
      rmax[r] = st[i0 + r];
      rinv[r] = 1.f / st[n_rows + i0 + r];
      rdelta[r] = st[2 * n_rows + i0 + r];
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float* qt = qs + r * DP;
      const float* gt = gs + r * DP;
      const bool ok = live && !(causal && j > i0 + r);
      const float s = ok ? dot4<DP>(qt, my_k) * scale : kNeg;
      const float p = expf(s - rmax[r]) * rinv[r];
      const float dp = dot4<DP>(gt, my_v);
      const float ds = ok ? p * (dp - rdelta[r]) : 0.f;
      axpy4<DP>(dva, p, gt);
      axpy4<DP>(dka, ds, qt);
    }
  }

  if (j < S) {
    float* dkr = dk + base + static_cast<size_t>(j) * row;
    float* dvr = dv + base + static_cast<size_t>(j) * row;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < D) {
        dkr[c] = dka[c] * scale;
        dvr[c] = dva[c];
      }
    }
  }
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* dout, float* dq, float* dk, float* dv, float* stats,
                   const int* kv_lens, const int* kv_valid, int B, int S, int H, int D,
                   float scale, int causal, cudaStream_t stream) {
  constexpr int LD = DP + 4;
  const size_t dq_bytes = (static_cast<size_t>(kRows) * LD + 2 * kTile * DP) * 4 + kTile * 4;
  const size_t kv_bytes = (2 * static_cast<size_t>(kTile) * DP + 2 * kRows * LD + 3 * kTile) * 4;
  // above 48 KB only after the opt-in, which belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(bwd_dq_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(dq_bytes));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dkdv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kv_bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  bwd_dq_kernel<DP><<<grid, kRows, dq_bytes, stream>>>(q, k, v, o, dout, dq, stats, kv_lens,
                                                       kv_valid, S, H, D, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv_kernel<DP><<<grid, kRows, kv_bytes, stream>>>(q, k, v, dout, dk, dv, stats, kv_lens,
                                                         kv_valid, S, H, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// The gradient of self-attention over contiguous float32 [B, S, H, D] q, k, v
// at the forward's output o and its gradient dout: dq, dk, dv of the same
// shape. stats is float32 scratch of 3 * B * H * S (each row's max, sum and
// D); kv_lens [B] int32; kv_valid [B, S] int32 or null; D from 1 to 128.
extern "C" int attention_backward_launch(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, void* dq, void* dk,
                                         void* dv, void* stats, const int* kv_lens,
                                         const int* kv_valid, int B, int S, int H, int D,
                                         float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D < 1 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fo = static_cast<const float*>(o);
  const auto* fg = static_cast<const float*>(dout);
  auto* gq = static_cast<float*>(dq);
  auto* gk = static_cast<float*>(dk);
  auto* gv = static_cast<float*>(dv);
  auto* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 7) / 8) {
#define BWD_DP_CASE(N)                                                                    \
  case N:                                                                                 \
    return static_cast<int>(launch<8 * N>(fq, fk, fv, fo, fg, gq, gk, gv, st, kv_lens,    \
                                          kv_valid, B, S, H, D, scale, causal, s));
    BWD_DP_CASE(1)
    BWD_DP_CASE(2)
    BWD_DP_CASE(3)
    BWD_DP_CASE(4)
    BWD_DP_CASE(5)
    BWD_DP_CASE(6)
    BWD_DP_CASE(7)
    BWD_DP_CASE(8)
    BWD_DP_CASE(9)
    BWD_DP_CASE(10)
    BWD_DP_CASE(11)
    BWD_DP_CASE(12)
    BWD_DP_CASE(13)
    BWD_DP_CASE(14)
    BWD_DP_CASE(15)
    BWD_DP_CASE(16)
#undef BWD_DP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
