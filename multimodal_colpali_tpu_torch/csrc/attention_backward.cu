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
//   1. bwd_dq_tf32, over blocks of 64 query rows, 16 a warp: D_i from the
//      block's dO rows; then one pass over the key tiles for each row's max m
//      and sum l (S = Q.K^T, the forward's online softmax); then a second pass
//      of three products a tile: S again, dP = dO.V^T, dQ += dS.K. It writes
//      m, 1 / l and D for launch 2.
//   2. bwd_dkdv_tf32, over blocks of 64 key rows, 16 a warp (the M dimension):
//      a pass over the query tiles of four products a tile: S^T = K.Q^T and
//      dP^T = V.dO^T, P^T and dS^T from them and the staged statistics, then
//      dV += P^T.dO and dK += dS^T.Q.
// Every product runs on the tensor cores in 3xTF32 (mma.cuh: mma.sync m16n8k8,
// each operand split as hi = tf32(x), lo = tf32(x - hi), a.b as ah.bh + ah.bl
// + al.bh), which keeps about 21 significand bits: the gradient stays within
// the float32 tolerance of the plain version that TF32 alone (10 bits) would
// not. Each depth step's three products start from zero and are added in
// float32: the tensor cores truncate what they accumulate, and with the sums
// kept in the accumulators a So400m layer's q- and k-projection gradients
// missed the card test's gate several times over (queries and keys carry a
// large common component that the softmax's gradient cancels); added step by
// step, the kernel is closer to float64 than the plain version (chip_smoke.py's
// training rows read both errors against float64). The block's own rows
// (launch 1: Q and dO; launch 2: K and V) stay in shared memory and are split
// at each read; staged tiles arrive by cp.async, double-buffered. Both
// layouts are mma.cuh's F32Tile, D rounded up to a multiple of 8 with zero
// columns (72 stays 72). A product's result accumulator holds columns (2t,
// 2t + 1) of a lane, and the A operand of the next product takes columns (t,
// t + 4): with the contracted index (keys in launch 1, queries in launch 2)
// read in the order (0, 2, 4, 6, 1, 3, 5, 7) within each step of 8, the
// accumulator is that A fragment as it stands.
//
// What bounds it on an H100. At the training path's [3, 1024, 16, 72] the
// gradient needs five S x S x D products (Q K^T again, dO V^T, P^T dO, dS K,
// dS^T Q): 10 B H S^2 D = 36.2 GFLOP against 113 MB of inputs and outputs, so
// it is bound by operations: 0.541 ms at the 67 TFLOP/s of float32 on the CUDA
// cores, 0.219 ms for three TF32 products each at 495 TFLOP/s. This design
// does 16 B H S^2 D (the logits three times and dP twice across the two
// launches), three tensor-core instructions a product, and beside each step's
// three its operand splits and four float32 adds on the ALUs. The depth loop
// over D runs a step at a time and launch 2 issues two accumulators at a
// time: fully unrolled, the loads ran ahead and ptxas spilled at D = 72.
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of both launches: the block's own rows [2][ROWS] (Q and dO, or
// K and V), staged tiles [2 buffers][2][TILE] (K and V, or Q and dO), F32Tile
// rows of LD floats; then [2][TILE] ints (launch 1: key flags) or [2][3][TILE]
// floats (launch 2: each query's m, 1 / l and D), and [ROWS] floats (launch 1:
// D of the own rows).
template <int N8>
struct BwdLayout {
  static constexpr int kWarps = 4;
  static constexpr int ROWS = 16 * kWarps;
  static constexpr int DP = 8 * N8;
  static constexpr int TILE = N8 <= 10 ? 32 : 16;  // two blocks an SM
  static constexpr int LD = F32Tile<DP>::LD;
  static constexpr size_t kBytes =
      (2 * static_cast<size_t>(ROWS) + 4 * TILE) * LD * 4 + 6 * TILE * 4 + ROWS * 4;
};

__device__ __forceinline__ bool key_open(const int* __restrict__ kv_valid, int b, int S,
                                         int kv_len, int t) {
  return t < kv_len && (kv_valid == nullptr || kv_valid[static_cast<size_t>(b) * S + t] != 0);
}

// Launch 1: dQ, and each row's max m (base-2 units of the scaled logits), 1 / l
// and D into stats [3][B * H * S].
template <int N8>
__global__ void __launch_bounds__(BwdLayout<N8>::kWarps * 32)
bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ o,
            const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ stats,
            const int* __restrict__ kv_lens, const int* __restrict__ kv_valid, int S, int H,
            int D, float scale, int causal, bool vec) {
  using L = BwdLayout<N8>;
  using T = F32Tile<L::DP>;
  constexpr int ROWS = L::ROWS, DP = L::DP, TILE = L::TILE, LD = L::LD, NT = TILE / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [ROWS] own rows
  float* Gs = Qs + ROWS * LD;                   // [ROWS] own dO rows
  float* Ks = Gs + ROWS * LD;                   // [2][TILE]
  float* Vs = Ks + 2 * TILE * LD;               // [2][TILE]
  int* flags = reinterpret_cast<int*>(Vs + 2 * TILE * LD);  // [2][TILE]
  float* deltas = reinterpret_cast<float*>(flags + 6 * TILE);  // [ROWS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * ROWS;
  const int r0 = q0 + warp * 16;  // the warp's first query row
  const int wr = warp * 16;       // and its first own row
  const size_t row = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * D;
  const int kv_len = min(kv_lens[b], S);
  const int tiles = (S + TILE - 1) / TILE;
  const float scale_log2 = scale * kLog2e;
  const float neg = kNeg * kLog2e;

  auto issue = [&](int tile, bool with_v) {
    const int t0 = tile * TILE, buf = tile & 1;
    stage_f32<DP>(Ks + buf * TILE * LD, k + base, t0, TILE, S, D, row, vec);
    if (with_v) stage_f32<DP>(Vs + buf * TILE * LD, v + base, t0, TILE, S, D, row, vec);
    for (int j = threadIdx.x; j < TILE; j += blockDim.x)
      flags[buf * TILE + j] = key_open(kv_valid, b, S, kv_len, t0 + j);
  };
  // the logits of one key tile into sc (base-2 units), masked keys -1e30
  // scaled, keys past S -inf; ok[n][e] whether the pair is attended
  auto logits = [&](float (&sc)[NT][4], bool (&ok)[NT][4], int tile) {
    const int t0 = tile * TILE, buf = tile & 1;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    tf32_product_over_columns<DP, NT>(sc, Qs, wr, Ks + buf * TILE * LD, g, t4);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t4 + (e & 1);
        const int t = t0 + j;
        const int i = r0 + g + 8 * (e >> 1);
        ok[n][e] = flags[buf * TILE + j] && !(causal && t > i);
        sc[n][e] = t >= S ? -INFINITY : (ok[n][e] ? sc[n][e] * scale_log2 : neg);
      }
  };

  stage_f32<DP>(Qs, q + base, q0, ROWS, S, D, row, vec);
  stage_f32<DP>(Gs, dout + base, q0, ROWS, S, D, row, vec);
  issue(0, false);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {  // D_i = <dO_i, o_i>
    const int i = q0 + r;
    float d = 0.f;
    if (i < S) {
      const float* orow = o + base + static_cast<size_t>(i) * row;
      for (int c = 0; c < D; ++c) d = fmaf(Gs[T::at(r, c)], orow[c], d);
    }
    deltas[r] = d;
  }

  // pass 1: each row's max m and sum l of 2^(logit - m), as the forward takes them
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) issue(tile + 1, false);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float sc[NT][4];
    bool ok[NT][4];
    logits(sc, ok, tile);
    float m0 = mx[0], m1 = mx[1];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      m0 = fmaxf(m0, fmaxf(sc[n][0], sc[n][1]));
      m1 = fmaxf(m1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x *= 2) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, x));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, x));
    }
    l[0] *= ex2(mx[0] - m0);
    l[1] *= ex2(mx[1] - m1);
    mx[0] = m0;
    mx[1] = m1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      l[0] += ex2(sc[n][0] - m0) + ex2(sc[n][1] - m0);
      l[1] += ex2(sc[n][2] - m1) + ex2(sc[n][3] - m1);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  float inv[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    inv[hh] = 1.f / l[hh];
    dlt[hh] = deltas[wr + g + 8 * hh];
  }

  // pass 2: dS and dQ, the logits recomputed
  float acc[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  issue(0, true);
  cp_async_commit();
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < tiles) issue(tile + 1, true);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float sc[NT][4], dp[NT][4];
    bool ok[NT][4];
    logits(sc, ok, tile);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
    tf32_product_over_columns<DP, NT>(dp, Gs, wr, Vs + buf * TILE * LD, g, t4);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const float p = ex2(sc[n][e] - mx[hh]) * inv[hh];
        sc[n][e] = ok[n][e] ? p * (dp[n][e] - dlt[hh]) : 0.f;  // dS
      }
    tf32_product_over_rows<DP, NT>(acc, sc, Ks + buf * TILE * LD, g, t4);
    __syncthreads();
  }
  cp_async_wait<0>();

  const size_t n_rows = static_cast<size_t>(gridDim.y) * S;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = r0 + g + 8 * hh;
    if (i >= S) continue;
    float* dst = dq + base + static_cast<size_t>(i) * row;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const int c = n * 8 + 2 * t4;
      if (c < D) dst[c] = acc[n][2 * hh] * scale;
      if (c + 1 < D) dst[c + 1] = acc[n][2 * hh + 1] * scale;
    }
    if (t4 == 0) {
      const size_t at = static_cast<size_t>(bh) * S + i;
      stats[at] = mx[hh];
      stats[n_rows + at] = inv[hh];
      stats[2 * n_rows + at] = dlt[hh];
    }
  }
}

// Launch 2: dK and dV from the row statistics of launch 1.
template <int N8>
__global__ void __launch_bounds__(BwdLayout<N8>::kWarps * 32)
bwd_dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              float* __restrict__ dk, float* __restrict__ dv, const float* __restrict__ stats,
              const int* __restrict__ kv_lens, const int* __restrict__ kv_valid, int S, int H,
              int D, float scale, int causal, bool vec) {
  using L = BwdLayout<N8>;
  constexpr int ROWS = L::ROWS, DP = L::DP, TILE = L::TILE, LD = L::LD, NT = TILE / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);  // [ROWS] own rows
  float* Vs = Ks + ROWS * LD;                   // [ROWS] own rows
  float* Qs = Vs + ROWS * LD;                   // [2][TILE]
  float* Gs = Qs + 2 * TILE * LD;               // [2][TILE]: dO
  float* st = Gs + 2 * TILE * LD;               // [2][3][TILE]: m, 1 / l, D

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * ROWS;
  const int wr = warp * 16;  // the warp's first own row
  const size_t row = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * D;
  const size_t n_rows = static_cast<size_t>(gridDim.y) * S;
  const float* stq = stats + static_cast<size_t>(bh) * S;
  const int kv_len = min(kv_lens[b], S);
  const int tiles = (S + TILE - 1) / TILE;
  const float scale_log2 = scale * kLog2e;
  const float neg = kNeg * kLog2e;
  // the lane's keys (accumulator rows g, g + 8): attended at all
  const int key[2] = {k0 + wr + g, k0 + wr + g + 8};
  const bool live[2] = {key_open(kv_valid, b, S, kv_len, key[0]),
                        key_open(kv_valid, b, S, kv_len, key[1])};

  auto issue = [&](int tile) {
    const int i0 = tile * TILE, buf = tile & 1;
    stage_f32<DP>(Qs + buf * TILE * LD, q + base, i0, TILE, S, D, row, vec);
    stage_f32<DP>(Gs + buf * TILE * LD, dout + base, i0, TILE, S, D, row, vec);
    // queries past S: m = 1 / l = D = 0, so P = 0
    for (int c = threadIdx.x; c < 3 * TILE; c += blockDim.x) {
      const int which = c / TILE, r = c % TILE;
      const bool ok = i0 + r < S;
      cp_async4(st + (buf * 3 + which) * TILE + r,
                stq + (ok ? which * n_rows + i0 + r : 0), ok);
    }
  };

  stage_f32<DP>(Ks, k + base, k0, ROWS, S, D, row, vec);
  stage_f32<DP>(Vs, v + base, k0, ROWS, S, D, row, vec);
  issue(0);
  cp_async_commit();

  float dka[N8][4], dva[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    const int i0 = tile * TILE, buf = tile & 1;
    if (tile + 1 < tiles) issue(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Qt = Qs + buf * TILE * LD;
    const float* Gt = Gs + buf * TILE * LD;
    const float* sm = st + buf * 3 * TILE;

    // S^T = K.Q^T and dP^T = V.dO^T: rows the lane's keys, columns queries
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
    tf32_product_over_columns<DP, NT>(sc, Ks, wr, Qt, g, t4);
    tf32_product_over_columns<DP, NT>(dp, Vs, wr, Gt, g, t4);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = n * 8 + 2 * t4 + (e & 1);
        const int i = i0 + r;
        const int hh = e >> 1;
        const bool ok = live[hh] && !(causal && key[hh] > i);
        const float x = ok ? sc[n][e] * scale_log2 : neg;
        const float p = ex2(x - sm[r]) * sm[TILE + r];
        sc[n][e] = p;                                         // P^T
        dp[n][e] = ok ? p * (dp[n][e] - sm[2 * TILE + r]) : 0.f;  // dS^T
      }
    tf32_product_over_rows<DP, NT>(dva, sc, Gt, g, t4);
    tf32_product_over_rows<DP, NT>(dka, dp, Qt, g, t4);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = key[hh];
    if (j >= S) continue;
    float* dkr = dk + base + static_cast<size_t>(j) * row;
    float* dvr = dv + base + static_cast<size_t>(j) * row;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const int c = n * 8 + 2 * t4;
      if (c < D) {
        dkr[c] = dka[n][2 * hh] * scale;
        dvr[c] = dva[n][2 * hh];
      }
      if (c + 1 < D) {
        dkr[c + 1] = dka[n][2 * hh + 1] * scale;
        dvr[c + 1] = dva[n][2 * hh + 1];
      }
    }
  }
}

template <int N8>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* dout, float* dq, float* dk, float* dv, float* stats,
                   const int* kv_lens, const int* kv_valid, int B, int S, int H, int D,
                   float scale, int causal, cudaStream_t stream) {
  using L = BwdLayout<N8>;
  // above 48 KB only after the opt-in, which belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(bwd_dq_tf32<N8>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::kBytes));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dkdv_tf32<N8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(L::kBytes));
  if (e != cudaSuccess) return e;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = D % 4 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(dout);
  const dim3 grid((S + L::ROWS - 1) / L::ROWS, B * H);
  bwd_dq_tf32<N8><<<grid, L::kWarps * 32, L::kBytes, stream>>>(
      q, k, v, o, dout, dq, stats, kv_lens, kv_valid, S, H, D, scale, causal, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv_tf32<N8><<<grid, L::kWarps * 32, L::kBytes, stream>>>(
      q, k, v, dout, dk, dv, stats, kv_lens, kv_valid, S, H, D, scale, causal, vec);
  return cudaGetLastError();
}

}  // namespace

// The gradient of self-attention over contiguous float32 [B, S, H, D] q, k, v
// at the forward's output o and its gradient dout: dq, dk, dv of the same
// shape. stats is float32 scratch of 3 * B * H * S (each row's max, 1 / sum
// and D); kv_lens [B] int32; kv_valid [B, S] int32 or null; D from 1 to 128.
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
#define BWD_N8_CASE(N)                                                                  \
  case N:                                                                               \
    return static_cast<int>(launch<N>(fq, fk, fv, fo, fg, gq, gk, gv, st, kv_lens,      \
                                      kv_valid, B, S, H, D, scale, causal, s));
    BWD_N8_CASE(1)
    BWD_N8_CASE(2)
    BWD_N8_CASE(3)
    BWD_N8_CASE(4)
    BWD_N8_CASE(5)
    BWD_N8_CASE(6)
    BWD_N8_CASE(7)
    BWD_N8_CASE(8)
    BWD_N8_CASE(9)
    BWD_N8_CASE(10)
    BWD_N8_CASE(11)
    BWD_N8_CASE(12)
    BWD_N8_CASE(13)
    BWD_N8_CASE(14)
    BWD_N8_CASE(15)
    BWD_N8_CASE(16)
#undef BWD_N8_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
