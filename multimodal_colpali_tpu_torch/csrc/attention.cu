// K2: multi-head attention with an exact float32 softmax.
//
// Replaces the TPU kernel multimodal_colpali_tpu/ops/attention.py::_attn_kernel
// (pl.pallas_call at attention.py:135, wrapper fused_attention):
//
//   out[b, i, h] = sum_t softmax_t(scale * <q[b,i,h], k[b,t,h]> | masks) v[b,t,h]
//
// on [B, S, H, D] tensors (float32 or bfloat16, K/V heads already repeated for
// GQA). A key is masked when t >= kv_lens[b], when kv_valid[b, t] == 0, or, if
// causal, when t > i; its logit becomes the finite -1e30, never -inf, so a row
// whose keys are all masked gets uniform weights over all S keys, as in both
// JAX paths. Logits, softmax and the P.V sums are float32.
//
// Design. The TPU kernel kept a whole [BQ, S] logit block in VMEM and took the
// softmax in one pass. A [1024, 1024] float32 block does not fit in an SM's
// shared memory, so this kernel uses a flash-style online softmax: a running
// maximum, a running denominator and a rescaled float32 accumulator per query
// row. One block serves 128 query rows of one (batch, head); each thread owns
// one row and keeps q and its accumulator in registers. K and V tiles are
// staged in shared memory as float32, converted once on load, and every thread
// of a warp reads the same key, so those reads are broadcasts. The head
// dimension is handled as DP, D rounded up to a multiple of 8: the columns past
// D are zero-filled on load and never written, which is how SigLIP-So400m's
// head_dim of 72 runs. The probabilities stay float32 (the TPU kernel rounded
// them to the value type before P.V; the difference is below bf16 resolution).
//
// What bounds it on an H100. At the SigLIP shapes ([8, 1024, 16, 72] bf16) each
// K/V byte is reused by 128 query rows per block, so the kernel is bound by
// float32 CUDA-core throughput (2 * D multiply-adds per query-key pair), not by
// memory. Tensor-core QK^T and PV (wgmma or mma.sync on bf16 tiles) are the
// next step for speed.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBQ = 128;  // query rows (threads) per block

template <typename T, int DP>
__global__ void __launch_bounds__(kBQ)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, const int* __restrict__ kv_lens,
                 const int* __restrict__ kv_valid, int S, int H, int D, float scale,
                 int causal) {
  constexpr int BK = DP <= 64 ? 64 : 32;  // keys per tile: the two float32 tiles fit 48 KB
  __shared__ __align__(16) float ks[BK][DP];
  __shared__ __align__(16) float vs[BK][DP];
  __shared__ int key_ok[BK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kBQ + tid;
  const size_t row = static_cast<size_t>(H) * D;  // elements between tokens
  const size_t base = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * D;
  const int kv_len = kv_lens[b];

  float qr[DP];
  float acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qr[c] = (i < S && c < D) ? to_f32(q[base + i * row + c]) : 0.f;
    acc[c] = 0.f;
  }
  float m = -FLT_MAX;  // running max of the logits seen so far
  float l = 0.f;       // running softmax denominator

  for (int t0 = 0; t0 < S; t0 += BK) {
    const int n = min(BK, S - t0);
    __syncthreads();  // the previous tiles have been read
    for (int idx = tid; idx < n * DP; idx += kBQ) {
      const int j = idx / DP;
      const int c = idx % DP;
      const size_t at = base + static_cast<size_t>(t0 + j) * row + c;
      ks[j][c] = c < D ? to_f32(k[at]) : 0.f;
      vs[j][c] = c < D ? to_f32(v[at]) : 0.f;
    }
    for (int j = tid; j < n; j += kBQ) {
      const int t = t0 + j;
      key_ok[j] = t < kv_len && (kv_valid == nullptr ||
                                 kv_valid[static_cast<size_t>(b) * S + t] != 0);
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float4* kt = reinterpret_cast<const float4*>(ks[j]);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int c = 0; c < DP / 4; ++c) {
        const float4 kk = kt[c];
        a0 = fmaf(qr[4 * c + 0], kk.x, a0);
        a1 = fmaf(qr[4 * c + 1], kk.y, a1);
        a2 = fmaf(qr[4 * c + 2], kk.z, a2);
        a3 = fmaf(qr[4 * c + 3], kk.w, a3);
      }
      float s = ((a0 + a1) + (a2 + a3)) * scale;
      if (!key_ok[j] || (causal && t0 + j > i)) s = kNeg;
      if (s > m) {
        const float alpha = expf(m - s);
        l *= alpha;
#pragma unroll
        for (int c = 0; c < DP; ++c) acc[c] *= alpha;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
      const float4* vt = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
      for (int c = 0; c < DP / 4; ++c) {
        const float4 vv = vt[c];
        acc[4 * c + 0] = fmaf(p, vv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
  }

  if (i < S) {
    const float inv = 1.f / l;
    T* dst = o + base + static_cast<size_t>(i) * row;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < D) dst[c] = from_f32<T>(acc[c] * inv);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* kv_lens,
                   const int* kv_valid, int B, int S, int H, int D, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  attention_kernel<T, DP><<<grid, kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), kv_lens, kv_valid, S, H, D, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* o, const int* kv_lens,
                      const int* kv_valid, int B, int S, int H, int D, float scale, int causal,
                      cudaStream_t stream) {
  switch ((D + 7) / 8) {
#define ATTN_DP_CASE(N)                                                                 \
  case N:                                                                               \
    return launch<T, 8 * N>(q, k, v, o, kv_lens, kv_valid, B, S, H, D, scale, causal, \
                            stream);
    ATTN_DP_CASE(1)
    ATTN_DP_CASE(2)
    ATTN_DP_CASE(3)
    ATTN_DP_CASE(4)
    ATTN_DP_CASE(5)
    ATTN_DP_CASE(6)
    ATTN_DP_CASE(7)
    ATTN_DP_CASE(8)
    ATTN_DP_CASE(9)
    ATTN_DP_CASE(10)
    ATTN_DP_CASE(11)
    ATTN_DP_CASE(12)
    ATTN_DP_CASE(13)
    ATTN_DP_CASE(14)
    ATTN_DP_CASE(15)
    ATTN_DP_CASE(16)
#undef ATTN_DP_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Self-attention over contiguous [B, S, H, D] q, k, v into o (same shape and
// type). kv_lens [B] int32; kv_valid [B, S] int32 or null; D from 1 to 128.
extern "C" int attention_launch(const void* q, const void* k, const void* v, void* o,
                                const int* kv_lens, const int* kv_valid, int B, int S, int H,
                                int D, float scale, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBFloat16) {
    err = launch_dp<__nv_bfloat16>(q, k, v, o, kv_lens, kv_valid, B, S, H, D, scale, causal, s);
  } else if (dtype == kFloat32) {
    err = launch_dp<float>(q, k, v, o, kv_lens, kv_valid, B, S, H, D, scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
