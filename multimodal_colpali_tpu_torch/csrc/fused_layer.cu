// K5a-c building block: a bf16 tensor-core GEMM with a LayerNorm prologue and
// a bias / bias+gelu_tanh / bias+residual epilogue.
//
// Replaces, together with K2 (csrc/attention.cu), the three TPU kernels of
// multimodal_colpali_tpu/ops/fused_layer.py:
//   K5a _vit_layer_kernel  (pl.pallas_call at fused_layer.py:367, fused_vit_layer)
//   K5b _attn_block_kernel (fused_layer.py:247, fused_vit_attention_block)
//   K5c _mlp_block_kernel  (fused_layer.py:440, fused_mlp_block)
//
// The TPU kernel keeps a whole pre-LN SigLIP layer in VMEM. At ColSmol's shape
// that is the [1024, 768] residual, q/k/v, every head's [1024, 1024] logits and
// a [1024, 3072] float32 MLP hidden per batch item: many MB, against the 227 KB
// of shared memory an SM block can hold. So the layer is decomposed into
// launches of this GEMM and of K2 (ops/fused_layer.py puts them together):
//   (i)   LN1 -> QKV: LayerNorm prologue, bias epilogue, N = 3H, written as
//         three [M, H] planes so q, k and v reach K2 contiguous;
//   (ii)  K2 for the attention;
//   (iii) out_proj: bias + residual epilogue;
//   (iv)  LN2 -> fc1: LayerNorm prologue, bias + gelu_tanh epilogue;
//   (v)   fc2: bias + residual epilogue.
// K5a = (i)-(v); K5b = (i)+(ii) with (iii) for its out-projection; K5c = (iv)+(v).
//
//   C = epilogue(prologue(A) [M, K] . W^T [K, N] + bias)
//
// A, W (torch layout [N, K]), residual and C are bfloat16 (or all float32, for
// a model run in float32: gemm_f32_kernel below); LN parameters and biases are
// float32. Rounding points are the TPU kernel's
// (fused_layer.py:154-158, :285-322): LN in float32, cast to bf16; every dense
// accumulates in float32, adds the float32 bias, casts to bf16; gelu_tanh runs
// on the bf16-rounded fc1 output; residual adds are bf16 + bf16, rounded once.
//
// Design. One block computes a 128 x 128 tile of C with 8 warps (2 x 4), each
// warp a 64 x 32 tile of 16 x 16 x 16 bf16 WMMA products with float32
// accumulators. K advances in steps of 32: the next step's A and W chunks are
// loaded into registers while the tensor cores work on the current step out of
// shared memory, then stored (A through the LayerNorm when there is a
// prologue). The LayerNorm statistics of the block's 128 rows are computed once
// at the start (a warp per row, two passes in float32), so the normalized
// activation never goes to device memory. The epilogue goes through a 16 x 16
// float32 scratch per warp and writes 8 bf16 (16 bytes) per thread.
//
// What bounds it on an H100. At ColSmol's shapes (M = 16384 rows, K = 768 or
// 3072, N = 768 to 3072) each W tile is reused by 128 rows and each A tile by
// 128 columns: about 64 FLOP per byte from L2 and far more from device memory,
// so it is compute-bound. With one shared-memory stage, ldmatrix-free WMMA
// fragments and no asynchronous copies it reaches only part of the tensor
// cores' rate; wgmma with TMA-fed multi-stage rings is the next step.
#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kThreads = 256;           // 8 warps
constexpr int WM = 64, WN = 32;         // warp tile; warps are laid out 2 (M) x 4 (N)
constexpr int LDS = BK + 8;             // shared row stride in elements: 80 bytes
constexpr int kChunks = BM * BK / 8;    // 16-byte chunks per A (and W) tile: 512
constexpr int kPerThread = kChunks / kThreads;

enum Epilogue : int { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

__device__ __forceinline__ float gelu_tanh(float x) {
  // torch.nn.functional.gelu(approximate="tanh") and jax.nn.gelu(approximate=True)
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  return 0.5f * x * (1.f + tanhf(kBeta * (x + kKappa * x * x * x)));
}

union Pack8 {
  uint4 u;
  bf16 h[8];
};

template <bool kLN, int kEpi>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const bf16* __restrict__ A, const float* __restrict__ ln_g,
            const float* __restrict__ ln_b, float eps, const bf16* __restrict__ W0,
            const bf16* __restrict__ W1, const bf16* __restrict__ W2,
            const float* __restrict__ b0, const float* __restrict__ b1,
            const float* __restrict__ b2, const bf16* __restrict__ resid,
            bf16* __restrict__ C, int M, int N, int K, int Nseg) {
  __shared__ __align__(128) bf16 As[BM][LDS];
  __shared__ __align__(128) bf16 Ws[BN][LDS];
  __shared__ __align__(128) float scratch[kThreads / 32][16 * 16];
  __shared__ float row_mean[kLN ? BM : 1];
  __shared__ float row_rstd[kLN ? BM : 1];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = warp / 4;  // 0..1
  const int wn = warp % 4;  // 0..3

  if constexpr (kLN) {
    // LayerNorm statistics of this block's rows: mean, then the mean squared
    // deviation (jnp.var), in float32; a warp per row.
    for (int r = warp; r < BM; r += kThreads / 32) {
      const int m = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (m < M) {
        const bf16* row = A + static_cast<size_t>(m) * K;
        float s = 0.f;
        for (int k = lane * 8; k < K; k += 32 * 8) {
          Pack8 v;
          v.u = *reinterpret_cast<const uint4*>(row + k);
#pragma unroll
          for (int e = 0; e < 8; ++e) s += __bfloat162float(v.h[e]);
        }
#pragma unroll
        for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
        mean = s / K;
        float ss = 0.f;
        for (int k = lane * 8; k < K; k += 32 * 8) {
          Pack8 v;
          v.u = *reinterpret_cast<const uint4*>(row + k);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float dv = __bfloat162float(v.h[e]) - mean;
            ss = fmaf(dv, dv, ss);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, o);
        rstd = 1.f / sqrtf(ss / K + eps);
      }
      if (lane == 0) {
        row_mean[r] = mean;
        row_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  uint4 a_reg[kPerThread], w_reg[kPerThread];

  // Global -> registers for the K step starting at k0; zeros past the edges.
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (BK / 8);
      const int k = k0 + (c % (BK / 8)) * 8;
      const int m = m0 + r;
      const int n = n0 + r;
      a_reg[i] = make_uint4(0, 0, 0, 0);
      w_reg[i] = make_uint4(0, 0, 0, 0);
      if (m < M && k < K) a_reg[i] = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(m) * K + k);
      if (n < N && k < K) {
        const int seg = n / Nseg;
        const bf16* w = seg == 0 ? W0 : (seg == 1 ? W1 : W2);
        w_reg[i] = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(n - seg * Nseg) * K + k);
      }
    }
  };
  // Registers -> shared memory, A through the LayerNorm when there is one.
  auto store = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (BK / 8);
      const int kc = (c % (BK / 8)) * 8;
      Pack8 a;
      a.u = a_reg[i];
      if constexpr (kLN) {
        const int k = k0 + kc;
        if (m0 + r < M && k < K) {
          const float mean = row_mean[r], rstd = row_rstd[r];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float xn = (__bfloat162float(a.h[e]) - mean) * rstd * ln_g[k + e] + ln_b[k + e];
            a.h[e] = __float2bfloat16(xn);
          }
        }
      }
      *reinterpret_cast<uint4*>(&As[r][kc]) = a.u;
      *reinterpret_cast<uint4*>(&Ws[r][kc]) = w_reg[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  store(0);
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);  // in flight while the tensor cores run
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[WM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[WN / 16];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
        wmma::load_matrix_sync(af[i], &As[wm * WM + i * 16][kk], LDS);
#pragma unroll
      for (int j = 0; j < WN / 16; ++j)
        wmma::load_matrix_sync(bfr[j], &Ws[wn * WN + j * 16][kk], LDS);
#pragma unroll
      for (int i = 0; i < WM / 16; ++i)
#pragma unroll
        for (int j = 0; j < WN / 16; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();  // every warp is done with this step's tiles
    if (more) {
      store(k0 + BK);
      __syncthreads();
    }
  }

  // Epilogue: each lane finishes 8 consecutive columns of one row of a 16 x 16 tile.
  float* sc = scratch[warp];
  const int rr = lane / 2;
  const int cc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < WM / 16; ++i) {
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * WM + i * 16 + rr;
      const int n = n0 + wn * WN + j * 16 + cc;
      if (m < M && n < N) {  // N and Nseg are multiples of 8: the 8 columns are in range
        const int seg = n / Nseg;
        const int nl = n - seg * Nseg;
        const float* bias = seg == 0 ? b0 : (seg == 1 ? b1 : b2);
        const size_t at = static_cast<size_t>(seg) * M * Nseg + static_cast<size_t>(m) * Nseg + nl;
        Pack8 res;
        if constexpr (kEpi == kBiasResidual) res.u = *reinterpret_cast<const uint4*>(resid + at);
        Pack8 o;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float v = __bfloat162float(__float2bfloat16(sc[rr * 16 + cc + e] + bias[nl + e]));
          if constexpr (kEpi == kBiasGelu) v = gelu_tanh(v);
          if constexpr (kEpi == kBiasResidual) v += __bfloat162float(res.h[e]);
          o.h[e] = __float2bfloat16(v);
        }
        *reinterpret_cast<uint4*>(C + at) = o.u;
      }
      __syncwarp();  // the scratch tile is rewritten next
    }
  }
}

// The same GEMM for a model run in float32. No tensor-core type keeps
// float32's 24-bit mantissa, so this one runs on the CUDA cores: a block
// computes a 64 x 64 tile of C with 256 threads, 4 x 4 outputs each, and K
// advances in steps of 16 through shared memory. Nothing is rounded to a
// narrower type: LN, dense, bias, gelu_tanh and residual stay in float32, as
// the plain version keeps them for a float32 activation.
constexpr int FM = 64, FN = 64, FK = 16;
constexpr int FLD = FM + 4;  // k-major shared rows, 16-byte aligned

template <bool kLN, int kEpi>
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ ln_g,
                const float* __restrict__ ln_b, float eps, const float* __restrict__ W0,
                const float* __restrict__ W1, const float* __restrict__ W2,
                const float* __restrict__ b0, const float* __restrict__ b1,
                const float* __restrict__ b2, const float* __restrict__ resid,
                float* __restrict__ C, int M, int N, int K, int Nseg) {
  __shared__ __align__(16) float As[FK][FLD];
  __shared__ __align__(16) float Ws[FK][FLD];
  __shared__ float row_mean[kLN ? FM : 1];
  __shared__ float row_rstd[kLN ? FM : 1];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.y * FM;
  const int n0 = blockIdx.x * FN;
  const int ty = tid / 16;  // output rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // output columns tx*4 .. tx*4+3

  if constexpr (kLN) {
    for (int r = warp; r < FM; r += kThreads / 32) {
      const int m = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (m < M) {
        const float* row = A + static_cast<size_t>(m) * K;
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += row[k];
#pragma unroll
        for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
        mean = s / K;
        float ss = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float dv = row[k] - mean;
          ss = fmaf(dv, dv, ss);
        }
#pragma unroll
        for (int o = 16; o > 0; o /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, o);
        rstd = 1.f / sqrtf(ss / K + eps);
      }
      if (lane == 0) {
        row_mean[r] = mean;
        row_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  float acc[4][4] = {};
  const int lr = tid / (FK / 4);       // the tile row this thread loads: 0..63
  const int lk = (tid % (FK / 4)) * 4;  // and its 4 consecutive k
  for (int k0 = 0; k0 < K; k0 += FK) {
    const int k = k0 + lk;  // K is a multiple of 8: k < K covers k .. k+3
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), w = a;
    if (m0 + lr < M && k < K) {
      a = *reinterpret_cast<const float4*>(A + static_cast<size_t>(m0 + lr) * K + k);
      if constexpr (kLN) {
        const float mean = row_mean[lr], rstd = row_rstd[lr];
        a.x = (a.x - mean) * rstd * ln_g[k] + ln_b[k];
        a.y = (a.y - mean) * rstd * ln_g[k + 1] + ln_b[k + 1];
        a.z = (a.z - mean) * rstd * ln_g[k + 2] + ln_b[k + 2];
        a.w = (a.w - mean) * rstd * ln_g[k + 3] + ln_b[k + 3];
      }
    }
    const int n = n0 + lr;
    if (n < N && k < K) {
      const int seg = n / Nseg;
      const float* wr = seg == 0 ? W0 : (seg == 1 ? W1 : W2);
      w = *reinterpret_cast<const float4*>(wr + static_cast<size_t>(n - seg * Nseg) * K + k);
    }
    As[lk][lr] = a.x;
    As[lk + 1][lr] = a.y;
    As[lk + 2][lr] = a.z;
    As[lk + 3][lr] = a.w;
    Ws[lk][lr] = w.x;
    Ws[lk + 1][lr] = w.y;
    Ws[lk + 2][lr] = w.z;
    Ws[lk + 3][lr] = w.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int n = n0 + tx * 4;
  if (n >= N) return;
  // N and Nseg are multiples of 8: the 4 columns are in range and in one segment
  const int seg = n / Nseg;
  const int nl = n - seg * Nseg;
  const float* bias = seg == 0 ? b0 : (seg == 1 ? b1 : b2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) break;
    const size_t at = static_cast<size_t>(seg) * M * Nseg + static_cast<size_t>(m) * Nseg + nl;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[i][j] + bias[nl + j];
      if constexpr (kEpi == kBiasGelu) v[j] = gelu_tanh(v[j]);
      if constexpr (kEpi == kBiasResidual) v[j] += resid[at + j];
    }
    *reinterpret_cast<float4*>(C + at) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kLN, int kEpi>
cudaError_t launch(const void* A, const float* ln_g, const float* ln_b, float eps,
                   const void* w0, const void* w1, const void* w2, const float* b0,
                   const float* b1, const float* b2, const void* resid, void* C, int M, int N,
                   int K, int Nseg, bool f32, cudaStream_t stream) {
  if (f32) {
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    gemm_f32_kernel<kLN, kEpi><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(A), ln_g, ln_b, eps, static_cast<const float*>(w0),
        static_cast<const float*>(w1), static_cast<const float*>(w2), b0, b1, b2,
        static_cast<const float*>(resid), static_cast<float*>(C), M, N, K, Nseg);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_kernel<kLN, kEpi><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(A), ln_g, ln_b, eps, static_cast<const bf16*>(w0),
        static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), b0, b1, b2,
        static_cast<const bf16*>(resid), static_cast<bf16*>(C), M, N, K, Nseg);
  }
  return cudaGetLastError();
}

}  // namespace

// C = epilogue(LN?(A) . W^T + bias) for A [M, K] and C in float32 (dtype 0)
// or bfloat16 (dtype 1), the codes of attention_launch.
//
// The N output columns come in N / Nseg segments of Nseg columns (at most 3);
// segment s reads its weight rows from w_s [Nseg, K] and its bias from b_s
// [Nseg], and is written as the plane C[s] of C [N / Nseg, M, Nseg]. ln_g and
// ln_b ([K] float32) select the LayerNorm prologue when not null. epilogue:
// 0 bias, 1 bias + gelu_tanh, 2 bias + residual (resid [M, N], one segment).
// K, N and Nseg are multiples of 8 and every pointer is 16-byte aligned.
extern "C" int gemm_launch(const void* A, const float* ln_g, const float* ln_b, float eps,
                           const void* w0, const void* w1, const void* w2, const float* b0,
                           const float* b1, const float* b2, const void* resid, void* C, int M,
                           int N, int K, int Nseg, int epilogue, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || Nseg <= 0 || N % Nseg || N / Nseg > 3 || K % 8 || Nseg % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == 0;
  if (epilogue == kBiasResidual && (N != Nseg || resid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ln = ln_g != nullptr && ln_b != nullptr;
  cudaError_t err;
#define GEMM_CASE(LN, EPI)                                                                   \
  if (ln == LN && epilogue == EPI)                                                           \
    err = launch<LN, EPI>(A, ln_g, ln_b, eps, w0, w1, w2, b0, b1, b2, resid, C, M, N, K, Nseg, \
                          f32, s);                                                           \
  else
  GEMM_CASE(true, kBias)
  GEMM_CASE(true, kBiasGelu)
  GEMM_CASE(false, kBias)
  GEMM_CASE(false, kBiasGelu)
  GEMM_CASE(false, kBiasResidual)
  err = cudaErrorInvalidValue;
#undef GEMM_CASE
  return static_cast<int>(err);
}
