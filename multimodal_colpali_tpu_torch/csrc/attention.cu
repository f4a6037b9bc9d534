// K2: multi-head attention with a float32 softmax.
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
// JAX paths. No key tile is skipped for being masked. The TPU kernel took the
// softmax of a whole [BQ, S] float32 logit block in VMEM: unnormalised
// p = exp(logits - max), p rounded to v's type, P.V summed in float32 and
// divided by the float32 denominator at the end (attention.py:64-72). A
// [1024, 1024] float32 block does not fit in an SM's shared memory, so both
// paths here take a flash-style online softmax over key tiles: a running
// maximum, a running denominator and a rescaled float32 accumulator per row.
//
// What bounds it on an H100. At the SigLIP shapes ([8, 1024, 16, 72] bf16:
// ColPali's So400m tower; ColSmol's [16, 1024, 12, 64] inside K5a/K5b) every
// K/V byte serves a whole tile of query rows, so the work is 4 * B * H * S^2 * D
// operations against 8 bytes an element of q, k, v and o: ~0.04 ms of bf16
// tensor-core time, ~0.02 ms of memory. It is bound by operations. In float32
// at the training path's [3, 1024, 16, 72]: 14.5 GFLOP, 0.216 ms at the 67
// TFLOP/s of float32 on the CUDA cores, 0.088 ms as three TF32 products at
// 495 TFLOP/s.
//
// Three paths, chosen by the wrapper (ops/attention.kernel_path) from dtype, D
// and the scale's sign:
//   - Tensor cores (bf16, D % 8 == 0, D <= 128). A block of 4 warps serves
//     64 or 128 query rows of one (batch, head): one 16-row tile a warp, or
//     two (D <= 80, the SigLIP shapes), which then share every K and V
//     fragment read from shared memory. Q is loaded once into mma.sync
//     m16n8k16 A fragments by ldmatrix. Key tiles of 64 keys, K and V, are
//     double-buffered in shared memory by cp.async (16-byte chunks: the
//     [B, S, H, D] row stride is whole chunks when D % 8 == 0); D is
//     zero-padded to a multiple of 16 for the Q.K^T depth (72 -> 80), while
//     P.V produces exactly D columns (an 8-wide last tile for D = 72).
//     S = Q.K^T stays in float32 accumulator fragments; each row's online
//     softmax runs in registers, its max and sum reduced over the 4 lanes of
//     a quad (as K6 in window_attention.cu), with exp2 of (x - max) * scale *
//     log2(e) so that a row's equal -1e30 fills give exactly 1. The
//     unnormalised probabilities are rounded to bf16 and packed straight into
//     the A fragments of P.V (the TPU kernel's rounding point); V comes by
//     ldmatrix.trans; O accumulates in float32 and is divided by the running
//     float32 denominator at the end. Keys past S (the ragged last tile)
//     weigh exactly 0. What holds it above its bound: mma.sync issues from
//     one warp at a time, the softmax's exp2, max and rescale run between the
//     two products of every tile with no warp specialisation to hide them,
//     and ldmatrix feeds every product from shared memory (wgmma on 64-row
//     warpgroup tiles with TMA-fed K/V is the next step).
//   - Tensor cores in 3xTF32 (float32, every D from 1 to 128, any scale).
//     float32 must stay within 1e-4 of the plain version, which TF32 alone
//     (10 significand bits) misses by 5-10x; so each operand is split into
//     two TF32 values and each product taken as three (mma.cuh). A block of
//     4 warps serves 64 query rows, 16 a warp; K and V tiles of 64 keys (32
//     past D = 80) are double-buffered in shared memory by cp.async (16-byte
//     chunks when D % 4 == 0 and the pointers allow, else 4-byte ones, in
//     the same kernel) as mma.cuh's F32Tile, D zero-padded to a multiple of
//     8. Q stays in shared memory and each depth step's fragment is read and
//     split there, which leaves the registers to the float32 sums (no spill
//     at any D). S = Q.K^T is scaled to base-2 logits in registers; the
//     online softmax is the bf16 path's, in float32, and P stays float32 (the
//     TPU's rounding point for float32): its unnormalised values go from the
//     accumulators straight into the A fragments of P.V, whose depth takes
//     each 8 keys in the order (0, 2, 4, 6, 1, 3, 5, 7), with V's rows read
//     in that order. Every depth step's products start from zero and are
//     added in float32 (mma.cuh's mma_3xtf32): the tensor cores truncate
//     what they accumulate, and a sum kept in the accumulator loses the low
//     bits of every product (chip_smoke.py's training rows read this
//     kernel's error against float64 beside the plain version's). What
//     holds it above its bound: three tensor-core instructions a product,
//     the splits and the adds on the ALUs beside them, and mma.sync's
//     m16n8k8 from one warp at a time.
//   - CUDA cores (bf16 with D % 8 != 0, or a scale <= 0). One thread owns one
//     query row, 128 rows to a block; K and V tiles are staged in shared
//     memory as float32 and every thread of a warp reads the same key
//     (broadcasts); 2 * D scalar FMAs a query-key pair. D is rounded up to a
//     multiple of 8 with zero columns; the probabilities stay float32.
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e30f;
constexpr int kBQ = 128;  // query rows (threads) per block of the CUDA-core path

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

// ---- the tensor-core path ------------------------------------------------------

constexpr int kKeys = 64;  // keys a K/V tile

// Shared memory of the tensor-core path: Q [BQ][LD], K and V [2][kKeys][LD]
// (bf16, LD = 16 * DB + 8: rows 16 bytes apart modulo 128, so ldmatrix's
// eight row addresses hit distinct banks), then the key flags [2][kKeys].
template <int N8, int MT>
struct MmaLayout {
  static constexpr int kWarps = 4;
  static constexpr int DB = (N8 + 1) / 2;  // 16-wide steps of the Q.K^T depth
  static constexpr int BQ = 16 * MT * kWarps;
  static constexpr int DP = 16 * DB;
  static constexpr int LD = DP + 8;
  static constexpr size_t kBytes = (static_cast<size_t>(BQ) + 4 * kKeys) * LD * 2 + 2 * kKeys * 4;
};

// rows [t0, t0 + rows) of one (batch, head) into dst [rows][LD], zero past S
// and past D: 16-byte cp.async chunks when `vec`, else element copies. The
// caller commits and waits.
template <int DP, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int t0, int rows, int S,
                                          int D, size_t row, bool vec) {
  constexpr int CH = DP / 8;
  for (int c = threadIdx.x; c < rows * CH; c += blockDim.x) {
    const int r = c / CH, cc = (c % CH) * 8;
    const int t = t0 + r;
    const bool ok = t < S && cc < D;
    bf16* d = dst + r * LD + cc;
    const bf16* s = src + (ok ? static_cast<size_t>(t) * row + cc : 0);
    if (vec) {
      cp_async16(d, s, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = ok ? s[e] : __float2bfloat16(0.f);
    }
  }
}

// N8 = D / 8 output tiles of 8 columns; MT 16-row query tiles a warp (2: the
// K and V fragments read from shared memory serve both).
template <int N8, int MT>
__global__ void __launch_bounds__(MmaLayout<N8, MT>::kWarps * 32)
attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              bf16* __restrict__ o, const int* __restrict__ kv_lens,
              const int* __restrict__ kv_valid, int S, int H, float scale_log2, int causal,
              bool vec) {
  using L = MmaLayout<N8, MT>;
  constexpr int BQ = L::BQ, DB = L::DB, DP = L::DP, LD = L::LD, D = 8 * N8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + 2 * kKeys * LD;
  int* flags = reinterpret_cast<int*>(Vs + 2 * kKeys * LD);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // a fragment's row and column pair
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int r0 = q0 + warp * 16 * MT;  // the warp's first query row
  const size_t row = static_cast<size_t>(H) * D;  // elements between tokens
  const size_t base = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * D;
  const int kv_len = min(kv_lens[b], S);
  const int tiles = (S + kKeys - 1) / kKeys;

  auto issue = [&](int tile) {
    const int t0 = tile * kKeys, buf = tile & 1;
    load_rows<DP, LD>(Ks + buf * kKeys * LD, k + base, t0, kKeys, S, D, row, vec);
    load_rows<DP, LD>(Vs + buf * kKeys * LD, v + base, t0, kKeys, S, D, row, vec);
    if (kv_valid != nullptr)
      for (int j = threadIdx.x; j < kKeys; j += blockDim.x)
        flags[buf * kKeys + j] =
            t0 + j < S && kv_valid[static_cast<size_t>(b) * S + t0 + j] != 0;
  };

  load_rows<DP, LD>(Qs, q + base, q0, BQ, S, D, row, vec);
  issue(0);
  cp_async_commit();

  unsigned qa[MT][DB][4];
  float acc[MT][N8][4];
  float mx[MT][2], l[MT][2];  // per row (g, g + 8): running max of the raw logits, and this
                              // lane's share of the denominator
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    mx[mt][0] = mx[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int tile = 0; tile < tiles; ++tile) {
    const int t0 = tile * kKeys, buf = tile & 1;
    if (tile + 1 < tiles) issue(tile + 1);  // into the buffer the last tile freed
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile (and Q) has arrived
    if (tile == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kb = 0; kb < DB; ++kb)
          ldmatrix_x4(qa[mt][kb],
                      Qs + (warp * 16 * MT + mt * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD +
                          kb * 16 + 8 * (lane / 16));
    }
    const bf16* Kt = Ks + buf * kKeys * LD;
    const bf16* Vt = Vs + buf * kKeys * LD;

    // S = Q.K^T: 8 tiles of 8 keys; c[0..1] row g, c[2..3] row g + 8
    float sc[MT][kKeys / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][n][e] = 0.f;
#pragma unroll
    for (int jp = 0; jp < kKeys / 16; ++jp) {
#pragma unroll
      for (int kb = 0; kb < DB; ++kb) {
        unsigned bk[4];
        ldmatrix_x4(bk, Kt + (jp * 16 + lane % 8 + 8 * (lane / 16)) * LD + kb * 16 +
                            8 * ((lane / 8) % 2));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(sc[mt][2 * jp], qa[mt][kb], bk[0], bk[1]);
          mma_bf16(sc[mt][2 * jp + 1], qa[mt][kb], bk[2], bk[3]);
        }
      }
    }

    // masks on the raw logits: keys past S weigh 0; masked keys take -1e30 / scale,
    // which the scale below makes the TPU's -1e30
    const float neg = fmaxf(kNeg / scale_log2 * 1.4426950408889634f, -FLT_MAX);
    const bool open = t0 + kKeys <= kv_len && kv_valid == nullptr &&
                      !(causal && t0 + kKeys - 1 > r0);
    if (!open) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = n * 8 + 2 * t4 + (e & 1);
            const int t = t0 + j;
            const int i = r0 + mt * 16 + g + 8 * (e >> 1);
            const bool ok = t < kv_len && (kv_valid == nullptr || flags[buf * kKeys + j]) &&
                            !(causal && t > i);
            sc[mt][n][e] = t >= S ? -INFINITY : (ok ? sc[mt][n][e] : neg);
          }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // online softmax: the tile's row max over the quad, rescale, exponentiate
      float m0 = mx[mt][0], m1 = mx[mt][1];
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        m0 = fmaxf(m0, fmaxf(sc[mt][n][0], sc[mt][n][1]));
        m1 = fmaxf(m1, fmaxf(sc[mt][n][2], sc[mt][n][3]));
      }
#pragma unroll
      for (int x = 1; x < 4; x *= 2) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, x));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, x));
      }
      // every tile holds key t0 < S, whose logit is finite, so m0 and m1 are
      // finite; the first tile rescales from -inf, which gives 0
      const float a0 = ex2((mx[mt][0] - m0) * scale_log2);
      const float a1 = ex2((mx[mt][1] - m1) * scale_log2);
      mx[mt][0] = m0;
      mx[mt][1] = m1;
      l[mt][0] *= a0;
      l[mt][1] *= a1;
#pragma unroll
      for (int n = 0; n < N8; ++n) {
        acc[mt][n][0] *= a0;
        acc[mt][n][1] *= a0;
        acc[mt][n][2] *= a1;
        acc[mt][n][3] *= a1;
      }
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        // (x - m) first: a masked row's equal fills give exactly 2^0 (a fused
        // x * s - m * s would leave the rounding of m * s, ~1e23 at -1e30)
        sc[mt][n][0] = ex2((sc[mt][n][0] - m0) * scale_log2);
        sc[mt][n][1] = ex2((sc[mt][n][1] - m0) * scale_log2);
        sc[mt][n][2] = ex2((sc[mt][n][2] - m1) * scale_log2);
        sc[mt][n][3] = ex2((sc[mt][n][3] - m1) * scale_log2);
        l[mt][0] += sc[mt][n][0] + sc[mt][n][1];
        l[mt][1] += sc[mt][n][2] + sc[mt][n][3];
      }
    }

    // P.V: the unnormalised probabilities, rounded to bf16, are the A fragments
#pragma unroll
    for (int jp = 0; jp < kKeys / 16; ++jp) {
      unsigned pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(sc[mt][2 * jp][0], sc[mt][2 * jp][1]);
        pa[mt][1] = pack_bf16(sc[mt][2 * jp][2], sc[mt][2 * jp][3]);
        pa[mt][2] = pack_bf16(sc[mt][2 * jp + 1][0], sc[mt][2 * jp + 1][1]);
        pa[mt][3] = pack_bf16(sc[mt][2 * jp + 1][2], sc[mt][2 * jp + 1][3]);
      }
      const bf16* vr = Vt + (jp * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD;
#pragma unroll
      for (int db = 0; db < N8 / 2; ++db) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vr + db * 16 + 8 * (lane / 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * db], pa[mt], bv[0], bv[1]);
          mma_bf16(acc[mt][2 * db + 1], pa[mt], bv[2], bv[3]);
        }
      }
      if constexpr (N8 % 2) {  // the last 8 columns (D = 72: columns 64-71)
        unsigned bv[2];
        ldmatrix_x2_trans(bv, vr + (N8 - 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][N8 - 1], pa[mt], bv[0], bv[1]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float den = l[mt][hh];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      const int i = r0 + mt * 16 + g + 8 * hh;
      if (i >= S) continue;
      bf16* dst = o + base + static_cast<size_t>(i) * row;
#pragma unroll
      for (int n = 0; n < N8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[mt][n][2 * hh] / den, acc[mt][n][2 * hh + 1] / den);
    }
}

template <int N8, int MT>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, const int* kv_lens,
                       const int* kv_valid, int B, int S, int H, float scale, int causal,
                       cudaStream_t stream) {
  using L = MmaLayout<N8, MT>;
  const auto kernel = attention_mma<N8, MT>;
  // above 48 KB only after the opt-in, which belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::kBytes));
  if (e != cudaSuccess) return e;
  const bool vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid((S + L::BQ - 1) / L::BQ, B * H);
  kernel<<<grid, L::kWarps * 32, L::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), kv_lens, kv_valid, S, H, scale * 1.4426950408889634f, causal, vec);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_mma_d(const void* q, const void* k, const void* v, void* o,
                         const int* kv_lens, const int* kv_valid, int B, int S, int H, int D,
                         float scale, int causal, cudaStream_t stream) {
  switch (D / 8) {
#define ATTN_N8_CASE(N)                                                                    \
  case N:                                                                                  \
    if constexpr (MT == 1 || N <= 10) /* two tiles a warp fit the registers to D = 80 */ \
      return launch_mma<N, MT>(q, k, v, o, kv_lens, kv_valid, B, S, H, scale, causal,      \
                               stream);                                                    \
    return cudaErrorInvalidValue;
    ATTN_N8_CASE(1)
    ATTN_N8_CASE(2)
    ATTN_N8_CASE(3)
    ATTN_N8_CASE(4)
    ATTN_N8_CASE(5)
    ATTN_N8_CASE(6)
    ATTN_N8_CASE(7)
    ATTN_N8_CASE(8)
    ATTN_N8_CASE(9)
    ATTN_N8_CASE(10)
    ATTN_N8_CASE(11)
    ATTN_N8_CASE(12)
    ATTN_N8_CASE(13)
    ATTN_N8_CASE(14)
    ATTN_N8_CASE(15)
    ATTN_N8_CASE(16)
#undef ATTN_N8_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- the float32 tensor-core path (3xTF32) ---------------------------------------

// Shared memory of the float32 path: Q [BQ] rows, K and V [2][KEYS] rows each
// (F32Tile rows of LD floats), then the key flags [2][KEYS].
template <int N8>
struct Tf32Layout {
  static constexpr int kWarps = 4;
  static constexpr int BQ = 16 * kWarps;           // query rows a block, 16 a warp
  static constexpr int DP = 8 * N8;
  static constexpr int KEYS = N8 <= 10 ? 64 : 32;  // keys a K/V tile: two blocks an SM
  static constexpr int LD = F32Tile<DP>::LD;
  static constexpr size_t kBytes =
      (static_cast<size_t>(BQ) + 4 * KEYS) * LD * 4 + 2 * KEYS * 4;
};

// N8 = DP / 8: D rounded up to whole 8-column steps with zero columns (the
// depth of Q.K^T and the output tiles of P.V). A warp owns 16 query rows.
template <int N8>
__global__ void __launch_bounds__(Tf32Layout<N8>::kWarps * 32)
attention_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               const int* __restrict__ kv_lens, const int* __restrict__ kv_valid, int S, int H,
               int D, float scale_log2, int causal, bool vec) {
  using L = Tf32Layout<N8>;
  constexpr int BQ = L::BQ, DP = L::DP, KEYS = L::KEYS, LD = L::LD, NK = KEYS / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + 2 * KEYS * LD;
  int* flags = reinterpret_cast<int*>(Vs + 2 * KEYS * LD);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // a fragment's row and column pair
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int r0 = q0 + warp * 16;  // the warp's first query row
  const size_t row = static_cast<size_t>(H) * D;  // elements between tokens
  const size_t base = static_cast<size_t>(b) * S * row + static_cast<size_t>(h) * D;
  const int kv_len = min(kv_lens[b], S);
  const int tiles = (S + KEYS - 1) / KEYS;
  // a masked logit, -1e30, in the base-2 units of the scaled logits below
  const float neg = kNeg * 1.4426950408889634f;

  auto issue = [&](int tile) {
    const int t0 = tile * KEYS, buf = tile & 1;
    stage_f32<DP>(Ks + buf * KEYS * LD, k + base, t0, KEYS, S, D, row, vec);
    stage_f32<DP>(Vs + buf * KEYS * LD, v + base, t0, KEYS, S, D, row, vec);
    if (kv_valid != nullptr)
      for (int j = threadIdx.x; j < KEYS; j += blockDim.x)
        flags[buf * KEYS + j] = t0 + j < S && kv_valid[static_cast<size_t>(b) * S + t0 + j] != 0;
  };

  stage_f32<DP>(Qs, q + base, q0, BQ, S, D, row, vec);
  issue(0);
  cp_async_commit();

  float acc[N8][4];
  float mx[2], l[2];  // per row (g, g + 8): running max of the base-2 logits, and this lane's
                      // share of the denominator
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  mx[0] = mx[1] = -INFINITY;
  l[0] = l[1] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    const int t0 = tile * KEYS, buf = tile & 1;
    if (tile + 1 < tiles) issue(tile + 1);  // into the buffer the last tile freed
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile (and Q) has arrived
    const float* Kt = Ks + buf * KEYS * LD;
    const float* Vt = Vs + buf * KEYS * LD;

    // S = Q.K^T: NK tiles of 8 keys; c[0..1] row g, c[2..3] row g + 8
    float sc[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    tf32_product_over_columns<DP, NK>(sc, Qs, warp * 16, Kt, g, t4);

    // scaled to base-2 logits; masked keys take -1e30 (scaled), keys past S weigh 0
    const bool open = t0 + KEYS <= kv_len && kv_valid == nullptr &&
                      !(causal && t0 + KEYS - 1 > r0);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (!open) {
          const int j = n * 8 + 2 * t4 + (e & 1);
          const int t = t0 + j;
          const int i = r0 + g + 8 * (e >> 1);
          const bool ok = t < kv_len && (kv_valid == nullptr || flags[buf * KEYS + j]) &&
                          !(causal && t > i);
          x = t >= S ? -INFINITY : (ok ? x : neg);
        }
        sc[n][e] = x;
      }

    // online softmax: the tile's row max over the quad, rescale, exponentiate
    float m0 = mx[0], m1 = mx[1];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      m0 = fmaxf(m0, fmaxf(sc[n][0], sc[n][1]));
      m1 = fmaxf(m1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x *= 2) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, x));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, x));
    }
    // every tile holds key t0 < S, whose logit is finite, so m0 and m1 are
    // finite; the first tile rescales from -inf, which gives 0
    const float a0 = ex2(mx[0] - m0);
    const float a1 = ex2(mx[1] - m1);
    mx[0] = m0;
    mx[1] = m1;
    l[0] *= a0;
    l[1] *= a1;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      // a masked row's equal fills give exactly 2^0
      sc[n][0] = ex2(sc[n][0] - m0);
      sc[n][1] = ex2(sc[n][1] - m0);
      sc[n][2] = ex2(sc[n][2] - m1);
      sc[n][3] = ex2(sc[n][3] - m1);
      l[0] += sc[n][0] + sc[n][1];
      l[1] += sc[n][2] + sc[n][3];
    }

    // P.V: the unnormalised float32 probabilities of 8 keys are the A fragment,
    // its depth read in key order (0, 2, 4, 6, 1, 3, 5, 7): the accumulator's
    // keys (2t, 2t + 1) are the A pair (t, t + 4), and V's rows are taken in
    // the same order
    tf32_product_over_rows<DP, NK>(acc, sc, Vt, g, t4);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float den = l[hh];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int i = r0 + g + 8 * hh;
    if (i >= S) continue;
    float* dst = o + base + static_cast<size_t>(i) * row;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const int c = n * 8 + 2 * t4;
      if (c < D) dst[c] = acc[n][2 * hh] / den;
      if (c + 1 < D) dst[c + 1] = acc[n][2 * hh + 1] / den;
    }
  }
}

template <int N8>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o,
                        const int* kv_lens, const int* kv_valid, int B, int S, int H, int D,
                        float scale, int causal, cudaStream_t stream) {
  using L = Tf32Layout<N8>;
  const auto kernel = attention_tf32<N8>;
  // above 48 KB only after the opt-in, which belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::kBytes));
  if (e != cudaSuccess) return e;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid((S + L::BQ - 1) / L::BQ, B * H);
  kernel<<<grid, L::kWarps * 32, L::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), kv_lens, kv_valid, S, H, D, scale * 1.4426950408889634f, causal,
      vec);
  return cudaGetLastError();
}

cudaError_t launch_tf32_d(const void* q, const void* k, const void* v, void* o,
                          const int* kv_lens, const int* kv_valid, int B, int S, int H, int D,
                          float scale, int causal, cudaStream_t stream) {
  switch ((D + 7) / 8) {
#define ATTN_TF32_CASE(N)                                                                   \
  case N:                                                                                   \
    return launch_tf32<N>(q, k, v, o, kv_lens, kv_valid, B, S, H, D, scale, causal, stream);
    ATTN_TF32_CASE(1)
    ATTN_TF32_CASE(2)
    ATTN_TF32_CASE(3)
    ATTN_TF32_CASE(4)
    ATTN_TF32_CASE(5)
    ATTN_TF32_CASE(6)
    ATTN_TF32_CASE(7)
    ATTN_TF32_CASE(8)
    ATTN_TF32_CASE(9)
    ATTN_TF32_CASE(10)
    ATTN_TF32_CASE(11)
    ATTN_TF32_CASE(12)
    ATTN_TF32_CASE(13)
    ATTN_TF32_CASE(14)
    ATTN_TF32_CASE(15)
    ATTN_TF32_CASE(16)
#undef ATTN_TF32_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Self-attention over contiguous [B, S, H, D] q, k, v into o (same shape and
// type). kv_lens [B] int32; kv_valid [B, S] int32 or null; D from 1 to 128.
// float32 takes the 3xTF32 tensor-core path (block_q 0). bf16: block_q 0 takes
// the CUDA-core path; 64 or 128 the tensor-core path with that many query rows
// a block (D % 8 == 0; 128: two 16-row tiles a warp, D <= 80).
extern "C" int attention_launch(const void* q, const void* k, const void* v, void* o,
                                const int* kv_lens, const int* kv_valid, int B, int S, int H,
                                int D, float scale, int causal, int dtype, int block_q,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || D < 1 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = block_q != 0 ? cudaErrorInvalidValue
                       : launch_tf32_d(q, k, v, o, kv_lens, kv_valid, B, S, H, D, scale, causal,
                                       s);
  } else if (dtype != kBFloat16) {
    err = cudaErrorInvalidValue;
  } else if (block_q == 0) {
    err = launch_dp<__nv_bfloat16>(q, k, v, o, kv_lens, kv_valid, B, S, H, D, scale, causal, s);
  } else if (D % 8 != 0) {
    err = cudaErrorInvalidValue;
  } else if (block_q == 64) {
    err = launch_mma_d<1>(q, k, v, o, kv_lens, kv_valid, B, S, H, D, scale, causal, s);
  } else if (block_q == 128 && D <= 80) {
    err = launch_mma_d<2>(q, k, v, o, kv_lens, kv_valid, B, S, H, D, scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
