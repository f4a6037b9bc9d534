// K7a / K7b: decode attention over a paged KV pool.
//
// Replaces the two TPU kernels of multimodal_colpali_tpu/ops/paged_attention.py:
//   K7a _paged_kernel      (pl.pallas_call at paged_attention.py:196, paged_attention)
//   K7b _paged_kernel_int8 (paged_attention.py:350, paged_attention_int8)
// One decode token per slot: q [B, Hq, D] attends the slot's tokens in pools
// [P, page, Hkv, D], token t of slot b at page block_tables[b, t / page], row
// t % page; positions >= lengths[b] are masked, and with window > 0 (Gemma-3's
// sliding layers) so are positions < lengths[b] - window. GQA: q head
// j * group + g reads kv head j. Softmax is online, in float32, with the TPU
// kernel's finite fill NEG = -1e30 and running maxima that start there, so a
// slot with lengths[b] == 0 (every inactive slot of the batcher) gets the
// uniform mean of all NB * page gathered V rows, as the plain version does.
// K7b reads int8 codes with float32 scales [P, page, Hkv]: the K scale times
// `scale` multiplies each logit after the dot, the V scale multiplies each
// probability before the PV dot (rounded to q's type there, as on the TPU).
//
// What bounds it on an H100. Every K/V byte a slot needs is read once per
// decode step for 4 * group operations per element pair: memory-bound by far
// (for gemma-3-27b, group 2 and D 128, one layer's pools hold 8 KB a token in
// bf16). The bytes must be in flight from many blocks at once.
//
// Design (flash-decoding, split over the sequence). The tokens a slot needs
// are [lengths - window, lengths) when lengths >= 1 (skipping the rest cannot
// change the result), else all NB * page of them. Block (kv head, slot,
// split) owns `split_tokens` of them and serves the head's `group` q heads,
// so each K/V row is read once for all of them. It streams its range through
// shared memory in tiles of 32 tokens (a tile may span pages of any size),
// double-buffered with cp.async so the next tile's rows are in flight while
// this one is computed; rows stay in the pool's type in shared memory (int8
// codes widened as they are read). Per tile: a warp per (q head, token) dot
// product with the lanes splitting D, a warp per q head updating its running
// max and sum, then each thread updating its (q head, d) accumulators in
// registers. With one split the block writes the output; otherwise each
// writes its (max, sum, accumulator) and paged_combine merges the splits.
// A split with no token of the range writes a maximum of -inf and weighs
// nothing; the splits of an all-masked slot each carry NEG and share the
// uniform mean.
#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;          // tokens per tile (one per lane in the softmax step)
constexpr int kMaxAcc = 32;     // (q head, d) accumulators a thread can hold
constexpr float kNeg = -1e30f;  // paged_attention.py's NEG

template <typename T>
__device__ __forceinline__ float cast_round(float x);
template <>
__device__ __forceinline__ float cast_round<float>(float x) { return x; }
template <>
__device__ __forceinline__ float cast_round<bf16>(float x) { return round_bf16(x); }

// The type P is rounded to before the PV dot: the pool's (bf16 or float32);
// for int8 pools the caller rounds P * v_scale to q's type instead.
template <typename Tkv>
using RoundT = typename std::conditional<std::is_same<Tkv, float>::value, float, bf16>::type;

template <typename Tq, typename Tkv>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Tq* __restrict__ q, const Tkv* __restrict__ kpool,
                       const Tkv* __restrict__ vpool, const float* __restrict__ kscale,
                       const float* __restrict__ vscale, const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, Tq* __restrict__ out,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int Hq, int Hkv, int D, int page, int NB,
                       float scale, int window, int split_tokens) {
  constexpr bool kInt8 = std::is_same<Tkv, signed char>::value;
  constexpr int kChunk = 16 / sizeof(Tkv);  // elements in a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = Hq / Hkv;
  Tkv* Ks = reinterpret_cast<Tkv*>(smem_raw);      // [2][kT][D]
  Tkv* Vs = Ks + 2 * kT * D;                       // [2][kT][D]
  float* qs = reinterpret_cast<float*>(Vs + 2 * kT * D);  // [G][D]
  float* S = qs + G * D;                           // [G][kT] logits, then probabilities
  float* m_s = S + G * kT;                         // [G] running max
  float* l_s = m_s + G;                            // [G] running sum
  float* alpha_s = l_s + G;                        // [G] this tile's rescale
  float* ks_s = alpha_s + G;                       // [2][kT] K scales (int8 pools)
  float* vs_s = ks_s + 2 * kT;                     // [2][kT] V scales

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = lengths[b];
  const int total = NB * page;
  const int* bt = block_tables + static_cast<size_t>(b) * NB;

  // The tokens this slot needs, and this split's share of them.
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int hi = min(len, total);
  const bool some = len >= 1 && lo < hi;
  const int r_lo = (some ? lo : 0) + z * split_tokens;
  const int r_hi = min(some ? hi : total, r_lo + split_tokens);
  const size_t part = (static_cast<size_t>(b) * Hq + h * G) * splits + z;  // + g * splits

  if (r_lo >= r_hi) {  // nothing here: weigh nothing in the merge
    for (int g = tid; g < G; g += kThreads) {
      part_m[part + g * splits] = -INFINITY;
      part_l[part + g * splits] = 0.f;
    }
    for (int i = tid; i < G * D; i += kThreads)
      part_acc[(part + (i / D) * splits) * D + i % D] = 0.f;
    return;
  }

  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = to_f32(q[(static_cast<size_t>(b) * Hq + h * G) * D + i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;

  const bool vec = D % kChunk == 0;
  const int chunks = vec ? D / kChunk : D;
  // Tile `tile` (tokens r_lo + tile * kT ...) into buffer `buf`: cp.async
  // when a row is a whole number of 16-byte chunks, plain loads otherwise.
  auto load = [&](int tile, int buf) {
    Tkv* kd = Ks + buf * kT * D;
    Tkv* vd = Vs + buf * kT * D;
    for (int i = tid; i < kT * chunks; i += kThreads) {
      const int t = i / chunks;
      const int c = i % chunks;
      const int pos = r_lo + tile * kT + t;
      const bool ok = pos < r_hi;
      const size_t row =
          ok ? (static_cast<size_t>(bt[pos / page]) * page + pos % page) * Hkv + h : 0;
      if (vec) {
        cp_async16(kd + t * D + c * kChunk, kpool + row * D + c * kChunk, ok);
        cp_async16(vd + t * D + c * kChunk, vpool + row * D + c * kChunk, ok);
      } else {
        kd[t * D + c] = ok ? kpool[row * D + c] : Tkv(0);
        vd[t * D + c] = ok ? vpool[row * D + c] : Tkv(0);
      }
      if (kInt8 && c == 0) {
        cp_async4(ks_s + buf * kT + t, kscale + row, ok);
        cp_async4(vs_s + buf * kT + t, vscale + row, ok);
      }
    }
    cp_async_commit();
  };

  const int n_tiles = (r_hi - r_lo + kT - 1) / kT;
  load(0, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      load(tile + 1, buf ^ 1);  // in flight while this tile is computed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Tkv* Kt = Ks + buf * kT * D;
    const Tkv* Vt = Vs + buf * kT * D;
    const float* kst = ks_s + buf * kT;
    const float* vst = vs_s + buf * kT;
    const int t0 = r_lo + tile * kT;

    // (1) logits: a warp per (q head, token), the lanes splitting D
    for (int pair = warp; pair < G * kT; pair += kWarps) {
      const int g = pair / kT;
      const int t = pair % kT;
      const int pos = t0 + t;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot = fmaf(qs[g * D + d], to_f32(Kt[t * D + d]), dot);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        float v;
        if (pos >= r_hi) {
          v = -INFINITY;  // outside this split's share: another block owns it
        } else if (pos >= len || (window > 0 && pos < len - window)) {
          v = kNeg;
        } else {
          v = kInt8 ? dot * (kst[t] * scale) : dot * scale;
        }
        S[g * kT + t] = v;
      }
    }
    __syncthreads();

    // (2) online softmax: a warp per q head, a lane per token
    for (int g = warp; g < G; g += kWarps) {
      const float v = S[g * kT + lane];
      float mx = v;
#pragma unroll
      for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(v - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      S[g * kT + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // (3) acc = acc * alpha + P . V, a thread per (q head, d)
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int idx = tid + j * kThreads;
      if (idx >= G * D) break;
      const int g = idx / D;
      const int d = idx % D;
      float a = acc[j] * alpha_s[g];
      const float* pg = S + g * kT;
      for (int t = 0; t < kT; ++t) {
        float p = pg[t];
        p = kInt8 ? cast_round<Tq>(p * vst[t]) : cast_round<RoundT<Tkv>>(p);
        a = fmaf(p, to_f32(Vt[t * D + d]), a);
      }
      acc[j] = a;
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int idx = tid + j * kThreads;
    if (idx >= G * D) break;
    const int g = idx / D;
    if (splits == 1) {
      out[(static_cast<size_t>(b) * Hq + h * G) * D + idx] =
          from_f32<Tq>(acc[j] / fmaxf(l_s[g], 1e-30f));
    } else {
      part_acc[(part + g * splits) * D + idx % D] = acc[j];
    }
  }
  if (splits > 1) {
    for (int g = tid; g < G; g += kThreads) {
      part_m[part + g * splits] = m_s[g];
      part_l[part + g * splits] = l_s[g];
    }
  }
}

// out[b, hq, :] = sum_z e^(m_z - M) acc_z / sum_z e^(m_z - M) l_z, M = max_z m_z.
template <typename Tq>
__global__ void paged_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
                              const float* __restrict__ part_acc, Tq* __restrict__ out, int D,
                              int splits) {
  const size_t row = blockIdx.x;  // b * Hq + hq
  const float* m = part_m + row * splits;
  const float* l = part_l + row * splits;
  float mx = -INFINITY;
  for (int z = 0; z < splits; ++z) mx = fmaxf(mx, m[z]);
  float den = 0.f;
  for (int z = 0; z < splits; ++z) den += l[z] * expf(m[z] - mx);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f;
    for (int z = 0; z < splits; ++z)
      num += part_acc[(row * splits + z) * D + d] * expf(m[z] - mx);
    out[row * D + d] = from_f32<Tq>(num / fmaxf(den, 1e-30f));
  }
}

template <typename Tq, typename Tkv>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ks,
                   const float* vs, const int* bt, const int* lens, void* out, float* part_m,
                   float* part_l, float* part_acc, int B, int Hq, int Hkv, int D, int page,
                   int NB, float scale, int window, int splits, int split_tokens,
                   cudaStream_t s) {
  const int G = Hq / Hkv;
  const size_t bytes = sizeof(Tkv) * 4 * kT * static_cast<size_t>(D) +
                       sizeof(float) * (static_cast<size_t>(G) * D + G * kT + 3 * G + 4 * kT);
  auto kernel = paged_attention_kernel<Tq, Tkv>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(Hkv, B, splits), kThreads, bytes, s>>>(
      static_cast<const Tq*>(q), static_cast<const Tkv*>(kp), static_cast<const Tkv*>(vp), ks,
      vs, bt, lens, static_cast<Tq*>(out), part_m, part_l, part_acc, Hq, Hkv, D, page, NB,
      scale, window, split_tokens);
  if (splits > 1)
    paged_combine<Tq><<<B * Hq, 128, 0, s>>>(part_m, part_l, part_acc, static_cast<Tq*>(out), D,
                                             splits);
  return cudaGetLastError();
}

}  // namespace

// out [B, Hq, D] = paged decode attention of q [B, Hq, D] over k/v pools
// [P, page, Hkv, D] through block_tables [B, NB] and lengths [B] (int32).
// q_dtype: 0 float32, 1 bfloat16 (out has q's type). kv_dtype: 0 float32 and
// 1 bfloat16 (K7a, q of the same type; k_scale/v_scale unused), 2 int8 codes
// with float32 scales [P, page, Hkv] (K7b). window 0 = full causal. Each of
// `splits` blocks per (slot, kv head) takes `split_tokens` (a multiple of 32)
// of the tokens; with splits > 1, part_m and part_l (float32 [B, Hq, splits])
// and part_acc ([B, Hq, splits, D]) hold the partial results.
// Hkv divides Hq, Hq / Hkv * D <= 4096; pointers are 16-byte aligned.
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* k_scale, const void* v_scale,
                                      const void* block_tables, const void* lengths, void* out,
                                      void* part_m, void* part_l, void* part_acc, int B, int Hq,
                                      int Hkv, int D, int page, int NB, float scale, int window,
                                      int splits, int split_tokens, int q_dtype, int kv_dtype,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || D <= 0 || page <= 0 || NB <= 0 || Hq % Hkv ||
      (Hq / Hkv) * D > kMaxAcc * kThreads || window < 0 || splits < 1 || split_tokens <= 0 ||
      split_tokens % kT || static_cast<long long>(splits) * split_tokens < 1LL * NB * page)
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1 && (part_m == nullptr || part_l == nullptr || part_acc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
#define PAGED_ARGS                                                                          \
  q, k_pool, v_pool, ks, vs, bt, lens, out, pm, pl, pa, B, Hq, Hkv, D, page, NB, scale, window, \
      splits, split_tokens, s
  if (kv_dtype == 2 && (ks == nullptr || vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_dtype == kFloat32 && kv_dtype == 0) return static_cast<int>(launch<float, float>(PAGED_ARGS));
  if (q_dtype == kBFloat16 && kv_dtype == 1) return static_cast<int>(launch<bf16, bf16>(PAGED_ARGS));
  if (q_dtype == kFloat32 && kv_dtype == 2)
    return static_cast<int>(launch<float, signed char>(PAGED_ARGS));
  if (q_dtype == kBFloat16 && kv_dtype == 2)
    return static_cast<int>(launch<bf16, signed char>(PAGED_ARGS));
#undef PAGED_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
