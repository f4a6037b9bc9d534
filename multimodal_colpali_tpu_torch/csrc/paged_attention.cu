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
// kernel's finite fill NEG = -1e30, so a slot with lengths[b] == 0 (every
// inactive slot of the batcher) gets the uniform mean of all NB * page
// gathered V rows, as the plain version does. The unnormalised probabilities
// are rounded to the pool's type (K7a) or, times the V scale, to q's type
// (K7b) before P.V, and the float32 sum is divided at the end: the TPU
// kernels' rounding points. K7b reads int8 codes with float32 scales
// [P, page, Hkv]: the K scale times `scale` multiplies each logit after the
// dot.
//
// What bounds it on an H100. Every K/V byte a slot needs is read once per
// decode step for 4 * group operations a pair of elements: memory-bound by
// far. For gemma-3-27b (group 2, D 128) a token of one layer's pools is 8 KB
// in bf16 and 4.1 KB in int8; a decode step of 4 slots at 309-1,509 tokens
// reads ~26 MB a layer, ~8 us at 3.35 TB/s. At that size what decides the
// time is how many blocks stream at once and how long each one's chain of
// dependent steps is. Measured at that shape as CUDA-graph replays (PERF.md,
// section 6): ~11 us of a ~23-25 us call is fixed (the launch, the memset of
// the arrival counters, the lookups of lengths and page table before the
// first copy, the merge of the splits); a build with the products skipped
// (-DPAGED_SKIP_PRODUCTS, generation/paged_sweep.py --probe) takes 20.8 us
// for the 29.8 MB of the bf16 call, 1.43 TB/s with its fixed part; the
// products add the rest: a block's few stages leave too little to hide them.
//
// The tokens slot b needs are [lengths - window, lengths) when lengths >= 1
// (skipping the rest cannot change the result: their weight is exp(-1e30 -
// m) = 0), else all NB * page of them. Split plan: the wrapper fixes `splits`
// from shapes alone (ops/paged_attention.split_plan), never from lengths, so
// a CUDA graph can capture the launch: B * splits blocks a kv head, about two
// blocks for each SM. The kernel deals a kv head's blocks to the slots on the
// card (block_share): one each, the rest in proportion to the rows a slot
// reads, so a long slot gets more blocks and every block streams about the
// same bytes; a slot's blocks take near-equal runs of its 16-token steps
// (split_part). A slot with one block writes its output; otherwise each of
// its blocks writes a partial (max, sum, float32 accumulator) and the last to
// arrive, by an atomic counter in the call's own partials buffer (zeroed by a
// memset in the launch's stream, so launches on other streams or in CUDA
// graphs share nothing), merges them in block order: no combine launch, and
// the same bits on every call. A part with no token writes a max of -inf and
// weighs nothing.
//
// Two paths, chosen by the wrapper:
//   - Tensor cores (bf16 q over bf16 or int8 pools, D % 16 == 0, D <= 256,
//     group <= 16; gemma-3-27b and Gemma-1 2B). 4 warps. A stage is 64 tokens,
//     a 16-token step for each warp, of K and V rows (in the pool's type) in a
//     3-stage ring in shared memory (rows padded by 16 bytes), with one block
//     barrier a stage. Each row (256 bytes for gemma-3-27b's bf16 pools) comes
//     by one bulk copy (cp.async.bulk) that reports to the ring slot's
//     mbarrier. Sixteen 16-byte cp.async copies a row, the first loader,
//     held each block to a small share of the memory rate (an SM keeps only
//     so many requests in flight) and were slower at the decode shape with
//     bf16 pools; with int8's 128-byte rows the two were level, so one loader
//     serves both. A TMA tensor map with one page box a stage has not been
//     built or measured against these copies (ROADMAP.md, section 3): boxes
//     need page-aligned steps and a swizzled layout. Products on
//     mma.sync m16n8k16: the group's q heads, padded to 16, are the A rows,
//     loaded once into registers; a step's 16 tokens are the N columns of
//     S = Q.K^T and the K dimension of P.V. The contracted dimensions are
//     permuted so that a lane's fragments are whole runs of a row: in Q.K^T,
//     lane quad t4 of k16 step kb takes d = 16 kb + 4 t4 + {0..3} (one 8-byte
//     bf16 load or one 4-byte int8 load a K fragment); in P.V, column n of
//     n8 tile j is d = n * D / 8 + j, so lane group g reads one contiguous run
//     of each of its four V rows for all tiles, and the output columns it
//     holds are two contiguous runs. int8 codes are widened exactly in
//     registers (code + 128 into 2^23's mantissa, as K8a's decode tile), never
//     through shared memory. S's accumulator fragments, scaled (K7b: by each
//     token's K scale) and masked, give each row's max and sum over the 4
//     lanes of a quad; the probabilities (K7b: times each token's V scale) are
//     rounded to bf16 once a (head, token) and packed straight into P.V's A
//     fragments. Each warp keeps its own running max, sum and accumulators
//     over its steps; the warps meet once, at the end, through shared memory,
//     in warp order. A slot with lengths 0 reads no K and takes no Q.K^T: its
//     every logit is NEG, so each probability is exactly 1 whatever K holds.
//   - CUDA cores (float32 q or pools, other D or group): the block walks its
//     part in tiles of 32 tokens double-buffered by cp.async; a warp per
//     (q head, token) dot product with the lanes splitting D, a warp per q
//     head for the online softmax, a thread per (q head, d) for P.V.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e30f;  // paged_attention.py's NEG
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStep = 16;       // tokens of a split step (split_plan's unit)

// The tokens slot b needs: [lo, hi) of a slot holding `len` tokens, or all
// `total` of them (every logit NEG) when there is none.
__device__ __forceinline__ void slot_range(int len, int window, int total, int& lo, int& hi,
                                           bool& some) {
  lo = window > 0 ? max(0, len - window) : 0;
  hi = min(len, total);
  some = len >= 1 && lo < hi;
  if (!some) {
    lo = 0;
    hi = total;
  }
}

// Part z of `splits` of [lo, hi): the z-th near-equal run of 16-token steps.
__device__ __forceinline__ void split_part(int lo, int hi, int z, int splits, int& a, int& e) {
  const long long steps = (hi - lo + kStep - 1) / kStep;
  a = lo + static_cast<int>(z * steps / splits) * kStep;
  e = min(hi, lo + static_cast<int>((z + 1) * steps / splits) * kStep);
}

// Block j of the J blocks of a kv head: its slot b, the slot's first block j0
// and block count n, and the slot's needed range. Every slot gets one block
// and the other J - B go to the slots in proportion to the rows each reads
// (K and V of each needed token; a slot with no token its NB * page V rows),
// by the floor of their running sums: the same deal in every block, from
// lengths read on the card.
struct Share {
  int b, j0, n, lo, hi;
  bool some;
};

__device__ Share block_share(const int* __restrict__ lengths, int B, int window, int total, int J,
                             int j) {
  long long T = 0;
#pragma unroll 8  // the slots' lengths in flight together, not one round trip each
  for (int b = 0; b < B; ++b) {
    int lo, hi;
    bool some;
    slot_range(__ldg(lengths + b), window, total, lo, hi, some);
    T += some ? 2LL * (hi - lo) : total;
  }
  // slot b owns blocks j0(b) = b + floor(c_b (J - B) / T) up to j0(b + 1),
  // c_b the rows before it: block j is past slot b when (j - b) T > (c_b +
  // w_b) (J - B), a product, so the scan divides nothing
  Share sh{};
  long long c = 0;
#pragma unroll 8
  for (int b = 0; b < B; ++b) {
    slot_range(__ldg(lengths + b), window, total, sh.lo, sh.hi, sh.some);
    const long long w = sh.some ? 2LL * (sh.hi - sh.lo) : total;
    if (static_cast<long long>(j - b) * T <= (c + w) * (J - B) || b == B - 1) {
      sh.b = b;
      sh.j0 = b + static_cast<int>(c * (J - B) / T);
      sh.n = b + 1 + static_cast<int>((c + w) * (J - B) / T) - sh.j0;
      break;
    }
    c += w;
  }
  return sh;
}

// Each split's partial result, and the arrival count of each (slot, kv head).
struct Parts {
  float* acc;       // [Hkv, J, G, D] float32 accumulators, J = B * splits blocks a kv head
  float* ml;        // [Hkv, J, 2, G]: running max, then running sum
  unsigned* count;  // [B * Hkv], zeroed before the launch
};

// Called by every thread of a block once its partial (block j0 + z of the n
// blocks of slot sh.b and kv head h) is written. The barrier orders the block's
// writes before thread 0's arrival, an acquire-release atomic at device scope
// that publishes them; the last of the n blocks to arrive merges the parts in
// block order, out = sum_z e^(m_z - M) acc_z / sum_z e^(m_z - M) l_z, in one
// pass with a running maximum (so the parts' loads are in flight together).
// `last` is a flag in shared memory.
template <typename Tq>
__device__ void merge_splits(const Parts& parts, Tq* __restrict__ out, int h, int Hkv, int G,
                             int D, int J, const Share& sh, int* last) {
  const int b = sh.b;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned prev;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(parts.count + b * Hkv + h) : "memory");
    *last = prev == sh.n - 1u;
  }
  __syncthreads();
  if (!*last) return;
  const size_t base = static_cast<size_t>(h) * J + sh.j0;
  const float* ml = parts.ml + base * 2 * G;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    float mx = -INFINITY, den = 0.f, num = 0.f;
#pragma unroll 8
    for (int z = 0; z < sh.n; ++z) {
      const float m = __ldcg(ml + z * 2 * G + g);
      const float l = __ldcg(ml + z * 2 * G + G + g);
      const float acc = __ldcg(parts.acc + (base + z) * G * D + i);
      if (m == -INFINITY) continue;  // a part with no token
      const float nm = fmaxf(mx, m);
      const float fo = expf(mx - nm), fz = expf(m - nm);  // the first part: fo = 0
      den = den * fo + l * fz;
      num = num * fo + acc * fz;
      mx = nm;
    }
    out[(static_cast<size_t>(b) * Hkv * G + h * G) * D + i] = from_f32<Tq>(num / fmaxf(den, 1e-30f));
  }
}

// A part with no token: a max of -inf and a sum of 0 for each q head.
template <typename Tq>
__device__ void empty_part(const Parts& parts, Tq* out, int h, int j, int Hkv, int G, int D,
                           int J, const Share& sh, int* last) {
  float* ml = parts.ml + (static_cast<size_t>(h) * J + j) * 2 * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    ml[g] = -INFINITY;
    ml[G + g] = 0.f;
  }
  merge_splits<Tq>(parts, out, h, Hkv, G, D, J, sh, last);
}

// ---- the tensor-core path ----------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStageTokens = kWarps * kStep;  // 64: a step for each warp
constexpr int kStages = 3;
static_assert(kThreads == 2 * kStageTokens, "the loader takes two threads a row");

template <typename Tkv, int D>
struct TcLayout {
  static constexpr bool kInt8 = std::is_same<Tkv, signed char>::value;
  static constexpr int kBytesRow = D * static_cast<int>(sizeof(Tkv));
  static constexpr int kChunks = kBytesRow / 16;            // 16-byte copies a row
  static constexpr int kRow = kBytesRow + 16;               // shared row stride
  static constexpr int kRows = kStageTokens * kRow;         // K (or V) of a stage
  static constexpr int kStage = 2 * kRows + (kInt8 ? 2 * kStageTokens * 4 : 0);  // + scales
  static constexpr int kBytes = kStages * kStage;  // the ring (its barriers follow)
  // P.V's n8 tiles a V load feeds: 8, 4 or 2 (D / 8 is even)
  static constexpr int kTiles = (D / 8) % 8 == 0 ? 8 : (D / 8) % 4 == 0 ? 4 : 2;
  static constexpr int kRun = kTiles * static_cast<int>(sizeof(Tkv));  // its bytes a row
};

// `RUN` bytes at p (aligned to RUN, a power of two from 2 to 16) into words.
template <int RUN>
__device__ __forceinline__ void load_run(const unsigned char* p, unsigned (&w)[(RUN + 3) / 4]) {
  if constexpr (RUN == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (RUN == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x, w[1] = x.y;
  } else if constexpr (RUN == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  } else {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
}

// Element k of a run of pool elements, widened into the low 16 bits of a
// bf16 pair by the caller's permute: bf16 is taken as it is, int8 exactly.
template <typename Tkv>
__device__ __forceinline__ unsigned pair_of(const unsigned* w0, const unsigned* w1, int k) {
  if constexpr (std::is_same<Tkv, bf16>::value) {
    return __byte_perm(w0[k / 2], w1[k / 2], k % 2 ? 0x7632 : 0x5410);
  } else {
    return pack_exact(int8_of(w0[k / 4] ^ 0x80808080u, k % 4),
                      int8_of(w1[k / 4] ^ 0x80808080u, k % 4));
  }
}

template <typename Tkv, int D>
__global__ void __launch_bounds__(kThreads)
paged_mma(const bf16* __restrict__ q, const Tkv* __restrict__ kpool,
          const Tkv* __restrict__ vpool, const float* __restrict__ kscale,
          const float* __restrict__ vscale, const int* __restrict__ block_tables,
          const int* __restrict__ lengths, bf16* __restrict__ out, Parts parts, int B, int Hkv,
          int G, int page, int NB, float scale, int window) {
  using L = TcLayout<Tkv, D>;
  constexpr int KB = D / 16;  // k16 steps of Q.K^T
  constexpr int NT = D / 8;   // n8 tiles of P.V
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;

  const int h = blockIdx.x, blk = blockIdx.y, J = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // a fragment's row and column pair
  const Share sh = block_share(lengths, B, window, NB * page, J, blk);
  const int b = sh.b;
  const bool some = sh.some;
  int a, e;
  split_part(sh.lo, sh.hi, blk - sh.j0, sh.n, a, e);
  if (a >= e) {
    empty_part<bf16>(parts, out, h, blk, Hkv, G, D, J, sh, &last);
    return;
  }
  const int* bt = block_tables + static_cast<size_t>(b) * NB;
  const int Hq = Hkv * G;
  // Stage st: tokens a + 64 st .. + 63 into ring slot st % kStages, a bulk
  // copy a row (K only when the slot has tokens). Warps 0-1 take the K rows,
  // 2-3 the V rows, a lane a row: one page lookup each, and each warp's lane
  // 0 first tells the slot's barrier the bytes its warp will copy, so the
  // barrier cannot complete before them. V rows past e are zero-filled (their
  // probabilities are 0, which must not meet stale NaN bits); K rows past e
  // only feed logits that the mask replaces. int8 pools: each row's scale
  // comes by a 4-byte cp.async of the same lane, waited for by group.
  const int r = threadIdx.x % kStageTokens, which = threadIdx.x / kStageTokens;  // 0 K, 1 V
  auto row_of = [&](int st) -> size_t {  // this lane's pool row of stage st (0 past e)
    const int pos = a + st * kStageTokens + r;
    return pos < e ? (static_cast<size_t>(bt[pos / page]) * page + pos % page) * Hkv + h : 0;
  };
  const int n_st = (e - a + kStageTokens - 1) / kStageTokens;
  size_t rows[kStages - 1];  // the first stages' page lookups, in flight together
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) rows[st] = st < n_st ? row_of(st) : 0;
  // Q's A fragments, rows g and g + 8 (q heads past the group are zero):
  // k16 step kb, lane quad t4 holds d = 16 kb + 4 t4 + {0, 1} (a0, a1) and
  // + {2, 3} (a2, a3)
  unsigned qa[KB][4];
  {
    const bf16* q0 = q + (static_cast<size_t>(b) * Hq + h * G) * D + 4 * t4;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const uint2 x0 = g < G ? *reinterpret_cast<const uint2*>(q0 + g * D + 16 * kb)
                             : make_uint2(0u, 0u);
      const uint2 x1 = g + 8 < G ? *reinterpret_cast<const uint2*>(q0 + (g + 8) * D + 16 * kb)
                                 : make_uint2(0u, 0u);
      qa[kb][0] = x0.x, qa[kb][1] = x1.x, qa[kb][2] = x0.y, qa[kb][3] = x1.y;
    }
  }

  // a barrier a ring slot: each warp arrives once a stage, with its bytes
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + L::kBytes);
  if (threadIdx.x < kStages) mbar_init(full + threadIdx.x, kWarps);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  auto fetch = [&](int st, size_t row) {
    const int slot = st % kStages;
    unsigned char* dst = smem + slot * L::kStage;
    const bool ok = a + st * kStageTokens + r < e;
    const bool copy = ok && (which == 1 || some);
    const unsigned n = __popc(__ballot_sync(0xffffffffu, copy));
    if (lane == 0) mbar_arrive_tx(full + slot, n * L::kBytesRow);
    __syncwarp();
    unsigned char* drow = dst + which * L::kRows + r * L::kRow;
    if (copy) {
      bulk_load(drow, (which ? vpool : kpool) + row * D, L::kBytesRow, full + slot);
    } else if (which == 1) {
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
        reinterpret_cast<uint4*>(drow)[c] = make_uint4(0u, 0u, 0u, 0u);
    }
    if constexpr (L::kInt8) {
      float* sdst = reinterpret_cast<float*>(dst + 2 * L::kRows) + which * kStageTokens + r;
      if (which == 1 || some) cp_async4(sdst, (which ? vscale : kscale) + row, ok);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_st) fetch(st, rows[st]);
    cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (scaled logits)
  float l[2] = {0.f, 0.f};              // this lane's share of their running sums
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int st = 0; st < n_st; ++st) {
    mbar_wait(full + st % kStages, (st / kStages) & 1);
    cp_async_wait<kStages - 2>();
    fence_proxy_async();  // this thread's reads of stage st - 1 before its refill
    __syncthreads();  // stage st arrived; every warp is done with stage st - 1
    if (st + kStages - 1 < n_st) fetch(st + kStages - 1, row_of(st + kStages - 1));
    cp_async_commit();
    const int t0 = a + st * kStageTokens + warp * kStep;  // this warp's first token
    if (t0 >= e) continue;
#ifdef PAGED_SKIP_PRODUCTS  // a probe build: the loads, the launch and the merge alone
    continue;
#endif
    const unsigned char* stage = smem + (st % kStages) * L::kStage;
    const unsigned char* Ks = stage + warp * kStep * L::kRow;
    const unsigned char* Vs = Ks + L::kRows;
    const float* kss = reinterpret_cast<const float*>(stage + 2 * L::kRows) + warp * kStep;
    const float* vss = kss + kStageTokens;

    // S = Q.K^T for the step's 16 tokens: tile nt, token 8 nt + 2 t4 + (e & 1)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (some) {
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const unsigned char* kr = Ks + (nt * 8 + g) * L::kRow;
          if constexpr (L::kInt8) {
            const unsigned w = *reinterpret_cast<const unsigned*>(kr + 16 * kb + 4 * t4) ^
                               0x80808080u;
            mma_bf16(s[nt], qa[kb], pack_exact(int8_of(w, 0), int8_of(w, 1)),
                     pack_exact(int8_of(w, 2), int8_of(w, 3)));
          } else {
            const uint2 x = *reinterpret_cast<const uint2*>(kr + 2 * (16 * kb + 4 * t4));
            mma_bf16(s[nt], qa[kb], x.x, x.y);
          }
        }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = nt * 8 + 2 * t4 + (i & 1);
        const float v = L::kInt8 ? s[nt][i] * (kss[tok] * scale) : s[nt][i] * scale;
        // another block's (or nothing) past e; a slot with no token: NEG
        s[nt][i] = t0 + tok >= e ? -INFINITY : (some ? v : kNeg);
      }

    // online softmax: the step's row max over the quad, rescale, exponentiate
    float mx0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    float mx1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
#pragma unroll
    for (int x = 1; x < 4; x *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // token t0 < e is in every step, so the new maxima are finite; the first
    // step rescales from -inf, which gives 0
    const float n0 = fmaxf(m[0], mx0), n1 = fmaxf(m[1], mx1);
    const float a0 = ex2((m[0] - n0) * kLog2e), a1 = ex2((m[1] - n1) * kLog2e);
    m[0] = n0, m[1] = n1;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      // (x - m) first: a slot's equal NEG fills give exactly 2^0
      s[nt][0] = ex2((s[nt][0] - n0) * kLog2e);
      s[nt][1] = ex2((s[nt][1] - n0) * kLog2e);
      s[nt][2] = ex2((s[nt][2] - n1) * kLog2e);
      s[nt][3] = ex2((s[nt][3] - n1) * kLog2e);
    }
    l[0] = l[0] * a0 + ((s[0][0] + s[0][1]) + (s[1][0] + s[1][1]));
    l[1] = l[1] * a1 + ((s[0][2] + s[0][3]) + (s[1][2] + s[1][3]));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= a0, acc[j][1] *= a0;
      acc[j][2] *= a1, acc[j][3] *= a1;
    }

    // P.V: the probabilities (K7b: times the V scale), rounded to bf16, are the
    // A fragments; V rows 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 of the step give
    // the B fragments, column n of tile j being d = n * NT + j
    unsigned pa[4];
    if constexpr (L::kInt8) {
      const int c0 = 2 * t4, c1 = 2 * t4 + 8;
      pa[0] = pack_bf16(s[0][0] * vss[c0], s[0][1] * vss[c0 + 1]);
      pa[1] = pack_bf16(s[0][2] * vss[c0], s[0][3] * vss[c0 + 1]);
      pa[2] = pack_bf16(s[1][0] * vss[c1], s[1][1] * vss[c1 + 1]);
      pa[3] = pack_bf16(s[1][2] * vss[c1], s[1][3] * vss[c1 + 1]);
    } else {
      pa[0] = pack_bf16(s[0][0], s[0][1]);
      pa[1] = pack_bf16(s[0][2], s[0][3]);
      pa[2] = pack_bf16(s[1][0], s[1][1]);
      pa[3] = pack_bf16(s[1][2], s[1][3]);
    }
    const unsigned char* v0 = Vs + 2 * t4 * L::kRow + g * NT * static_cast<int>(sizeof(Tkv));
#pragma unroll
    for (int jb = 0; jb < NT; jb += L::kTiles) {
      constexpr int W = (L::kRun + 3) / 4;
      unsigned w0[W], w1[W], w2[W], w3[W];
      const int off = jb * static_cast<int>(sizeof(Tkv));
      load_run<L::kRun>(v0 + off, w0);
      load_run<L::kRun>(v0 + L::kRow + off, w1);
      load_run<L::kRun>(v0 + 8 * L::kRow + off, w2);
      load_run<L::kRun>(v0 + 9 * L::kRow + off, w3);
#pragma unroll
      for (int k = 0; k < L::kTiles; ++k)
        mma_bf16(acc[jb + k], pa, pair_of<Tkv>(w0, w1, k), pair_of<Tkv>(w2, w3, k));
    }
  }
  cp_async_wait<0>();

  // the warps meet: rows' sums over the quad, then each warp's (max, sum,
  // accumulators) through shared memory, merged in warp order
#pragma unroll
  for (int x = 1; x < 4; x *= 2) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], x);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], x);
  }
  __syncthreads();  // the ring becomes the scratch
  const int per = 32 + G * D;
  float* red = reinterpret_cast<float*>(smem);
  float* mine = red + warp * per;
  if (t4 == 0) {
    mine[g] = m[0], mine[g + 8] = m[1];
    mine[16 + g] = l[0], mine[16 + g + 8] = l[1];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int d = (2 * t4 + c) * NT + j;
      if (g < G) mine[32 + g * D + d] = acc[j][c];
      if (g + 8 < G) mine[32 + (g + 8) * D + d] = acc[j][2 + c];
    }
  __syncthreads();
  const size_t part = static_cast<size_t>(h) * J + blk;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int row = i / D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[w * per + row]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = red[w * per + row];
      if (mw == -INFINITY) continue;  // a warp with no step
      const float f = ex2((mw - mx) * kLog2e);
      den += red[w * per + 16 + row] * f;
      num += red[w * per + 32 + i] * f;
    }
    if (sh.n == 1) {
      out[(static_cast<size_t>(b) * Hq + h * G) * D + i] = __float2bfloat16(num / fmaxf(den, 1e-30f));
    } else {
      parts.acc[part * G * D + i] = num;
      if (i % D == 0) {
        parts.ml[part * 2 * G + row] = mx;
        parts.ml[part * 2 * G + G + row] = den;
      }
    }
  }
  if (sh.n > 1) merge_splits<bf16>(parts, out, h, Hkv, G, D, J, sh, &last);
}

template <typename Tkv, int D>
cudaError_t launch_mma(const void* q, const void* kp, const void* vp, const float* ks,
                       const float* vs, const int* bt, const int* lens, void* out,
                       const Parts& parts, int B, int Hkv, int G, int page, int NB, float scale,
                       int window, int splits, cudaStream_t s) {
  using L = TcLayout<Tkv, D>;
  auto kernel = paged_mma<Tkv, D>;
  constexpr int bytes = L::kBytes + kStages * 8;
  if (bytes > 48 * 1024) {  // above 48 KB only after the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(Hkv, B * splits), kThreads, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const Tkv*>(kp), static_cast<const Tkv*>(vp), ks,
      vs, bt, lens, static_cast<bf16*>(out), parts, B, Hkv, G, page, NB, scale, window);
  return cudaGetLastError();
}

template <typename Tkv>
cudaError_t launch_mma_d(const void* q, const void* kp, const void* vp, const float* ks,
                         const float* vs, const int* bt, const int* lens, void* out,
                         const Parts& parts, int B, int Hkv, int G, int D, int page, int NB,
                         float scale, int window, int splits, cudaStream_t s) {
  switch (D) {
#define PAGED_D_CASE(N)                                                                     \
  case 16 * N:                                                                              \
    return launch_mma<Tkv, 16 * N>(q, kp, vp, ks, vs, bt, lens, out, parts, B, Hkv, G, page, \
                                   NB, scale, window, splits, s);
    PAGED_D_CASE(1)
    PAGED_D_CASE(2)
    PAGED_D_CASE(3)
    PAGED_D_CASE(4)
    PAGED_D_CASE(5)
    PAGED_D_CASE(6)
    PAGED_D_CASE(7)
    PAGED_D_CASE(8)
    PAGED_D_CASE(9)
    PAGED_D_CASE(10)
    PAGED_D_CASE(11)
    PAGED_D_CASE(12)
    PAGED_D_CASE(13)
    PAGED_D_CASE(14)
    PAGED_D_CASE(15)
    PAGED_D_CASE(16)
#undef PAGED_D_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- the CUDA-core path ------------------------------------------------------------

constexpr int kT = 32;       // tokens per tile (one per lane in the softmax step)
constexpr int kMaxAcc = 32;  // (q head, d) accumulators a thread can hold

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
                       const int* __restrict__ lengths, Tq* __restrict__ out, Parts parts,
                       int B, int Hq, int Hkv, int D, int page, int NB, float scale, int window) {
  constexpr bool kInt8 = std::is_same<Tkv, signed char>::value;
  constexpr int kChunk = 16 / sizeof(Tkv);  // elements in a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
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
  const int blk = blockIdx.y;
  const int J = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // This block's slot, and its share of the tokens the slot needs.
  const Share sh = block_share(lengths, B, window, NB * page, J, blk);
  const int b = sh.b;
  const int len = lengths[b];
  const int* bt = block_tables + static_cast<size_t>(b) * NB;
  int r_lo, r_hi;
  split_part(sh.lo, sh.hi, blk - sh.j0, sh.n, r_lo, r_hi);
  if (r_lo >= r_hi) {  // nothing here: weigh nothing in the merge
    empty_part<Tq>(parts, out, h, blk, Hkv, G, D, J, sh, &last);
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

  const size_t part = static_cast<size_t>(h) * J + blk;
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int idx = tid + k * kThreads;
    if (idx >= G * D) break;
    const int g = idx / D;
    if (sh.n == 1) {
      out[(static_cast<size_t>(b) * Hq + h * G) * D + idx] =
          from_f32<Tq>(acc[k] / fmaxf(l_s[g], 1e-30f));
    } else {
      parts.acc[part * G * D + idx] = acc[k];
    }
  }
  if (sh.n > 1) {
    for (int g = tid; g < G; g += kThreads) {
      parts.ml[part * 2 * G + g] = m_s[g];
      parts.ml[part * 2 * G + G + g] = l_s[g];
    }
    merge_splits<Tq>(parts, out, h, Hkv, G, D, J, sh, &last);
  }
}

template <typename Tq, typename Tkv>
cudaError_t launch(const void* q, const void* kp, const void* vp, const float* ks,
                   const float* vs, const int* bt, const int* lens, void* out,
                   const Parts& parts, int B, int Hq, int Hkv, int D, int page, int NB,
                   float scale, int window, int splits, cudaStream_t s) {
  const int G = Hq / Hkv;
  const size_t bytes = sizeof(Tkv) * 4 * kT * static_cast<size_t>(D) +
                       sizeof(float) * (static_cast<size_t>(G) * D + G * kT + 3 * G + 4 * kT);
  auto kernel = paged_attention_kernel<Tq, Tkv>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(Hkv, B * splits), kThreads, bytes, s>>>(
      static_cast<const Tq*>(q), static_cast<const Tkv*>(kp), static_cast<const Tkv*>(vp), ks,
      vs, bt, lens, static_cast<Tq*>(out), parts, B, Hq, Hkv, D, page, NB, scale, window);
  return cudaGetLastError();
}

// Block j's share of its kv head's J blocks, as both kernels take it: its slot
// and its tokens [a, e) (a >= e: none).
__global__ void paged_deal(const int* __restrict__ lengths, int* __restrict__ out, int B,
                           int window, int total) {
  const int j = blockIdx.x;
  const Share sh = block_share(lengths, B, window, total, gridDim.x, j);
  int a, e;
  split_part(sh.lo, sh.hi, j - sh.j0, sh.n, a, e);
  out[3 * j] = sh.b, out[3 * j + 1] = a, out[3 * j + 2] = e;
}

}  // namespace

// out [B, Hq, D] = paged decode attention of q [B, Hq, D] over k/v pools
// [P, page, Hkv, D] through block_tables [B, NB] and lengths [B] (int32).
// q_dtype: 0 float32, 1 bfloat16 (out has q's type). kv_dtype: 0 float32 and
// 1 bfloat16 (K7a, q of the same type; k_scale/v_scale unused), 2 int8 codes
// with float32 scales [P, page, Hkv] (K7b). window 0 = full causal. B *
// splits blocks a kv head (splits at most the 16-token steps of NB * page),
// dealt to the slots by the rows they read; with splits > 1, `partials` holds
// B * Hq * splits * (D + 2) floats for the splits' results, then B * Hkv
// arrival counters, which the launch zeroes in its stream first.
// tensor_core 1 takes the mma.sync path (bf16 q, bf16 or int8 pools,
// D % 16 == 0, D <= 256, Hq / Hkv <= 16), 0 the CUDA-core path
// ((Hq / Hkv) * D <= 4096). Pointers are 16-byte aligned.
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* k_scale, const void* v_scale,
                                      const void* block_tables, const void* lengths, void* out,
                                      void* partials, int B, int Hq, int Hkv,
                                      int D, int page, int NB, float scale, int window,
                                      int splits, int tensor_core, int q_dtype, int kv_dtype,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || D <= 0 || page <= 0 || NB <= 0 || Hq % Hkv ||
      window < 0 || splits < 1 || splits > (NB * page + kStep - 1) / kStep ||
      static_cast<long long>(B) * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1 && partials == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(partials);
  const size_t acc_n = static_cast<size_t>(B) * Hq * splits * D;
  const Parts parts{pa, pa == nullptr ? nullptr : pa + acc_n,
                    pa == nullptr ? nullptr
                                  : reinterpret_cast<unsigned*>(pa + acc_n + acc_n / D * 2)};
  if (splits > 1) {
    const cudaError_t err = cudaMemsetAsync(parts.count, 0, sizeof(unsigned) * B * Hkv, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (tensor_core) {
    if (q_dtype != kBFloat16 || D % 16 || D > 256 || G > 16)
      return static_cast<int>(cudaErrorInvalidValue);
#define MMA_ARGS q, k_pool, v_pool, ks, vs, bt, lens, out, parts, B, Hkv, G, D, page, NB, scale, \
                 window, splits, s
    if (kv_dtype == 1) return static_cast<int>(launch_mma_d<bf16>(MMA_ARGS));
    if (kv_dtype == 2) return static_cast<int>(launch_mma_d<signed char>(MMA_ARGS));
#undef MMA_ARGS
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (G * D > kMaxAcc * kThreads) return static_cast<int>(cudaErrorInvalidValue);
#define PAGED_ARGS q, k_pool, v_pool, ks, vs, bt, lens, out, parts, B, Hq, Hkv, D, page, NB, scale, \
                   window, splits, s
  if (q_dtype == kFloat32 && kv_dtype == 0) return static_cast<int>(launch<float, float>(PAGED_ARGS));
  if (q_dtype == kBFloat16 && kv_dtype == 1) return static_cast<int>(launch<bf16, bf16>(PAGED_ARGS));
  if (q_dtype == kFloat32 && kv_dtype == 2)
    return static_cast<int>(launch<float, signed char>(PAGED_ARGS));
  if (q_dtype == kBFloat16 && kv_dtype == 2)
    return static_cast<int>(launch<bf16, signed char>(PAGED_ARGS));
#undef PAGED_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// out [B * splits, 3] int32: for each block of a kv head, the slot it serves
// and its tokens [a, e), as the kernels deal them (for tests).
extern "C" int paged_attention_deal(const void* lengths, void* out, int B, int window, int total,
                                    int splits, void* stream) {
  if (B <= 0 || total <= 0 || window < 0 || splits < 1 ||
      static_cast<long long>(B) * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  paged_deal<<<B * splits, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lengths), static_cast<int*>(out), B, window, total);
  return static_cast<int>(cudaGetLastError());
}
