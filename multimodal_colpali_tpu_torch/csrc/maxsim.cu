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
// (maxsim.py:239); each code is exact in bfloat16; the scale multiplies the
// dot before the mask and the max (maxsim.py:256), so it cannot leave the max.
//
// On the TPU the grid ran in order and one program scored a block of pages
// against all queries. Here blocks run in parallel in no order, so a page is
// scored whole by one block, which writes out[:, p] itself: no reduction
// crosses blocks. Each row's max is exact whatever the order of the tokens,
// each dot is summed in one order wherever its row sits, and each query's sum
// is formed by one thread in row order, so a repeated call gives the same
// bits, a page scores the same alone as in the whole corpus, and a query the
// same alone as in a batch. The wrapper (ops/maxsim.py, launch_plan) gives a
// tensor-core launch whole queries of at most 256 rows in all, or 256-row
// windows of one longer query, and a CUDA-core launch up to 1,024 queries.
//
// What bounds it on an H100 (phase 2's corpus: 4,096 pages of up to 1,030
// tokens of 128, 2.1 M of them valid; PERF.md, section 6). A bf16 launch of
// R rows does R FLOP a byte of page read. The store's one query (32 rows) is
// far under the card's ridge and bound by the 540 MB of bf16 pages (0.160
// ms; int8 codes and scales, 0.082 ms). Phase 2's four queries (128 rows)
// sit at the ridge of mma.sync, which is what this kernel issues: ~70 GFLOP
// against the same bytes. A sweep's 120 queries (3,840 rows, 15 launches of
// 256) do 2.1 TFLOP (2.1 ms at the bf16 tensor-core peak) against 15 reads
// of the corpus (2.4 ms). Measured (maxsim_sweep, graph replays): the loads
// alone (-DMAXSIM_SKIP_PRODUCTS) take 0.17-0.18 ms (bf16) and 0.10-0.13 ms
// (int8) at every batch, so the store's query is near its bound, and four
// queries or more are bound by the products, which mma.sync runs at ~0.3-0.4
// PFLOP/s here. The full rate needs wgmma. A wgmma form of this kernel (the
// queries as the B operand, written once a launch into a swizzled tile; each
// stage's tokens as register A fragments, so K4 widens each code once) was
// built, bit-exact, and came within ~10% of this one either way in probe
// runs: ptxas serializes every wgmma of a kernel with a loop whose trip
// count differs between threads (ptxas info C7518), and with one block of
// two warpgroups an SM, 168 registers and a loader warp, a warpgroup's
// loads, products and folds still ran one after the other (ROADMAP).
//
// Two paths, chosen by the wrapper:
//
// - Tensor cores, maxsim_mma (bf16 pages or int8 codes, DIM % 16 == 0, DIM <=
//   128: ColPali's, ColSmol's and ColFlor's 128). Persistent blocks of 8
//   warps, as many as fit the card at once, take pages in order from a
//   counter in the call's own scratch (zeroed in its stream); thread 0 claims
//   pages and keeps stages of 128 tokens of 128 (32 KB of bf16, 16 KB of
//   int8) in flight in a ring of 3 on mbarriers, across page boundaries. A
//   page's valid tokens are one contiguous run, so a stage is one bulk copy
//   (cp.async.bulk) of its n * DIM elements: only the d_len valid tokens are
//   read, and an empty page reads nothing. K4's scales come by a second bulk
//   copy of the 16-byte-aligned run around them, clipped to the tensor; the
//   few floats the clip leaves at the tensor's end come by plain loads.
//   Products on mma.sync m16n8k16 in float32: a warp holds 32 query rows (two
//   m16 tiles of A fragments, built once a launch from device memory; K4
//   rounds its float32 query to bf16 there) and takes 16 tokens at a time as
//   two n8 B tiles read straight from the unpadded stage, the contracted
//   dimension permuted so that a lane reads whole 16-byte runs (the 8 tokens
//   of a read share banks two by two, which measured faster than reading
//   odd tokens' runs in swapped order and swapping them back in registers).
//   The launch's rows take 1, 2, 4 or 8 row groups of 32 (its B * NQ rounded
//   up), and the 8 / groups warps of a row group split each stage's tokens,
//   so the store's one query spends all 8 warps on its 32 rows, not on 256;
//   an m16 tile with no row < q_len is skipped. K4 widens its codes exactly
//   to bf16 (two LOP3 and a bf16x2 add a pair of codes): in registers, or,
//   at 4 or 8 row groups, which would widen each token that many times, once
//   a stage into bf16 rows in shared memory by the warps that share those
//   tokens, on a named barrier of their own. K4 multiplies each token's scale
//   into its dot, the last stage of a page masks tokens >= d_len with -1e30,
//   and each row's max stays in registers across stages; at the end of a page
//   it is reduced over the quad's lanes and the warps that shared the row.
// - CUDA cores, maxsim_kernel (float32 pages, other DIMs, a multiple of 8 up
//   to 128; the float32 embeddings of score_results and score_multi_vector,
//   as in the JAX package): up to 128 query rows in registers (one row a pair
//   of threads, DIM floats each), the page's valid tokens through shared
//   memory in tiles of 64 converted to float32 once on load (K4 stages the
//   tile's scales beside it); all threads of a warp read the same token, so
//   the reads are broadcasts; the two threads of a row take the even and the
//   odd tokens. More than 128 rows take several passes in one launch (one
//   launch of 30 passes at 120 queries measured 3% faster than 15 launches
//   of 2). Bound by the float32 cores' issue rate at every shape.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kMask = -1e30f;

// ---- CUDA cores -------------------------------------------------------------

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

// ---- tensor cores -----------------------------------------------------------

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32 * kWarps;  // R: query rows a pass, two m16 tiles a warp
// A ring of 3 stages of 32 KB, two blocks an SM (PERF.md, section 6: 2 or 4
// stages, and one block an SM with more registers, measured no faster)
constexpr int kStages = 3;
constexpr int kStageBytes = 32 * 1024;
constexpr int kMinBlocks = 2;

// Token rows of DIM elements of EB bytes (bf16 pages or widened codes, 2;
// int8 codes, 1) as the products read them from shared memory: lane quad t4
// reads kElems dims of a row at once (its part of a group of 4 * kElems),
// kGroups groups a row, kSteps k16 steps a group. The dims a lane reads do
// not depend on EB, so K4's two ways to widen its codes sum each dot in one
// order. (16 dims a lane, for int8 rows one 16-byte read, measured slower in
// probe builds: the widened rows then take two.)
template <int EB, int DIM>
struct Rows {
  static constexpr bool kCodes = EB == 1;
  static constexpr int kRowBytes = DIM * EB;
  static constexpr int kElems = DIM % 32 == 0 ? 8 : 4;
  static constexpr int kChunk = kElems * EB;
  static constexpr int kWords = kChunk / 4;
  static constexpr int kGroups = DIM / (4 * kElems);
  static constexpr int kSteps = kElems / 4;
  static constexpr int KB = DIM / 16;
  static_assert(KB == kGroups * kSteps, "the groups cover DIM");
};

// The ring of stages of TD rows and, for K4, a stage's codes widened to bf16.
template <typename TD, int DIM>
struct Layout {
  static constexpr bool kInt8 = sizeof(TD) == 1;
  static constexpr int KB = DIM / 16;
  static constexpr int kRowBytes = DIM * static_cast<int>(sizeof(TD));
  // tokens a stage: kStageBytes of bf16 rows, a multiple of 128 (8 warps x
  // two n8 tiles), 128 to 512; K4's ring holds them as codes (half the bytes)
  static constexpr int kFit = kStageBytes / (2 * DIM) / 128 * 128;
  static constexpr int kTile = kFit < 128 ? 128 : (kFit > 512 ? 512 : kFit);
  static constexpr int kStage = kTile * kRowBytes;
  static constexpr int kScales = kInt8 ? kStages * (kTile + 4) * 4 : 0;  // + 16-byte rounding
  static constexpr int kWide = kInt8 ? kTile * DIM * 2 : 0;             // the widened stage
  static constexpr int kSmem = kStages * kStage + kScales + kWide + kStages * 8;
};

// kChunk bytes of shared memory at p (aligned to them) into words.
template <int CH>
__device__ __forceinline__ void load_chunk(const unsigned char* p, unsigned (&w)[CH / 4]) {
  if constexpr (CH == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (CH == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x, w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  }
}

// Four int8 codes (dims d0 .. d0 + 3, in byte order) as two bf16 pairs,
// exactly: b0 = (d0, d0 + 2), b1 = (d0 + 1, d0 + 3), which the widened row
// keeps in that order (the products read them as any bf16 row). A byte b of
// code c, with its top bit h and low bits l, gives the bf16 128 + l (0x4300 |
// l) and the bf16 -128 - 128 h (0xC300, or 0xC380 = -256), whose sum is c and
// exact in bf16: two LOP3 and one bf16x2 add a pair, no shuffle of bytes.
__device__ __forceinline__ void widen_codes(unsigned x, unsigned& b0, unsigned& b1) {
  auto pair = [](unsigned y) {  // the codes in bytes 0 and 2 of y
    const unsigned v = (y & 0x007F007Fu) | 0x43004300u, w = (y & 0x00800080u) ^ 0xC300C300u;
    const __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                     *reinterpret_cast<const __nv_bfloat162*>(&w));
    return *reinterpret_cast<const unsigned*>(&r);
  };
  b0 = pair(x);
  b1 = pair(x >> 8);
}

// The A fragment words of a query row for dims d0 .. d0 + 3: lo for k slots
// 2 t4, 2 t4 + 1 and hi for 2 t4 + 8, 2 t4 + 9, in the order the B fragment
// gives them (K1: (d0, d0 + 1), (d0 + 2, d0 + 3); K4's codes: (d0, d0 + 2),
// (d0 + 1, d0 + 3), widen_codes). K4's float32 query is rounded to bf16,
// nearest even, as torch's .to(). Each word is loaded or made alone, so that
// the four of a fragment can be allocated to the four consecutive registers
// mma.sync reads, with no moves.
__device__ __forceinline__ unsigned q_word(const __nv_bfloat16* row, int d0, int hi) {
  return *reinterpret_cast<const unsigned*>(row + d0 + 2 * hi);
}
__device__ __forceinline__ unsigned q_word(const float* row, int d0, int hi) {
  return pack_bf16(row[d0 + hi], row[d0 + hi + 2]);
}

// One stage's products for one warp: its `tiles` n8 tiles of tokens (rows as
// RL says: bf16, or int8 codes widened in registers) from tok_first, two at a
// time (16 tokens: four independent accumulator chains with both m16 tiles),
// into the running row maxima mx; kScaled (K4): each token's dot times its
// scale sc[token] first. MT: which of the warp's two m16 tiles hold a valid
// row (bit 0, bit 1); a tile without is skipped. B fragments come a 16-byte
// chunk of each token at a time, so few registers hold them; the 8 tokens of
// a load share banks two by two (rows of 256 or 128 bytes), which cost less
// than reading odd tokens' chunks in swapped order and swapping them back in
// registers.
template <typename RL, int MT, bool kScaled>
__device__ __forceinline__ void stage_products(const unsigned (&qa)[2][RL::KB][4],
                                               const unsigned char* tile, const float* sc,
                                               int n, int tok_first, int tiles, int g, int t4,
                                               float (&mx)[2][2]) {
  for (int j = 0; j < tiles; j += 2) {
    const int tok0 = tok_first + j * 8;
    if (tok0 >= n) break;
    const unsigned char* src = tile + (tok0 + g) * RL::kRowBytes + t4 * RL::kChunk;
    float c[2][2][4] = {};  // [n8 tile][m16 tile]
#pragma unroll
    for (int u = 0; u < RL::kGroups; ++u) {
      unsigned w[2][RL::kWords];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        load_chunk<RL::kChunk>(src + nt * 8 * RL::kRowBytes + u * 4 * RL::kChunk, w[nt]);
#pragma unroll
      for (int s = 0; s < RL::kSteps; ++s) {
        unsigned b[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          if constexpr (RL::kCodes) {
            widen_codes(w[nt][s], b[nt][0], b[nt][1]);
          } else {
            b[nt][0] = w[nt][2 * s];
            b[nt][1] = w[nt][2 * s + 1];
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            if (MT >> mt & 1) mma_bf16(c[nt][mt], qa[mt][u * RL::kSteps + s], b[nt][0], b[nt][1]);
      }
    }
    const bool edge = tok0 + 16 > n;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c0 = tok0 + nt * 8 + 2 * t4;  // this lane's two tokens: c0, c0 + 1
      float2 scale = make_float2(1.f, 1.f);  // (sc need not be 8-byte aligned)
      if constexpr (kScaled) scale = make_float2(sc[c0], sc[c0 + 1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (!(MT >> mt & 1)) continue;
        float* x = c[nt][mt];
        if constexpr (kScaled) {
          x[0] *= scale.x, x[1] *= scale.y, x[2] *= scale.x, x[3] *= scale.y;
        }
        if (edge) {
          if (c0 >= n) x[0] = x[2] = kMask;
          if (c0 + 1 >= n) x[1] = x[3] = kMask;
        }
        mx[mt][0] = fmaxf(mx[mt][0], fmaxf(x[0], x[1]));
        mx[mt][1] = fmaxf(mx[mt][1], fmaxf(x[2], x[3]));
      }
    }
  }
}

// stage_products for whichever of the warp's m16 tiles hold a valid row.
template <typename RL, bool kScaled>
__device__ __forceinline__ void warp_products(const bool (&act)[2],
                                              const unsigned (&qa)[2][RL::KB][4],
                                              const unsigned char* tile, const float* sc, int n,
                                              int tok_first, int tiles, int g, int t4,
                                              float (&mx)[2][2]) {
  if (act[0] && act[1]) {
    stage_products<RL, 3, kScaled>(qa, tile, sc, n, tok_first, tiles, g, t4, mx);
  } else if (act[0]) {
    stage_products<RL, 1, kScaled>(qa, tile, sc, n, tok_first, tiles, g, t4, mx);
  } else if (act[1]) {
    stage_products<RL, 2, kScaled>(qa, tile, sc, n, tok_first, tiles, g, t4, mx);
  }
}

// The A fragments of a warp's m16 tile (rows ra, ra + 8; zeros past r_end),
// in the order of contracted dims that RL's B fragments take.
template <typename RL, typename TQ>
__device__ __forceinline__ void load_a(unsigned (&qa)[RL::KB][4], const TQ* q, int ra,
                                       int r_end, int t4, int DIM) {
  const TQ* qa_row = q + static_cast<size_t>(ra) * DIM;
  const TQ* qb_row = qa_row + 8 * DIM;
#pragma unroll
  for (int kb = 0; kb < RL::KB; ++kb) {
    const int d0 = (kb / RL::kSteps) * 4 * RL::kElems + t4 * RL::kElems + 4 * (kb % RL::kSteps);
    const bool la = ra < r_end, lb = ra + 8 < r_end;
    qa[kb][0] = la ? q_word(qa_row, d0, 0) : 0u;
    qa[kb][1] = lb ? q_word(qb_row, d0, 0) : 0u;
    qa[kb][2] = la ? q_word(qa_row, d0, 1) : 0u;
    qa[kb][3] = lb ? q_word(qb_row, d0, 1) : 0u;
  }
}

// Contracted dimension: k16 step kb = u * kSteps + s of group u; lane quad t4
// holds, for rows g and g + 8 of A and token g of B, the dims d0 .. d0 + 3 with
// d0 = u * 4 * kElems + t4 * kElems + 4 s: its k slots 2 t4, 2 t4 + 1 (a0 / a1,
// b0) take d0, d0 + 1 (K4: d0, d0 + 2), and 2 t4 + 8, 2 t4 + 9 (a2 / a3, b1)
// take d0 + 2, d0 + 3 (K4: d0 + 1, d0 + 3). Every step's 16 slots are 16
// distinct dims and the steps cover DIM, so the product is the dot product,
// summed in another order than the plain one, and in the same order for a
// row wherever it sits in a launch.
//
// A launch scores rows [r0, r0 + rows) of its B queries (rows <= 256; r0 > 0
// only for a query of more than 256 rows, whose earlier rows' sum the launch
// before it left in out). Persistent blocks take pages in order from the
// counter *next_page (zeroed in the launch's stream); thread 0 is the producer:
// it claims pages and streams each one's stages (an empty page is one stage of
// no tokens) into the ring, running kStages - 1 stages ahead across pages,
// with each stage's page, tokens, scale offset and last-stage flag in meta.
template <typename TQ, typename TD, int DIM>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
maxsim_mma(const TQ* __restrict__ q, const TD* __restrict__ d,
           const float* __restrict__ d_scale, const int* __restrict__ q_lens,
           const int* __restrict__ d_lens, float* __restrict__ out, int* __restrict__ next_page,
           int B, int NQ, int r0, int P, int NT) {
  using L = Layout<TD, DIM>;
  constexpr int KB = L::KB;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float rowmax[kRows];  // [token group][row of the launch]
  __shared__ int4 meta[kStages];   // page (-1: no more), tokens, scale offset, last
  float* ring_scale = reinterpret_cast<float*>(smem + kStages * L::kStage);
  unsigned char* wide = smem + kStages * L::kStage + L::kScales;  // K4's widened stage
  unsigned long long* full = reinterpret_cast<unsigned long long*>(wide + L::kWide);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // a fragment's row (token) and column pair
  const int rows = min(kRows, B * NQ - r0);
  if (tid < kStages) mbar_init(full + tid, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // the producer's place in its stream of stages: page, stage, the page's
  // stages and tokens (thread 0 only; in shared memory, not registers)
  __shared__ int prod[4];
  if (tid == 0) prod[0] = prod[1] = prod[2] = prod[3] = 0;
  auto produce = [&](int item) {
    int fp = prod[0], fst = prod[1], fnst = prod[2], fdl = prod[3];
    if (fp >= P) return;  // the end is in the ring already
    const int slot = item % kStages;
    if (fst == fnst) {  // the next page
      fp = atomicAdd(next_page, 1);
      fst = 0;
      if (fp < P) {
        fdl = min(max(d_lens[fp], 0), NT);
        fnst = max(1, (fdl + L::kTile - 1) / L::kTile);
      }
    }
    prod[0] = fp, prod[1] = fst + 1, prod[2] = fnst, prod[3] = fdl;
    if (fp >= P) {
      meta[slot] = make_int4(-1, 0, 0, 0);
      mbar_arrive(full + slot);
      return;
    }
    const int t0 = fst * L::kTile, n = max(0, min(L::kTile, fdl - t0));
    int off = 0, bytes = n * L::kRowBytes, sc_a = 0, sc_bulk = 0;
    if constexpr (L::kInt8) {
      // the 16-byte-aligned run of scales around [first, last), never past
      // the tensor: what the rounding would add at its end comes by plain loads
      const long long first = static_cast<long long>(fp) * NT + t0, last = first + n;
      const long long total = static_cast<long long>(P) * NT;
      const long long a = first & ~3ll, e = min((last + 3) & ~3ll, total & ~3ll);
      off = static_cast<int>(first - a);
      sc_a = static_cast<int>(a - static_cast<long long>(fp) * NT);
      sc_bulk = n > 0 && e > a ? static_cast<int>(e - a) * 4 : 0;
      float* dst = ring_scale + slot * (L::kTile + 4);
      for (long long i = max(e, a); i < last; ++i) dst[i - a] = d_scale[i];
      bytes += sc_bulk;
    }
    meta[slot] = make_int4(fp, n, off, fst + 1 == fnst);
    if (n > 0) {
      mbar_arrive_tx(full + slot, bytes);
      bulk_load(smem + slot * L::kStage, d + (static_cast<size_t>(fp) * NT + t0) * DIM,
                n * L::kRowBytes, full + slot);
      if constexpr (L::kInt8) {
        if (sc_bulk)
          bulk_load(ring_scale + slot * (L::kTile + 4),
                    d_scale + static_cast<size_t>(fp) * NT + sc_a, sc_bulk, full + slot);
      }
    } else {
      mbar_arrive(full + slot);
    }
  };
  if (tid == 0)
    for (int i = 0; i < kStages - 1; ++i) produce(i);

  // rows of the launch: 1, 2, 4 or 8 row groups of 32; the warps of a row
  // group split each stage's tokens
  const int groups = rows <= 32 ? 1 : rows <= 64 ? 2 : rows <= 128 ? 4 : 8;
  const int rg = warp % groups, tg = warp / groups;
  const int tiles = L::kTile / 8 * groups / kWarps;  // n8 tiles a warp a stage

  // A fragments of the warp's two m16 tiles, once a launch (a tile with no
  // valid row is skipped). K4 widens its codes in registers, each warp the
  // tokens it takes, or, when 4 or 8 row groups would widen every token as
  // many times, once a stage into bf16 rows in shared memory by the warps of
  // each token group.
  using Wide = Rows<2, DIM>;
  using Ring = Rows<static_cast<int>(sizeof(TD)), DIM>;
  const bool wide_pass = L::kInt8 && groups >= 4;
  unsigned qa[2][KB][4];
  bool act[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int ra = r0 + rg * 32 + mt * 16 + g, rb = ra + 8;
    const int r_end = r0 + rows;
    auto valid = [&](int r) {
      return r < r_end && r % NQ < min(max(q_lens[r / NQ], 0), NQ);
    };
    act[mt] = __any_sync(0xffffffffu, valid(ra) || valid(rb));
    load_a<Wide>(qa[mt], q, ra, act[mt] ? r_end : ra, t4, DIM);  // zeros: no valid row
  }

  float mx[2][2] = {{kMask, kMask}, {kMask, kMask}};  // rows g, g + 8 of each tile
  for (int k = 0;; ++k) {
    const int slot = k % kStages;
    mbar_wait(full + slot, (k / kStages) & 1);
    fence_proxy_async();  // this thread's reads of stage k - 1 before its refill
    __syncthreads();      // stage k arrived; every warp is done with stage k - 1
    if (tid == 0) produce(k + kStages - 1);
    const int4 m = meta[slot];
    if (m.x < 0) break;
#ifndef MAXSIM_SKIP_PRODUCTS  // a probe build: the copies, the waits and the launch alone
    const unsigned char* tile = smem + slot * L::kStage;
    const float* sc = ring_scale + slot * (L::kTile + 4) + m.z;
    const int t0 = tg * tiles * 8;
    if constexpr (!L::kInt8) {
      if (m.y > 0) warp_products<Wide, false>(act, qa, tile, sc, m.y, t0, tiles, g, t4, mx);
    } else if (!wide_pass) {
      if (m.y > 0) warp_products<Ring, true>(act, qa, tile, sc, m.y, t0, tiles, g, t4, mx);
    } else {
      // the warps of a token group widen its tokens of the stage, 8 codes a
      // thread at a time, and meet on a barrier of their own before their
      // products read them
      const int lo = t0 * DIM / 8, hi = min(m.y, t0 + tiles * 8) * DIM / 8;
      for (int i = lo + rg * 32 + lane; i < hi; i += groups * 32) {
        const uint2 x = *reinterpret_cast<const uint2*>(tile + 8 * i);
        uint4 y;
        widen_codes(x.x, y.x, y.y);
        widen_codes(x.y, y.z, y.w);
        *reinterpret_cast<uint4*>(wide + 16 * i) = y;
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + tg), "r"(groups * 32) : "memory");
      if (m.y > 0) warp_products<Wide, true>(act, qa, wide, sc, m.y, t0, tiles, g, t4, mx);
    }
#endif
    if (!m.w) continue;
    // the page's last stage: each row's max over its quad, then over the
    // warps of its row group, and each query's sum in row order
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = mx[mt][h];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        if (t4 == 0) rowmax[tg * groups * 32 + rg * 32 + mt * 16 + h * 8 + g] = v;
        mx[mt][h] = kMask;
      }
    __syncthreads();  // the next writes of rowmax come after stage k + 1's barrier
    const int p = m.x, r_end = r0 + rows, span = groups * 32;
    for (int b = r0 / NQ + tid; b <= (r_end - 1) / NQ; b += kThreads) {
      const int lo = max(b * NQ, r0);
      const int hi = min(b * NQ + min(max(q_lens[b], 0), NQ), r_end);
      float* o = out + static_cast<size_t>(b) * P + p;
      float sum = lo > b * NQ ? *o : 0.f;  // a query's earlier rows: the launch before
      for (int r = lo; r < hi; ++r) {
        float v = rowmax[r - r0];
        for (int t = 1; t < kWarps / groups; ++t) v = fmaxf(v, rowmax[t * span + r - r0]);
        sum += v;
      }
      *o = sum;
    }
  }
}

// Blocks of maxsim_mma that fit the card at once (cached per instantiation).
template <typename TQ, typename TD, int DIM>
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, maxsim_mma<TQ, TD, DIM>, kThreads,
                                                  Layout<TD, DIM>::kSmem);
    blocks = max(1, sms * per_sm);
  }
  return blocks;
}

template <typename TQ, typename TD, int DIM>
cudaError_t launch_mma(const void* q, const void* d, const float* d_scale, const int* q_lens,
                       const int* d_lens, float* out, int* next_page, int B, int NQ, int r0,
                       int P, int NT, cudaStream_t stream) {
  using L = Layout<TD, DIM>;
  auto kernel = maxsim_mma<TQ, TD, DIM>;
  if (L::kSmem > 48 * 1024) {  // above 48 KB only after the opt-in
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaMemsetAsync(next_page, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int blocks = min(P, resident_blocks<TQ, TD, DIM>());
  kernel<<<blocks, kThreads, L::kSmem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TD*>(d), d_scale, q_lens, d_lens, out,
      next_page, B, NQ, r0, P, NT);
  return cudaGetLastError();
}

template <typename TQ, typename TD>
cudaError_t launch_mma_dim(const void* q, const void* d, const float* d_scale,
                           const int* q_lens, const int* d_lens, float* out, int* next_page,
                           int B, int NQ, int r0, int P, int NT, int DIM, cudaStream_t stream) {
  switch (DIM) {
#define MAXSIM_MMA_CASE(N)                                                              \
  case N:                                                                               \
    return launch_mma<TQ, TD, N>(q, d, d_scale, q_lens, d_lens, out, next_page, B, NQ, \
                                 r0, P, NT, stream);
    MAXSIM_MMA_CASE(16)
    MAXSIM_MMA_CASE(32)
    MAXSIM_MMA_CASE(48)
    MAXSIM_MMA_CASE(64)
    MAXSIM_MMA_CASE(80)
    MAXSIM_MMA_CASE(96)
    MAXSIM_MMA_CASE(112)
    MAXSIM_MMA_CASE(128)
#undef MAXSIM_MMA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// K1: scores B queries against P pages into out [B, P] (float32, row-major).
// q [B, NQ, DIM] and d [P, NT, DIM] contiguous, of the type named by dtype;
// q_lens [B] and d_lens [P] int32. tensor_core: bf16 with DIM % 16 == 0 on
// maxsim_mma, rows [r0, r0 + 256) of the queries (d 16-byte aligned;
// next_page one int of scratch); else DIM a multiple of 8 up to 128 on
// maxsim_kernel, every row (r0 and next_page unused; B * 4 bytes of
// per-query sums must fit in shared memory beside the tile).
extern "C" int maxsim_launch(const void* q, const void* d, const int* q_lens,
                             const int* d_lens, float* out, int* next_page, int B, int NQ,
                             int r0, int P, int NT, int DIM, int dtype, int tensor_core,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tensor_core) {
    err = dtype == kBFloat16
              ? tc::launch_mma_dim<__nv_bfloat16, __nv_bfloat16>(
                    q, d, nullptr, q_lens, d_lens, out, next_page, B, NQ, r0, P, NT, DIM, s)
              : cudaErrorInvalidValue;
  } else if (dtype == kBFloat16) {
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
// [P, NT] (16-byte aligned on the tensor-core path); q [B, NQ, DIM] is
// float32 and is rounded to bfloat16 in the kernel.
extern "C" int maxsim_int8_launch(const float* q, const signed char* codes,
                                  const float* scales, const int* q_lens, const int* d_lens,
                                  float* out, int* next_page, int B, int NQ, int r0, int P,
                                  int NT, int DIM, int tensor_core, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core)
    return static_cast<int>(tc::launch_mma_dim<float, signed char>(
        q, codes, scales, q_lens, d_lens, out, next_page, B, NQ, r0, P, NT, DIM, s));
  return static_cast<int>(launch_dim<float, signed char, true>(
      q, codes, scales, q_lens, d_lens, out, B, NQ, P, NT, DIM, s));
}
