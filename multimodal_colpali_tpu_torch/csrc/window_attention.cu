// K6: attention over independent windows, no mask, float32 softmax.
//
// Replaces the TPU kernel multimodal_colpali_tpu/ops/window_attention.py::_kernel
// (pl.pallas_call at window_attention.py:79, wrapper window_attention):
//
//   out[n, i] = sum_t round_v(softmax_t(scale * <q[n, i], k[n, t]>)) v[n, t]
//
// on [N, S, D] tensors (float32 or bfloat16), N = batch x windows x heads.
// Logits, the softmax and the P.V sums are float32; the probabilities are
// rounded to v's type before P.V and the result to q's type, as in the TPU
// kernel and the einsum path (window_attention.py:40, :55-58).
//
// What bounds it on an H100. ColFlor's DaViT runs it at S = 144 (12 x 12
// windows) and D = 32: each window's q, k and v (27.6 KB in bf16) are read once
// and its output written once, for 4 * S * S * D = 2.65 MFLOP, about 73
// operations a byte: below the ~295 where the tensor cores would be the limit,
// so the kernel is bound by its bytes (the 144 x 144 float32 logits never leave
// the SM). What decides its speed is keeping enough windows in flight.
//
// Design. Three paths:
//   - bfloat16, S <= 144 and D <= 32 (ColFlor: every DaViT stage has 12 x 12
//     windows and head_dim 32): window_attention_ring, persistent blocks of
//     three consumer warps and a loader warp over a ring of two stages, each
//     stage one window's Q, K and V (27.6 KB). The loader's TMA boxes for the
//     next window are in flight while the consumers compute the current one:
//     by Little's law the card needs ~25 KB outstanding an SM (3.35 TB/s over
//     132 SMs, ~1 us of latency); four resident blocks an SM (56 KB of
//     shared memory and 128 registers a thread each) keep four windows
//     loading while four compute, ~110 KB in flight. Products on
//     mma.sync m16n8k16 with the logits, probabilities and output of a 16-row
//     tile in registers (wgmma's 64-row tiles would pad 144 rows to 192 for a
//     kernel bound by its bytes); the softmax by 2^x and one reciprocal a
//     row; the output staged over Q's rows and written by 16-byte stores.
//   - bfloat16, other shapes (S <= 512, D <= 128): one block a window, its
//     tiles copied by cp.async, zero-padded to SP = S and DP = D rounded up to
//     16; 4 warps on 16 x 16 x 16 WMMA tiles through a [16, SP] float32 logit
//     strip in shared memory per warp; the softmax runs in registers and
//     writes the bf16 probabilities over the row's own logits; P.V
//     accumulates in registers and leaves through the strip, rows past S and
//     columns past D masked.
//   - float32: the tensor cores have no float32 path that keeps 1e-5, so one
//     warp takes one query row at a time on the CUDA cores: lanes over keys
//     for the logits (k rows padded to D + 1 floats: no bank conflicts), a
//     warp-wide softmax, lanes over D for P.V.
// A window whose tiles do not fit in the card's shared memory is refused
// (cudaErrorInvalidConfiguration), never cut.
#include <mma.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// Shared-memory layout of the bf16 kernel: Q, K, V tiles [SP][LD] bf16, then
// per warp a [16][LDL] float32 strip that holds a row tile's logits, then its
// bf16 probabilities in place (row r of P, stride 2 * LDL, starts where row r
// of the logits does), then its output. Every WMMA pointer stays 32-byte
// aligned.
constexpr int kMaxPer = 16;  // logits a lane holds while its row is rewritten: S <= 512
constexpr int kMaxDT = 8;    // output tiles a warp holds: D <= 128
struct Bf16Layout {
  int SP, DP, LD, LDL;
  __host__ __device__ Bf16Layout(int S, int D)
      : SP(round16(S)), DP(round16(D)), LD(DP + 8), LDL((SP > DP ? SP : DP) + 4) {}
  __host__ __device__ size_t tile() const { return static_cast<size_t>(SP) * LD; }  // elements
  __host__ __device__ size_t strip_bytes() const { return 16ull * LDL * 4; }
  __host__ __device__ size_t bytes() const { return 3 * tile() * 2 + kWarps * strip_bytes(); }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One window's [S, D] rows into a zero-padded [SP][LD] tile (bf16): cp.async
// for whole 16-byte chunks (the caller waits), element copies otherwise.
__device__ void load_tile_bf16(bf16* dst, const bf16* src, int S, int D, int SP, int DP, int LD,
                               bool vec) {
  const bf16 zero = __float2bfloat16(0.f);
  const int n = blockDim.x;
  if (vec) {  // D % 8 == 0 and 16-byte aligned rows: whole chunks
    for (int c = threadIdx.x; c < S * D / 8; c += n) {
      const int e = c * 8;
      cp_async16(dst + (e / D) * LD + e % D, src + e, true);
    }
  } else {
    for (int e = threadIdx.x; e < S * D; e += n) dst[(e / D) * LD + e % D] = src[e];
  }
  if (DP > D)  // the padding: columns past D of the real rows, then the rows past S
    for (int e = threadIdx.x; e < S * (DP - D); e += n)
      dst[(e / (DP - D)) * LD + D + e % (DP - D)] = zero;
  for (int e = threadIdx.x; e < (SP - S) * DP; e += n) dst[(S + e / DP) * LD + e % DP] = zero;
}

// ---- The ring kernel: bf16, S <= 144 and D <= 32 (every ColFlor DaViT stage).
//
// Persistent blocks of kConsumers consumer warps and one loader warp; block b
// takes windows b, b + gridDim.x, ... in that order. A stage of the ring holds
// one window's Q, K and V as [144][32] bf16 tiles, rows of 64 bytes; columns
// past D and rows past S are zeros (V's must be finite: P is 0 there). The
// loader's lane 0 copies a window into a stage by three TMA boxes {32, S}
// (columns past D read as zeros) in the 64-byte swizzle, which puts the
// 16-byte chunk c of row r at chunk c ^ ((r >> 1) & 3), so the eight rows an
// ldmatrix reads fall on eight different bank groups; the boxes land on the
// stage's `full` barrier. Odd inputs (a pointer that is not 16-byte aligned,
// D % 8 != 0) are a choice of shape: the consumer warps copy them element by
// element into the same tiles, and the loader warp leaves. Probe builds
// (window_sweep --variant) only: -DWINDOW_LOADS_ONLY (the copies alone),
// -DWINDOW_SKIP_SOFTMAX, -DWINDOW_SKIP_STORE.
constexpr int kRingStages = 2;
constexpr int kConsumers = 3;                        // consumer warps
constexpr int kRingMinBlocks = 4;  // resident blocks an SM that ptxas leaves registers for:
                                   // all that shared memory holds, 128 registers a thread
constexpr int kRingThreads = (kConsumers + 1) * 32;  // and the loader warp
constexpr int kRingS = 144, kRingD = 32;             // the largest window the ring takes
constexpr int kRowBytes = kRingD * 2;
constexpr int kTileBytes = kRingS * kRowBytes;       // 9,216: a multiple of the swizzle's 512
constexpr int kStageBytes = 3 * kTileBytes;
constexpr int kRingSmem = kRingStages * kStageBytes + 2 * kRingStages * 8 + 1024;  // + alignment
static_assert(kRingStages >= 2, "the element path alternates stages");

// Byte offset of the 16-byte chunk c of row r in a (512-byte aligned) tile.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kRowBytes + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void consumers_sync() {  // the consumer warps alone
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 32) : "memory");
}

// kFull (S == 144 and c > 0, every ColFlor window): no key is masked, and the
// scale goes into the exponent's fmaf, 2^(c l - max(c l)) with max(c l) = c
// max(l); otherwise keys past S are masked and the logits scaled first (on
// an H100 the masked path forced on for S = 144 took 12% longer at
// [8192, 144, 32]).
//
// Each consumer warp takes row tiles of 16 queries in turn and keeps a tile's
// logits (72 float32 a lane), probabilities and output in registers, in the
// fragment layouts of mma.sync m16n8k16: Q.K^T by ldmatrix fragments of Q and
// K, each row's softmax reduced over the 4 lanes of a quad, the probabilities
// rounded to bf16 straight into the A fragments of P.V (V by ldmatrix.trans).
// The output tile goes, as bf16, over the tile's own rows of Q in the stage
// (only this warp reads them); once every warp has staged its tiles, the
// consumers write the window out by 16-byte stores, neighbouring threads on
// neighbouring addresses, and each warp releases the stage on its `empty`
// barrier. The element path's copies come after that barrier too, into the
// other stage, so they never overwrite a stage still being read. (A warp
// storing its own tiles with no barrier kept more registers live and ran
// slower.)
template <bool kTma, bool kFull>
__global__ void __launch_bounds__(kRingThreads, kRingMinBlocks)
window_attention_ring(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv, const bf16* __restrict__ q,
                      const bf16* __restrict__ k, const bf16* __restrict__ v,
                      bf16* __restrict__ o, int N, int S_, int D, float c) {
  const int S = kFull ? kRingS : S_;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-static_cast<int>(smem_u32(smem_raw)) & 1023);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + kRingStages * kStageBytes);
  unsigned long long* empty = full + kRingStages;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int i = tid; i < kRingStages * kStageBytes / 16; i += kRingThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);  // a consumer warp arrives once
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();  // the zeros before the copies' async proxy
  __syncthreads();

  if (warp == kConsumers) {  // ---- the loader
    if (!kTma || lane != 0) return;
    int i = 0;
    for (int w = blockIdx.x; w < N; w += gridDim.x, ++i) {
      const int s = i % kRingStages;
      if (i >= kRingStages) mbar_wait(empty + s, (i / kRingStages - 1) & 1);
      unsigned char* st = smem + s * kStageBytes;
      mbar_arrive_tx(full + s, 3 * S * kRowBytes);
      tma_load(st, &mq, 0, w * S, full + s);
      tma_load(st + kTileBytes, &mk, 0, w * S, full + s);
      tma_load(st + 2 * kTileBytes, &mv, 0, w * S, full + s);
    }
    return;
  }

  // ---- the consumers
  constexpr int kThreadsC = kConsumers * 32;
  const int g = lane / 4, t = lane % 4;  // a fragment's row and column pair
  // A lane's ldmatrix rows lie at 16 j + ra (Q and V, A and B.trans layouts)
  // or 16 j + rb (K); the swizzle of row 16 j + r is that of r, so each
  // fragment is a tile base plus one of these offsets
  const int ra = lane % 8 + 8 * ((lane / 8) % 2), rb = lane % 8 + 8 * (lane / 16);
  const int off_a[2] = {swz(ra, lane / 16), swz(ra, 2 + lane / 16)};
  const int off_b[2] = {swz(rb, (lane / 8) % 2), swz(rb, 2 + (lane / 8) % 2)};
  int off_o[2][4];  // the output fragment's rows g and g + 8, chunk n, columns 2t, 2t + 1
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < 4; ++n) off_o[h][n] = swz(g + 8 * h, n) + 4 * t;
  int i = 0;
  for (int w = blockIdx.x; w < N; w += gridDim.x, ++i) {
    const int s = i % kRingStages;
    unsigned char* Qs = smem + s * kStageBytes;
    const unsigned char* Ks = Qs + kTileBytes;
    const unsigned char* Vs = Qs + 2 * kTileBytes;
    const size_t base = static_cast<size_t>(w) * S * D;
    if constexpr (kTma) {
      mbar_wait(full + s, (i / kRingStages) & 1);
    } else {
      const bf16* src[3] = {q + base, k + base, v + base};
      for (int e = tid; e < S * kRingD; e += kThreadsC) {
        const int r = e / kRingD, col = e % kRingD;
        const int at = swz(r, col / 8) + (col % 8) * 2;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          *reinterpret_cast<bf16*>(Qs + j * kTileBytes + at) =
              col < D ? src[j][r * D + col] : __float2bfloat16(0.f);
      }
      consumers_sync();
    }
#ifndef WINDOW_LOADS_ONLY
    for (int it = warp; it * 16 < S; it += kConsumers) {
      unsigned qa[2][4];
#pragma unroll
      for (int kb = 0; kb < 2; ++kb)
        ldmatrix_x4(qa[kb], reinterpret_cast<const bf16*>(Qs + it * 16 * kRowBytes + off_a[kb]));
      float sc[18][4];  // logits: 18 tiles of 8 keys; rows g (0, 1) and g + 8 (2, 3)
#pragma unroll
      for (int j = 0; j < 18; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int jp = 0; jp < 9; ++jp) {
        if (jp * 16 >= S) break;
#pragma unroll
        for (int kb = 0; kb < 2; ++kb) {
          unsigned b[4];
          ldmatrix_x4(b, reinterpret_cast<const bf16*>(Ks + jp * 16 * kRowBytes + off_b[kb]));
          mma_bf16(sc[2 * jp], qa[kb], b[0], b[1]);
          mma_bf16(sc[2 * jp + 1], qa[kb], b[2], b[3]);
        }
      }
      // float32 softmax of rows g and g + 8 over the S real keys; each row's
      // values lie in the 4 lanes of a quad
      float m0 = -INFINITY, m1 = -INFINITY, s0 = 1.f, s1 = 1.f;
#ifndef WINDOW_SKIP_SOFTMAX
#pragma unroll
      for (int j = 0; j < 18; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (!kFull) {
            const bool real = j * 8 + 2 * t + e < S;
            sc[j][e] = real ? sc[j][e] * c : -INFINITY;
            sc[j][2 + e] = real ? sc[j][2 + e] * c : -INFINITY;
          }
          m0 = fmaxf(m0, sc[j][e]);
          m1 = fmaxf(m1, sc[j][2 + e]);
        }
#pragma unroll
      for (int x = 1; x < 4; x *= 2) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, x));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, x));
      }
      if constexpr (kFull) {  // the max of c l, for c > 0
        m0 *= c;
        m1 *= c;
      }
      s0 = s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 18; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // past S: 2^-inf = 0
          sc[j][e] = ex2(kFull ? fmaf(sc[j][e], c, -m0) : sc[j][e] - m0);
          sc[j][2 + e] = ex2(kFull ? fmaf(sc[j][2 + e], c, -m1) : sc[j][2 + e] - m1);
          s0 += sc[j][e];
          s1 += sc[j][2 + e];
        }
#pragma unroll
      for (int x = 1; x < 4; x *= 2) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, x);
        s1 += __shfl_xor_sync(0xffffffffu, s1, x);
      }
#endif
      const float r0 = 1.f / s0, r1 = 1.f / s1;
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int jp = 0; jp < 9; ++jp) {
        if (jp * 16 >= S) break;
        const unsigned pa[4] = {
            pack_bf16(sc[2 * jp][0] * r0, sc[2 * jp][1] * r0),
            pack_bf16(sc[2 * jp][2] * r1, sc[2 * jp][3] * r1),
            pack_bf16(sc[2 * jp + 1][0] * r0, sc[2 * jp + 1][1] * r0),
            pack_bf16(sc[2 * jp + 1][2] * r1, sc[2 * jp + 1][3] * r1)};
#pragma unroll
        for (int db = 0; db < 2; ++db) {
          unsigned b[4];
          ldmatrix_x4_trans(b,
                            reinterpret_cast<const bf16*>(Vs + jp * 16 * kRowBytes + off_a[db]));
          mma_bf16(acc[2 * db], pa, b[0], b[1]);
          mma_bf16(acc[2 * db + 1], pa, b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<unsigned*>(Qs + it * 16 * kRowBytes + off_o[h][n]) =
              pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
    }
    consumers_sync();  // every row tile of the window is staged
#ifndef WINDOW_SKIP_STORE
    if (D % 8 == 0) {  // whole 16-byte chunks of the [S, D] rows
      uint4* dst = reinterpret_cast<uint4*>(o + base);
      for (int ch = tid; ch < S * D / 8; ch += kThreadsC) {
        const int r = ch * 8 / D;
        dst[ch] = *reinterpret_cast<const uint4*>(Qs + swz(r, (ch * 8 - r * D) / 8));
      }
    } else {
      for (int e = tid; e < S * D; e += kThreadsC) {
        const int r = e / D, col = e - r * D;
        o[base + e] = *reinterpret_cast<const bf16*>(Qs + swz(r, col / 8) + (col % 8) * 2);
      }
    }
#endif
#endif
    if constexpr (kTma) {
      fence_proxy_async();  // the staged output before the next copy into the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
window_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int S, int D, float scale,
                      bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Bf16Layout L(S, D);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + L.tile();
  bf16* Vs = Ks + L.tile();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* Ls = reinterpret_cast<float*>(smem + 3 * L.tile() * 2 + warp * L.strip_bytes());
  bf16* Ps = reinterpret_cast<bf16*>(Ls);
  const int LDP = 2 * L.LDL;  // P's row stride, bf16 elements
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;

  load_tile_bf16(Qs, q + base, S, D, L.SP, L.DP, L.LD, vec);
  load_tile_bf16(Ks, k + base, S, D, L.SP, L.DP, L.LD, vec);
  load_tile_bf16(Vs, v + base, S, D, L.SP, L.DP, L.LD, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const bf16 zero = __float2bfloat16(0.f);
  for (int it = warp; it < L.SP / 16; it += kWarps) {
    // logits of rows it*16 .. it*16+15 against every key tile
    for (int jt = 0; jt < L.SP / 16; ++jt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < L.DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + it * 16 * L.LD + kk, L.LD);
        wmma::load_matrix_sync(b, Ks + jt * 16 * L.LD + kk, L.LD);  // K^T, col-major
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ls + jt * 16, acc, L.LDL, wmma::mem_row_major);
    }
    __syncwarp();
    // exact float32 softmax over the S real keys; P rounded to bf16, 0 past S
    for (int r = 0; r < 16; ++r) {
      const float* lr = Ls + r * L.LDL;
      bf16* pr = Ps + r * LDP;
      const bool real = it * 16 + r < S;
      float x[kMaxPer];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kMaxPer; ++j) {
        const int c = lane + 32 * j;
        x[j] = real && c < S ? lr[c] * scale : -INFINITY;
        m = fmaxf(m, x[j]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxPer; ++j) {
        const int c = lane + 32 * j;
        x[j] = real && c < S ? expf(x[j] - m) : 0.f;
        sum += x[j];
      }
      sum = warp_sum(sum);
      __syncwarp();  // every lane has read its logits before P is written over them
#pragma unroll
      for (int j = 0; j < kMaxPer; ++j) {
        const int c = lane + 32 * j;
        if (c < L.SP) pr[c] = real && c < S ? __float2bfloat16(x[j] / sum) : zero;
      }
    }
    __syncwarp();
    // P.V with float32 accumulators held until P is no longer read
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> out[kMaxDT];
#pragma unroll
    for (int dt = 0; dt < kMaxDT; ++dt) {
      if (dt * 16 >= L.DP) break;
      wmma::fill_fragment(out[dt], 0.f);
      for (int kk = 0; kk < L.SP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + kk, LDP);
        wmma::load_matrix_sync(b, Vs + kk * L.LD + dt * 16, L.LD);
        wmma::mma_sync(out[dt], a, b, out[dt]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int dt = 0; dt < kMaxDT; ++dt) {
      if (dt * 16 >= L.DP) break;
      wmma::store_matrix_sync(Ls + dt * 16, out[dt], L.LDL, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * D; e += 32) {
      const int r = e / D, col = e % D;
      const int row = it * 16 + r;
      if (row < S) o[base + static_cast<size_t>(row) * D + col] = __float2bfloat16(Ls[r * L.LDL + col]);
    }
    __syncwarp();  // the strip is rewritten by the next row tile
  }
}

// float32: Q, K, V as [S][D + 1] rows, then a row of S floats per warp.
__host__ __device__ inline size_t f32_bytes(int S, int D) {
  return (3ull * S * (D + 1) + static_cast<size_t>(kWarps) * S) * 4;
}

__global__ void __launch_bounds__(kThreads)
window_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int S, int D, float scale,
                     bool /* vec: rows of D + 1 floats take 4-byte copies */) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LD = D + 1;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + S * LD;
  float* Vs = Ks + S * LD;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* buf = Vs + S * LD + warp * S;
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;

  const float* src[3] = {q + base, k + base, v + base};
  float* dst[3] = {Qs, Ks, Vs};
#pragma unroll
  for (int t = 0; t < 3; ++t)
    for (int e = threadIdx.x; e < S * D; e += kThreads)
      cp_async4(dst[t] + (e / D) * LD + e % D, src[t] + e, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int row = warp; row < S; row += kWarps) {
    const float* qr = Qs + row * LD;
    float m = -INFINITY;
    for (int c = lane; c < S; c += 32) {
      const float* kr = Ks + c * LD;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      buf[c] = acc * scale;
      m = fmaxf(m, buf[c]);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < S; c += 32) {
      const float e = expf(buf[c] - m);
      buf[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < S; c += 32) buf[c] = buf[c] / sum;
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int t = 0; t < S; ++t) acc = fmaf(buf[t], Vs[t * LD + d], acc);
      o[base + static_cast<size_t>(row) * D + d] = acc;
    }
    __syncwarp();  // buf is rewritten by the next row
  }
}

template <typename Kernel, typename T>
cudaError_t launch(Kernel kernel, int threads, size_t bytes, const T* q, const T* k, const T* v,
                   T* o, int N, int S, int D, float scale, bool vec, cudaStream_t s) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidConfiguration;
  // above 48 KB only after the opt-in, which belongs to the current device
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  kernel<<<N, threads, bytes, s>>>(q, k, v, o, S, D, scale, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Blocks of the ring kernel that fit the card at once: its persistent grid
// (cached per instantiation; the shared-memory opt-in is set first, at every
// call, since it belongs to the current device).
template <bool kTma, bool kFull>
cudaError_t ring_grid(int* blocks) {
  static int cached = 0;
  auto kernel = window_attention_ring<kTma, kFull>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingSmem);
  if (e != cudaSuccess || cached > 0) {
    *blocks = cached;
    return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRingThreads, kRingSmem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = cached = sms * per_sm;
  return cudaSuccess;
}

// Whether the ring takes these inputs by TMA: 16-byte aligned rows of whole
// 16-byte chunks.
bool ring_copies(const void* q, const void* k, const void* v, int D) {
  return D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
}

template <bool kTma, bool kFull>
cudaError_t start_ring(const CUtensorMap (&map)[3], const bf16* q, const bf16* k,
                        const bf16* v, bf16* o, int N, int S, int D, float c, cudaStream_t s) {
  int blocks = 0;
  const cudaError_t e = ring_grid<kTma, kFull>(&blocks);
  if (e != cudaSuccess) return e;
  window_attention_ring<kTma, kFull><<<N < blocks ? N : blocks, kRingThreads, kRingSmem, s>>>(
      map[0], map[1], map[2], q, k, v, o, N, S, D, c);
  return cudaGetLastError();
}

template <bool kTma>
cudaError_t launch_ring(const bf16* q, const bf16* k, const bf16* v, bf16* o, int N, int S,
                        int D, float scale, cudaStream_t s) {
  CUtensorMap map[3]{};
  if (kTma) {  // [N S, D] rows, boxes of {32, S}: the columns past D read as zeros
    const bf16* src[3] = {q, k, v};
    for (int j = 0; j < 3; ++j)
      if (!encode_map(&map[j], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, src[j], D,
                      static_cast<unsigned long long>(N) * S, D * 2ull, kRingD, S,
                      CU_TENSOR_MAP_SWIZZLE_64B))
        return cudaErrorInvalidValue;
  }
  const float c = scale * 1.44269504088896341f;  // log2(e): the softmax runs on 2^x
  if (S == kRingS && c > 0.f)
    return start_ring<kTma, true>(map, q, k, v, o, N, S, D, c, s);
  return start_ring<kTma, false>(map, q, k, v, o, N, S, D, c, s);
}

}  // namespace

// The ring kernel's persistent grid on the current device for ColFlor's
// windows (blocks that fit at once: SMs x resident blocks), or a negated CUDA
// error code.
extern "C" int window_attention_grid() {
  int blocks = 0;
  const cudaError_t e = ring_grid<true, true>(&blocks);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// out [N, S, D] = attention of q over k, v [N, S, D] per window, no mask;
// dtype 0 = float32, 1 = bfloat16 (q, k, v and out alike). bf16 windows of
// S <= 144 and D <= 32 take the ring kernel, other bf16 windows up to S 512
// and D 128 the WMMA kernel, float32 the CUDA cores (ops/window_attention.py
// `kernel_path` states the same choice).
extern "C" int window_attention_launch(const void* q, const void* k, const void* v, void* out,
                                       int N, int S, int D, float scale, int dtype,
                                       void* stream) {
  if (N <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    const auto bq = static_cast<const bf16*>(q), bk = static_cast<const bf16*>(k),
               bv = static_cast<const bf16*>(v);
    const auto bo = static_cast<bf16*>(out);
    if (S <= kRingS && D <= kRingD) {
      if (static_cast<long long>(N) * S >= (1ll << 31))  // TMA's row coordinate is 32-bit
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(ring_copies(q, k, v, D)
                                  ? launch_ring<true>(bq, bk, bv, bo, N, S, D, scale, s)
                                  : launch_ring<false>(bq, bk, bv, bo, N, S, D, scale, s));
    }
    if (S > 32 * kMaxPer || D > 16 * kMaxDT) return static_cast<int>(cudaErrorInvalidConfiguration);
    const bool v8 = aligned16(q) && aligned16(k) && aligned16(v) && D % 8 == 0;
    return static_cast<int>(launch(window_attention_bf16, kThreads, Bf16Layout(S, D).bytes(),
                                   bq, bk, bv, bo, N, S, D, scale, v8, s));
  }
  if (dtype == kFloat32)
    return static_cast<int>(launch(window_attention_f32, kThreads, f32_bytes(S, D),
                                   static_cast<const float*>(q), static_cast<const float*>(k),
                                   static_cast<const float*>(v), static_cast<float*>(out), N, S,
                                   D, scale, false, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
