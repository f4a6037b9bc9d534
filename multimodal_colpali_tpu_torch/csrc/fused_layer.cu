// K5a-c building block: a bf16 tensor-core GEMM with a LayerNorm prologue and
// a bias / bias+gelu_tanh / bias+residual epilogue, and the pre-pass that
// gives it each row's LayerNorm statistics.
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
// (i) and (iv) follow a launch of ln_stats_kernel on their A.
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
// What bounds it on an H100: at ColSmol's shapes (M = 8,192-16,384 rows, K =
// 768 or 3,072, N = 768 to 3,072) the product does hundreds of operations a
// byte of A and W, so its bound is the tensor cores' (0.010-0.039 ms a GEMM
// at M = 8,192). The tiles' loads from L2 come next: a 128 x 256 tile at the
// full rate asks ~11 TB/s of it, so the tiles are as wide as the registers
// allow. As built, the loads, the epilogue (which runs while the tensor cores
// idle) and, with a LayerNorm, the transform each hold it back by a share the
// probe builds below measure (PERF.md section 6).
//
// Design (gemm_wgmma). A persistent block of three warpgroups walks the output
// tiles in a fixed order (ops/fused_layer.gemm_plan picks the tile width BN,
// 128 or 256, and the grid from the shapes alone; a tile never crosses a
// weight segment; column tiles vary fastest, so the blocks in flight share
// A's rows). One lane of the loader's warpgroup, which hands its registers to
// the other two (setmaxnreg), issues for each K step of 64 two TMA boxes, A's
// 128 rows and the segment's BN weight rows, both rows of 128 bytes in the
// 128-byte swizzle, into a ring of 4 (BN 256) or 6 (BN 128) stages, and
// announces them on the stage's mbarrier. Past the edges of M, N and K the
// boxes read zeros. Two consumer warpgroups take 64 rows each and issue
// wgmma m64nBNk16 with A and W from shared memory (both K-major: torch's
// [N, K] weight is wgmma's B as it is) and release a stage on a second
// mbarrier once its products are done; meanwhile the loader fills the next
// tile's stages while the consumers run the epilogue.
//   - With a LayerNorm, each consumer warpgroup first normalizes its 64 rows
//     of the stage in place, (x - mean) * rstd * g + b in float32 rounded to
//     bf16 (a thread takes one 16-byte chunk of 4 rows, so each loads g and b
//     once for 4 rows: loading them for every chunk saturated L1 and shared
//     memory's 128 bytes a clock), while the last stage's products run; then a
//     proxy fence and a barrier of the warpgroup, and the products read the
//     normalized tile. Nothing normalized goes to device memory. (A first
//     form applied the LayerNorm to register A fragments: ptxas serialized
//     every wgmma that read them, C7513, and the transform and the products
//     ran one after the other, 0.142 ms for QKV at M = 8,192 against 0.064
//     with the products skipped and 0.095 with the transform skipped.)
//   - The statistics come once a row from ln_stats_kernel (a warp a row:
//     lane-strided sums of 8 elements, then an xor-shuffle tree; mean, then
//     the mean squared deviation, as jnp.var), not once a column tile.
//   - The epilogue works from the accumulators: bias and the bf16 rounding in
//     wgmma's fragment layout, then a transpose within each quad of lanes
//     gives every lane 8 adjacent columns of a row, so gelu, the residual
//     (read 16 bytes at a time) and the store go by 16 bytes.
// Weight multicast across 2-CTA clusters and ping-pong consumers were built
// and measured slower (PERF.md section 6).
// Probe builds: -DGEMM_SKIP_PRODUCTS issues no wgmma (the loads, the LN
// transform and the epilogue alone); -DGEMM_SKIP_LN skips the transform;
// -DGEMM_SKIP_EPILOGUE stores nothing.
#include "common.cuh"
#include "mma.cuh"  // pack_bf16
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // gemm_f32_kernel's block; ln_stats_kernel's: 8 warps a block

enum Epilogue : int { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

__device__ __forceinline__ float gelu_tanh(float x) {
  // torch.nn.functional.gelu(approximate="tanh") and jax.nn.gelu(approximate=True),
  // in the order of torch's CUDA kernel (x cubed first), so that the two round alike
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float x3 = x * x * x;
  return 0.5f * x * (1.f + tanhf(kBeta * (x + kKappa * x3)));
}

union Pack8 {
  uint4 u;
  bf16 h[8];
};

// ---- LayerNorm statistics -----------------------------------------------------

// stats[m] = (mean, 1 / sqrt(var + eps)) of row m of A [M, K], in float32; a
// warp a row, the row read once for each of the two passes.
__global__ void __launch_bounds__(kThreads)
ln_stats_kernel(const bf16* __restrict__ A, float2* __restrict__ stats, int M, int K,
                float eps) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (kThreads / 32) + warp;
  if (m >= M) return;
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
  const float mean = s / K;
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
  if (lane == 0) stats[m] = make_float2(mean, 1.f / sqrtf(ss / K + eps));
}

// ---- the bf16 GEMM: wgmma fed by TMA ------------------------------------------

constexpr int kBM = 128;                         // rows of a tile: 2 warpgroups x 64
constexpr int kBK = 64;                          // K a stage: 128 bytes of a row, 4 k16 steps
constexpr int kConsumers = 256;                  // the two consumer warpgroups
constexpr int kGemmThreads = kConsumers + 128;   // + the loader's warpgroup

// A stage: A's 128 rows, then the tile's BN weight rows, each 128 bytes in the
// 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)); then the
// stages' full and empty barriers.
template <int BN>
struct Ring {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kA = kBM * kBK * 2;
  static constexpr int kStage = kA + BN * kBK * 2;  // a multiple of 1024
  static constexpr int kBarOff = kStages * kStage;
  static constexpr int kBytes = kBarOff + 2 * kStages * 8 + 1024;  // + the base's alignment
};

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], unsigned long long a,
                                    unsigned long long b, int scale_d) {
#ifndef GEMM_SKIP_PRODUCTS
  if constexpr (BN == 256) wgmma_ss_m64n256k16(d, a, b, scale_d);
  else wgmma_ss_m64n128k16(d, a, b, scale_d);
#endif
}

// Normalizes logical 16-byte chunk c (K k0 + 8c .. + 7) of 4 A rows of a
// stage in place, rows r0 + 16 j: (x - mean_j) * rstd_j * g + b in float32,
// rounded to bf16; g and b are loaded once for the 4 rows. A chunk past K
// stays zeros.
__device__ __forceinline__ void normalize_chunk(unsigned char* st, int r0, int c, int k0, int K,
                                                const float (&mean)[4], const float (&rstd)[4],
                                                const float* __restrict__ ln_g,
                                                const float* __restrict__ ln_b) {
  const int k = k0 + 8 * c;
  if (k >= K) return;
#ifndef GEMM_SKIP_LN
  const float4 g0 = __ldg(reinterpret_cast<const float4*>(ln_g + k));
  const float4 g1 = __ldg(reinterpret_cast<const float4*>(ln_g + k + 4));
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(ln_b + k));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(ln_b + k + 4));
  const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  Pack8 v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + 16 * j;
    v[j].u = *reinterpret_cast<const uint4*>(st + r * 128 + ((c ^ (r % 8)) << 4));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + 16 * j;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[j].h[e] = __float2bfloat16((__bfloat162float(v[j].h[e]) - mean[j]) * rstd[j] * g[e] + b[e]);
    *reinterpret_cast<uint4*>(st + r * 128 + ((c ^ (r % 8)) << 4)) = v[j].u;
  }
#endif
}

// u[j] is pair t (columns 2t, 2t+1) of block j (8 columns) of this lane's
// row, t = lane % 4; returns block t's four pairs, gathered across the quad.
__device__ __forceinline__ uint4 quad_transpose(const unsigned (&u)[4], int t) {
  const bool hi = t & 2, odd = t & 1;
  // lanes t and t ^ 2 swap the other half's blocks: then this lane holds
  // blocks 2 (t / 2) + i, pairs t (a) and t ^ 2 (r)
  const unsigned a0 = hi ? u[2] : u[0], a1 = hi ? u[3] : u[1];
  const unsigned r0 = __shfl_xor_sync(0xffffffffu, hi ? u[0] : u[2], 2);
  const unsigned r1 = __shfl_xor_sync(0xffffffffu, hi ? u[1] : u[3], 2);
  // lanes t and t ^ 1 swap the block the other one keeps
  const unsigned q0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 1);  // pair t ^ 1
  const unsigned q1 = __shfl_xor_sync(0xffffffffu, odd ? r0 : r1, 1);  // pair t ^ 3
  const unsigned own0 = odd ? a1 : a0, own1 = odd ? r1 : r0;           // pairs t, t ^ 2
  unsigned o[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int x = p ^ t;
    o[p] = x == 0 ? own0 : (x == 1 ? q0 : (x == 2 ? own1 : q1));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// 8 columns of a row at element `at` of the plane: gelu or the residual, the
// bf16 rounding, one 16-byte store.
template <int kEpi>
__device__ __forceinline__ void store8(bf16* __restrict__ out, const bf16* __restrict__ resid,
                                       size_t at, uint4 v) {
  if constexpr (kEpi != kBias) {
    Pack8 p, r;
    p.u = v;
    if constexpr (kEpi == kBiasResidual) r.u = *reinterpret_cast<const uint4*>(resid + at);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float x = __bfloat162float(p.h[e]);
      if constexpr (kEpi == kBiasGelu) x = gelu_tanh(x);
      if constexpr (kEpi == kBiasResidual) x += __bfloat162float(r.h[e]);
      p.h[e] = __float2bfloat16(x);
    }
    v = p.u;
  }
  *reinterpret_cast<uint4*>(out + at) = v;
}

// Tile t of the plan: rows m0 .. m0+127 of segment seg's columns n0 .. n0+BN-1.
// Column tiles vary fastest, so the blocks in flight share A's rows (read from
// device memory once) and the weights stay in L2.
struct Tile {
  int m0, seg, n0;
};
template <int BN>
__device__ __forceinline__ Tile tile_of(int t, int n_tiles, int segs) {
  const int nt = t % (n_tiles * segs);
  return {t / (n_tiles * segs) * kBM, nt / n_tiles, (nt % n_tiles) * BN};
}

template <int BN, bool kLN, int kEpi>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_wgmma(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mw0,
           const __grid_constant__ CUtensorMap mw1, const __grid_constant__ CUtensorMap mw2,
           const float2* __restrict__ stats, const float* __restrict__ ln_g,
           const float* __restrict__ ln_b, const float* __restrict__ b0,
           const float* __restrict__ b1, const float* __restrict__ b2,
           const bf16* __restrict__ resid, bf16* __restrict__ C, int M, int K, int Nseg,
           int segs, int n_tiles, int tiles) {
  using R = Ring<BN>;
  constexpr int S = R::kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-static_cast<int>(smem_u32(smem_raw)) & 1023);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + R::kBarOff);
  unsigned long long* empty = full + S;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ksteps = (K + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);  // a consumer warp arrives once
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ---- the loader's warpgroup gives its registers to the consumers; one
    // lane issues every stage's two boxes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != kConsumers) return;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_of<BN>(t, n_tiles, segs);
      const CUtensorMap* mw = tl.seg == 0 ? &mw0 : (tl.seg == 1 ? &mw1 : &mw2);
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(empty + s, (it / S - 1) & 1);
        unsigned char* st = smem + s * R::kStage;
        mbar_arrive_tx(full + s, R::kStage);
        tma_load(st, &ma, ks * kBK, tl.m0, full + s);
        tma_load(st + R::kA, mw, ks * kBK, tl.n0, full + s);
      }
    }
    return;
  }

  // ---- the products: warpgroup wg takes rows 64 wg .. 64 wg + 63 of the tile
  // (this warp's lanes hold rows 16 (warp % 4) + g and + 8 of those in wgmma's
  // accumulator layout); with a LayerNorm it first normalizes those rows of
  // each stage in place, thread i of the warpgroup half of row i / 2
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4;
  const int g = lane / 4, t4 = lane % 4;
  const int wrow = 64 * wg + 16 * (warp % 4);
  // LN: this thread normalizes chunk lc of the warpgroup's rows lr + 16 j
  const int lc = tid % 8, lr = 64 * wg + (tid % 128) / 8;
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  };
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl = tile_of<BN>(t, n_tiles, segs);
    float mean[4] = {0.f, 0.f, 0.f, 0.f}, rstd[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kLN) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (tl.m0 + lr + 16 * j < M) {
          const float2 v = stats[tl.m0 + lr + 16 * j];
          mean[j] = v.x, rstd[j] = v.y;
        }
      }
    }
    for (int ks = 0; ks < ksteps; ++ks, ++it) {
      const int s = it % S;
      mbar_wait(full + s, (it / S) & 1);
      unsigned char* st = smem + s * R::kStage;
      if constexpr (kLN) {
        normalize_chunk(st, lr, lc, ks * kBK, K, mean, rstd, ln_g, ln_b);
        // the generic-proxy stores, before wgmma's async-proxy reads; the
        // warpgroup's rows all written
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        mma<BN>(acc, smem_desc(st + 64 * wg * 128 + kk * 32, 1024, 1),
                smem_desc(st + R::kA + kk * 32, 1024, 1), ks > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the last stage's products are done: release it
      fence_regs(acc);
      if (ks > 0) release((it - 1) % S);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release((it - 1) % S);

    // ---- epilogue: acc[4j + e] is row ra (e < 2) or ra + 8, column 8j + 2 t4 + e % 2
    const int ra = tl.m0 + wrow + g;
#ifdef GEMM_SKIP_EPILOGUE
    if (acc[0] != 12345.f || ra >= 0) continue;  // keeps the products, stores nothing
#endif
    const float* bias = tl.seg == 0 ? b0 : (tl.seg == 1 ? b1 : b2);
    bf16* out = C + static_cast<size_t>(tl.seg) * M * Nseg;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += 4) {
      unsigned ua[4], ub[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q;
        const int n = tl.n0 + 8 * j + 2 * t4;
        float2 bv = make_float2(0.f, 0.f);
        if (n < Nseg) bv = __ldg(reinterpret_cast<const float2*>(bias + n));
        ua[q] = pack_bf16(acc[4 * j] + bv.x, acc[4 * j + 1] + bv.y);
        ub[q] = pack_bf16(acc[4 * j + 2] + bv.x, acc[4 * j + 3] + bv.y);
      }
      const uint4 va = quad_transpose(ua, t4), vb = quad_transpose(ub, t4);
      const int n = tl.n0 + 8 * (j0 + t4);  // Nseg is a multiple of 8: all 8 or none
      if (n < Nseg) {
        if (ra < M) store8<kEpi>(out, resid, static_cast<size_t>(ra) * Nseg + n, va);
        if (ra + 8 < M) store8<kEpi>(out, resid, static_cast<size_t>(ra + 8) * Nseg + n, vb);
      }
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

template <int BN, bool kLN, int kEpi>
cudaError_t launch_wgmma(const bf16* A, const float2* stats, const float* ln_g,
                         const float* ln_b, const bf16* const (&w)[3], const float* b0,
                         const float* b1, const float* b2, const bf16* resid, bf16* C, int M,
                         int K, int Nseg, int segs, int grid, cudaStream_t stream) {
  using R = Ring<BN>;
  // TMA takes rows of whole 16-byte chunks from 16-byte aligned starts (K % 8
  // == 0, the pointers checked by the caller); boxes of 64 K by 128 rows of
  // A, 64 K by BN rows of a segment's weight
  CUtensorMap ma{}, mw[3]{};
  bool ok = encode_map(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, A, K, M, K * 2ull, kBK, kBM,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  for (int i = 0; i < segs; ++i)
    ok = ok && encode_map(&mw[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w[i], K, Nseg, K * 2ull,
                          kBK, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return cudaErrorInvalidValue;
  for (int i = segs; i < 3; ++i) mw[i] = mw[0];
  const int n_tiles = (Nseg + BN - 1) / BN;
  const int tiles = (M + kBM - 1) / kBM * n_tiles * segs;
  // the opt-in belongs to the current device, so it is set at every launch
  auto kernel = gemm_wgmma<BN, kLN, kEpi>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid < tiles ? grid : tiles, kGemmThreads, R::kBytes, stream>>>(
      ma, mw[0], mw[1], mw[2], stats, ln_g, ln_b, b0, b1, b2, resid, C, M, K, Nseg, segs,
      n_tiles, tiles);
  return cudaGetLastError();
}

template <bool kLN, int kEpi>
cudaError_t launch(const void* A, const float2* stats, const float* ln_g, const float* ln_b,
                   float eps, const void* w0, const void* w1, const void* w2, const float* b0,
                   const float* b1, const float* b2, const void* resid, void* C, int M, int N,
                   int K, int Nseg, bool f32, int bn, int grid, cudaStream_t stream) {
  if (f32) {
    const dim3 g((N + FN - 1) / FN, (M + FM - 1) / FM);
    gemm_f32_kernel<kLN, kEpi><<<g, kThreads, 0, stream>>>(
        static_cast<const float*>(A), ln_g, ln_b, eps, static_cast<const float*>(w0),
        static_cast<const float*>(w1), static_cast<const float*>(w2), b0, b1, b2,
        static_cast<const float*>(resid), static_cast<float*>(C), M, N, K, Nseg);
    return cudaGetLastError();
  }
  const bf16* const w[3] = {static_cast<const bf16*>(w0), static_cast<const bf16*>(w1),
                            static_cast<const bf16*>(w2)};
  const auto a = static_cast<const bf16*>(A);
  const auto r = static_cast<const bf16*>(resid);
  const auto c = static_cast<bf16*>(C);
  if (bn == 256)
    return launch_wgmma<256, kLN, kEpi>(a, stats, ln_g, ln_b, w, b0, b1, b2, r, c, M, K, Nseg,
                                        N / Nseg, grid, stream);
  return launch_wgmma<128, kLN, kEpi>(a, stats, ln_g, ln_b, w, b0, b1, b2, r, c, M, K, Nseg,
                                      N / Nseg, grid, stream);
}

}  // namespace

// stats [M] float2 = (mean, 1 / sqrt(var + eps)) of each row of A [M, K]
// bfloat16, K a multiple of 8, A 16-byte aligned.
extern "C" int ln_stats_launch(const void* A, void* stats, int M, int K, float eps,
                               void* stream) {
  if (M <= 0 || K <= 0 || K % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = kThreads / 32;
  ln_stats_kernel<<<(M + rows - 1) / rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), static_cast<float2*>(stats), M, K, eps);
  return static_cast<int>(cudaGetLastError());
}

// C = epilogue(LN?(A) . W^T + bias) for A [M, K] and C in float32 (dtype 0)
// or bfloat16 (dtype 1), the codes of attention_launch.
//
// The N output columns come in N / Nseg segments of Nseg columns (at most 3);
// segment s reads its weight rows from w_s [Nseg, K] and its bias from b_s
// [Nseg], and is written as the plane C[s] of C [N / Nseg, M, Nseg]. ln_g and
// ln_b ([K] float32) select the LayerNorm prologue when not null; bfloat16
// then reads each row's statistics from `stats` (ln_stats_launch), float32
// computes them itself. epilogue: 0 bias, 1 bias + gelu_tanh, 2 bias +
// residual (resid [M, N], one segment). bfloat16 runs gemm_wgmma with tiles
// `bn` (128 or 256) columns wide on a grid of at most `grid` blocks. K, N and
// Nseg are multiples of 8 and every pointer is 16-byte aligned.
extern "C" int gemm_launch(const void* A, const void* stats, const float* ln_g,
                           const float* ln_b, float eps, const void* w0, const void* w1,
                           const void* w2, const float* b0, const float* b1, const float* b2,
                           const void* resid, void* C, int M, int N, int K, int Nseg,
                           int epilogue, int dtype, int bn, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || Nseg <= 0 || N % Nseg || N / Nseg > 3 || K % 8 || Nseg % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == 0;
  if (epilogue == kBiasResidual && (N != Nseg || resid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ln = ln_g != nullptr && ln_b != nullptr;
  if (!f32 && ((bn != 128 && bn != 256) || grid <= 0 || (ln && stats == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<const float2*>(stats);
  cudaError_t err;
#define GEMM_CASE(LN, EPI)                                                                     \
  if (ln == LN && epilogue == EPI)                                                             \
    err = launch<LN, EPI>(A, st, ln_g, ln_b, eps, w0, w1, w2, b0, b1, b2, resid, C, M, N, K,   \
                          Nseg, f32, bn, grid, s);                                             \
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
