// The quantized weight stream's prefill tile, shared by K8a (csrc/int8_matmul.cu,
// int8 codes [K, N] and a column scale in the epilogue) and K9 (csrc/int4_matmul.cu,
// group-split int4 codes [K/2, N] scaled and rounded to bf16 before the dot),
// and the register helpers both decode tiles use.
//
// What bounds it on an H100: prefill has M = 300-1,540 tokens, so the
// product does ~2 * M operations a weight byte, far above the ~295 where the
// tensor cores become the limit (0.120 ms for 512 tokens through a [5376,
// 21504] projection). The work beside the products is the widening of the
// codes (~3 instruction issues an int8 weight, ~5 an int4 one) and the loads.
//
// Design. The product is taken transposed, C^T = W^T . x^T, on wgmma
// m64n128k16 with A from registers: the weight's columns are the A operand,
// widened from their codes in registers straight into A fragments, and 128
// tokens are the B operand, read by the tensor cores from x's tile in shared
// memory (K-major, the layout of x's rows). Nothing widened goes back to shared
// memory. A block computes 256 weight columns x 128 tokens: two consumer
// warpgroups of 128 columns each issue two wgmma a k16 step (one a 64-column
// half), and warp w supplies rows 16 (w % 4) .. +15 of each half from columns
// 32w .. 32w+31 of the block. Each A fragment so feeds 128 tokens of
// products. A lane reads 4 code bytes (columns 4g .. 4g+3 of its warp's 32,
// g = lane / 4) of each code row it needs; byte j < 2 is row g of half j, byte
// j >= 2 its row g + 8. Each lane's accumulators for a token are thus four
// adjacent columns of C, and the epilogue writes C [M, N] in whole 32-byte
// sectors straight from registers. The column scale (int8) multiplies the
// float32 accumulator before the cast.
//
// A fifth warp loads: one lane issues each stage's TMA copies (x's 128 tokens
// x 64 K rows, two 128-column halves of codes, int4's group scales) into a
// 4-stage ring and announces them on the stage's mbarrier; the consumers
// release a stage on a second mbarrier once its products are done. Probes
// of three earlier forms (mma.sync fed by ldmatrix; wgmma with cp.async
// issued by every thread; a cp.async loader warp) all ran at the sum of their
// load-only and product-only times: the loads' per-thread copy instructions
// and the widening competed for the same issue slots. TMA takes the loads
// off the issue path; two A buffers let the widening of one k16 step overlap
// the products of the last.
//
// Layouts (each stage 1024-byte aligned; the swizzles are address bits): x
// for int8 is 128 rows of 128 bytes in the 128-byte swizzle (16-byte chunk c
// of token m at c ^ (m % 8)), one TMA box; codes are rows of 128 bytes in the
// same swizzle, two boxes, so a warp's 4-byte reads of rows 2t, 2t+1, 2t+8,
// 2t+9 hit 32 distinct banks. int4's k16 steps follow the group-split bytes:
// a stage is 32 byte rows, whose low nibbles are K rows k_lo .. k_lo+31 and
// high nibbles k_lo + G/2 .. +31; x comes as those two runs, each a TMA box of
// 128 rows of 64 bytes in the 64-byte swizzle, and steps 2j and 2j+1 are the
// low and the high nibbles of byte rows 16j .. 16j+15 (the same four code
// words a lane reads feed both). Split-K (float32 partials [splits, M, N],
// summed in order by the caller's finalize kernel) only where the tile grid
// is smaller than a wave; block (x, y, z) = (token tile, column tile, split),
// so the token tiles of one column tile run side by side and each weight byte
// comes from device memory once.
//
// Shapes TMA cannot take (rows that are not whole 16-byte chunks, unaligned
// views) are loaded by the same loader warp with cp.async and plain stores
// into the same swizzled layouts. int4 with G/2 not a multiple of 32 (the
// gathered path, kGather): a stage may cross groups, so x is gathered element
// by element and each lane loads the scales of its rows' groups.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace wstream {

using bf16 = __nv_bfloat16;

using ::mma_bf16;
using ::pack_bf16;  // round to nearest even
using ::pack_exact;
using ::int8_of;

// 0x4B000000 | n is the float 2^23 + n; minus 2^23 + 8 it is n - 8, exactly.
// `nibbles`: four nibbles, one in the low half of each byte.
__device__ __forceinline__ float code_of(unsigned nibbles, int byte) {
  return __uint_as_float(__byte_perm(nibbles, 0x4B000000u, 0x7540u | byte)) - 8388616.f;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---- prefill tile -----------------------------------------------------------------

constexpr int kPreConsumers = 256;      // 2 warpgroups: the products
constexpr int kPreProducers = 32;       // 1 warp: the loads
constexpr int kPreThreads = kPreConsumers + kPreProducers;
constexpr int kPreBN = 256;             // weight columns a block: 8 warps x 32
constexpr int kPreBM = 128;             // tokens a block
constexpr int kPreK = 64;               // K rows a stage: 4 k16 steps
constexpr int kPreStages = 4;

// A stage (1024-byte aligned: the swizzles are functions of address bits):
//   x, 128 tokens x 64 K rows. int8: rows of 128 bytes in the 128-byte swizzle
//     (16-byte chunk c of token m at c ^ (m % 8)). int4: the lo run (K rows
//     k_lo .. +31) and the hi run (k_lo + G/2 .. +31), each 128 rows of 64
//     bytes in the 64-byte swizzle (chunk c of token m at c ^ (m / 2 % 4)).
//   codes, the stage's code rows x 256 columns as two 128-column halves,
//     rows of 128 bytes in the 128-byte swizzle.
//   int4 grouped: the group's 256 scales.
// Then the stages' full and empty barriers.
template <bool kInt4>
struct PreRing {
  static constexpr int kRows = kInt4 ? kPreK / 2 : kPreK;  // code rows a stage
  static constexpr int kX = kPreBM * kPreK * 2;
  static constexpr int kCodes = kRows * kPreBN;
  static constexpr int kXOff = 0, kCodeOff = kX, kScaleOff = kX + kCodes;
  static constexpr int kStage = (kScaleOff + (kInt4 ? kPreBN * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int kBarOff = kPreStages * kStage;
  static constexpr int kBytes = kBarOff + 2 * kPreStages * 8 + 1024;  // + the base's alignment
};

// Byte offset of token m, tile column cc (int4: cc < 32 the lo run, else the
// hi run) in a stage's x tile.
template <bool kInt4>
__device__ __forceinline__ int x_at(int m, int cc) {
  if constexpr (kInt4) {
    const int c = (cc % 32) / 8;
    return (cc / 32) * (kPreBM * 64) + m * 64 + ((c ^ (m / 2 % 4)) << 4) + (cc % 8) * 2;
  } else {
    return m * 128 + (((cc / 8) ^ (m % 8)) << 4) + (cc % 8) * 2;
  }
}

// Byte offset of code row r, block column n in a stage's codes.
template <bool kInt4>
__device__ __forceinline__ int code_at(int r, int n) {
  constexpr int kRows = PreRing<kInt4>::kRows;
  const int c = (n % 128) / 16;
  return (n / 128) * (kRows * 128) + r * 128 + ((c ^ (r % 8)) << 4) + n % 16;
}

// The float32 scales of columns n .. n+3 in group `grp` (-1: zeros), from
// device memory (the gathered path).
__device__ __forceinline__ void load_scales4(float (&s)[4], const float* scale, int grp, int n,
                                             int N, bool s_vec) {
  if (grp < 0) {
    s[0] = s[1] = s[2] = s[3] = 0.f;
    return;
  }
  const float* src = scale + static_cast<size_t>(grp) * N + n;
  if (s_vec && n + 4 <= N) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = n + j < N ? __ldg(src + j) : 0.f;
  }
}

template <typename TOut>
__device__ __forceinline__ void store4(TOut* dst, const float (&v)[4], int valid, bool vec);

template <>
__device__ __forceinline__ void store4<float>(float* dst, const float (&v)[4], int valid,
                                              bool vec) {
  if (vec && valid >= 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < valid) dst[j] = v[j];
  }
}

template <>
__device__ __forceinline__ void store4<bf16>(bf16* dst, const float (&v)[4], int valid, bool vec) {
  if (vec && valid >= 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < valid) dst[j] = __float2bfloat16(v[j]);
  }
}

// C [M, N] (or the split's float32 partial) = x [M, K] . W. int8: W = codes
// [K, N] (signed bytes), C = acc * scale[n]. int4: W from packed [K/2, N] and
// scale [K/G, N], each weight rounded to bf16 before the dot. `r_split`: code
// rows a split (a multiple of the stage's). kGather (int4): G/2 is not a
// multiple of the stage's 32 byte rows, so a stage may cross groups (x is
// gathered element by element, each row's scales loaded apart). `tma`: x,
// the codes and the scales come by TMA (mx, mw, ms); otherwise by cp.async
// (a_vec / b_vec / s_vec: x, the codes, the scales in 16-byte chunks) and
// plain stores. c_vec: C (or partial) by 16-byte chunks.
//
// Warp 8 loads: one lane issues each stage's TMA copies, announced on the
// stage's `full` barrier; warps 0-7 (two warpgroups) widen the codes into A
// fragments and issue wgmma m64n128k16 (A from registers, B the stage's x
// tile), and release the stage on its `empty` barrier once its products are
// done. The products of one k16 step overlap the widening of the next (two A
// buffers).
template <bool kInt4, bool kGather, typename TOut>
__global__ void __launch_bounds__(kPreThreads, 1)
prefill_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
               const __grid_constant__ CUtensorMap ms, const bf16* __restrict__ X,
               const unsigned char* __restrict__ W, const float* __restrict__ scale,
               TOut* __restrict__ C, float* __restrict__ partial, int M, int N, int K, int G,
               int r_split, bool tma, bool a_vec, bool b_vec, bool s_vec, bool c_vec) {
  using R = PreRing<kInt4>;
  constexpr bool grouped = kInt4 && !kGather;
  constexpr int kRows = R::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + (-static_cast<int>(smem_u32(smem_raw)) & 1023);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem + R::kBarOff);
  unsigned long long* empty = full + kPreStages;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int H = G / 2;                          // int4: byte rows a group
  const int rows = kInt4 ? K / 2 : K;           // code rows in all
  const int m0 = blockIdx.x * kPreBM;
  const int n0 = blockIdx.y * kPreBN;
  const int rb = blockIdx.z * r_split;
  const int re = min(rows, rb + r_split);
  const int steps = re > rb ? (re - rb + kRows - 1) / kRows : 0;
  if (tid == 0) {
    for (int s = 0; s < kPreStages; ++s) {
      mbar_init(full + s, 2 * kPreProducers);  // each loader arrives twice a stage
      mbar_init(empty + s, kPreConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kPreConsumers) {
    // ---- the loader: stage `step` gets its code rows, x's tokens at the K
    // rows they feed and, for grouped int4, the group's scales of the columns
    const int pt = tid - kPreConsumers;
    for (int step = 0; step < steps; ++step) {
      const int sidx = step % kPreStages;
      if (step >= kPreStages) mbar_wait(empty + sidx, (step / kPreStages - 1) & 1);
      unsigned char* st = smem + sidx * R::kStage;
      const int r0 = rb + step * kRows;
      // int8: K rows r0 .. r0+63; int4: k_lo .. k_lo+31, then k_lo + G/2 .. +31
      const int k_lo = kInt4 ? (r0 / H) * G + r0 % H : r0;
      if (tma) {
        if (pt == 0) {
          mbar_arrive_tx(full + sidx, R::kScaleOff + (kInt4 ? kPreBN * 4 : 0));
          if constexpr (kInt4) {
            tma_load(st + R::kXOff, &mx, k_lo, m0, full + sidx);
            tma_load(st + R::kXOff + kPreBM * 64, &mx, k_lo + H, m0, full + sidx);
            tma_load(st + R::kScaleOff, &ms, n0, r0 / H, full + sidx);
          } else {
            tma_load(st + R::kXOff, &mx, k_lo, m0, full + sidx);
          }
          tma_load(st + R::kCodeOff, &mw, n0, r0, full + sidx);
          tma_load(st + R::kCodeOff + kRows * 128, &mw, n0 + 128, r0, full + sidx);
        } else {
          mbar_arrive(full + sidx);
        }
        mbar_arrive(full + sidx);
        continue;
      }
      for (int c = pt; c < kRows * kPreBN / 16; c += kPreProducers) {
        const int r = c / (kPreBN / 16), o = (c % (kPreBN / 16)) * 16;
        const int p = r0 + r, col = n0 + o;
        const bool ok = p < re && col < N;
        unsigned char* dst = st + R::kCodeOff + code_at<kInt4>(r, o);
        const unsigned char* src = W + (ok ? static_cast<size_t>(p) * N + col : 0);
        if (b_vec || !ok) {
          cp_async16(dst, src, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) dst[e] = col + e < N ? src[e] : 0;
        }
      }
      unsigned char* xs = st + R::kXOff;
      if (!kInt4 || grouped) {
        if (a_vec) {
          for (int c = pt; c < kPreBM * kPreK / 8; c += kPreProducers) {
            const int m = c / (kPreK / 8), cc = (c % (kPreK / 8)) * 8;
            const int k = k_lo + (kInt4 && cc >= kRows ? H + cc - kRows : cc);
            const bool ok = m0 + m < M && r0 + (kInt4 ? cc % kRows : cc) < re;
            cp_async16(xs + x_at<kInt4>(m, cc),
                       X + (ok ? static_cast<size_t>(m0 + m) * K + k : 0), ok);
          }
        } else {
          for (int e = pt; e < kPreBM * kPreK; e += kPreProducers) {
            const int m = e / kPreK, cc = e % kPreK;
            const int k = k_lo + (kInt4 && cc >= kRows ? H + cc - kRows : cc);
            const bool ok = m0 + m < M && r0 + (kInt4 ? cc % kRows : cc) < re;
            *reinterpret_cast<bf16*>(xs + x_at<kInt4>(m, cc)) =
                ok ? X[static_cast<size_t>(m0 + m) * K + k] : __float2bfloat16(0.f);
          }
        }
      } else {  // int4, a stage that may cross groups: gather element by element
        for (int e = pt; e < kPreBM * kPreK; e += kPreProducers) {
          const int m = e / kPreK, cc = e % kPreK;
          const int p = r0 + cc % kRows;
          bf16 val = __float2bfloat16(0.f);
          if (m0 + m < M && p < re)
            val = X[static_cast<size_t>(m0 + m) * K + (p / H) * G + p % H + (cc >= kRows ? H : 0)];
          *reinterpret_cast<bf16*>(xs + x_at<kInt4>(m, cc)) = val;
        }
      }
      if (kInt4 && grouped) {
        float* ss = reinterpret_cast<float*>(st + R::kScaleOff);
        const float* src = scale + static_cast<size_t>(r0 / H) * N + n0;
        for (int c = pt; c < kPreBN / 4; c += kPreProducers) {
          const bool ok = n0 + 4 * c < N;
          if (s_vec) {
            cp_async16(ss + 4 * c, ok ? src + 4 * c : scale, ok);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) ss[4 * c + e] = n0 + 4 * c + e < N ? src[4 * c + e] : 0.f;
          }
        }
      }
      mbar_arrive_copies(full + sidx);
      mbar_arrive(full + sidx);   // release: this thread's plain stores
    }
    cp_async_wait<0>();
    return;
  }

  // ---- the products: warp w owns columns 32w .. 32w+31 of the block; in
  // wgmma terms, warpgroup w / 4 computes two 64-column halves (A tiles
  // a = 0, 1), this warp supplying rows 16 (w % 4) .. +15 of each
  float acc[2][kPreBM / 8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < kPreBM / 8; ++b)
      acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;
  const int ncol = n0 + warp * 32 + 4 * g;   // this lane's 4 columns
  const int wcol = (warp % 4) * 32 + 4 * g;  // and their place in the codes' half
  // int4: the scales of the code rows of a k16 step (grouped: one group a
  // stage; gathered: rows r, r+1, r+8, r+9 each its own)
  float sc[kGather ? 4 : 1][4];
  unsigned afb[2][2][4];  // A fragments: wgmma reads one buffer while the next fills

  for (int step = 0; step < steps; ++step) {
    const int sidx = step % kPreStages;
    mbar_wait(full + sidx, (step / kPreStages) & 1);
    // wgmma reads shared memory through the async proxy (the cp.async path
    // wrote it through the generic one)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const unsigned char* st = smem + sidx * R::kStage;
    const unsigned char* codes = st + R::kCodeOff + (warp / 4) * (kRows * 128);
    if constexpr (grouped) {
      const float4 s4 = reinterpret_cast<const float4*>(st + R::kScaleOff)[warp * 8 + g];
      sc[0][0] = s4.x, sc[0][1] = s4.y, sc[0][2] = s4.z, sc[0][3] = s4.w;
    }
    // the code words of rows r, r+1, r+8, r+9 of k16 step `ks` (int8: K rows
    // 16 ks .. +15; int4: steps 2j and 2j+1 are the low and the high nibbles
    // of byte rows 16j .. +15, x's lo and hi runs) and, gathered, their scales
    unsigned w[4];
    auto load_words = [&](int ks) {
      const int r = 16 * (kInt4 ? ks / 2 : ks) + 2 * t4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = r + (i & 1) + 8 * (i >> 1);
        w[i] = *reinterpret_cast<const unsigned*>(codes + code_at<kInt4>(ri, wcol));
      }
      if constexpr (kGather) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = rb + step * kRows + r + (i & 1) + 8 * (i >> 1);
          load_scales4(sc[i], scale, p < re ? p / H : -1, ncol, N, s_vec);
        }
      }
    };
    load_words(0);
#pragma unroll
    for (int kk = 0; kk < kPreK / 16; ++kk) {
      unsigned(&af)[2][4] = afb[kk % 2];
      if constexpr (kInt4) {
        unsigned q[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = (kk % 2 ? w[i] >> 4 : w[i]) & 0x0F0F0F0Fu;
        const float(&s0)[4] = sc[0];
        const float(&s1)[4] = sc[kGather ? 1 : 0];
        const float(&s8)[4] = sc[kGather ? 2 : 0];
        const float(&s9)[4] = sc[kGather ? 3 : 0];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          af[a][0] = pack_bf16(code_of(q[0], a) * s0[a], code_of(q[1], a) * s1[a]);
          af[a][1] = pack_bf16(code_of(q[0], 2 + a) * s0[2 + a], code_of(q[1], 2 + a) * s1[2 + a]);
          af[a][2] = pack_bf16(code_of(q[2], a) * s8[a], code_of(q[3], a) * s9[a]);
          af[a][3] = pack_bf16(code_of(q[2], 2 + a) * s8[2 + a], code_of(q[3], 2 + a) * s9[2 + a]);
        }
      } else {
        unsigned q[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = w[i] ^ 0x80808080u;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          af[a][0] = pack_exact(int8_of(q[0], a), int8_of(q[1], a));
          af[a][1] = pack_exact(int8_of(q[0], 2 + a), int8_of(q[1], 2 + a));
          af[a][2] = pack_exact(int8_of(q[2], a), int8_of(q[3], a));
          af[a][3] = pack_exact(int8_of(q[2], 2 + a), int8_of(q[3], 2 + a));
        }
      }
      // the next step's words load while this step's products run
      if (kk + 1 < kPreK / 16 && (!kInt4 || kk % 2 == 1)) load_words(kk + 1);
      // the step's 16 K rows of every token: 32 bytes on in a swizzled row
      const unsigned long long desc =
          kInt4 ? smem_desc(st + R::kXOff + (kk % 2) * (kPreBM * 64) + (kk / 2) * 32, 512, 2)
                : smem_desc(st + R::kXOff + kk * 32, 1024, 1);
#pragma unroll
      for (int a = 0; a < 2; ++a) fence_regs(*reinterpret_cast<float(*)[64]>(&acc[a][0][0]));
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wgmma_rs_m64n128k16(*reinterpret_cast<float(*)[64]>(&acc[a][0][0]), af[a], desc, 1);
      wgmma_commit();
      wgmma_wait<1>();  // the last step's products are done: its A buffer is free
#pragma unroll
      for (int a = 0; a < 2; ++a) fence_regs(*reinterpret_cast<float(*)[64]>(&acc[a][0][0]));
      if (kk == 0 && step > 0) mbar_arrive(empty + (step - 1) % kPreStages);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < 2; ++a) fence_regs(*reinterpret_cast<float(*)[64]>(&acc[a][0][0]));

  // acc[a][b][e]: e < 2 is column 4g + a, e >= 2 column 4g + 2 + a, of token
  // 8b + 2 t4 + e % 2: a lane holds four adjacent columns of each of its tokens
  const int valid = N - ncol;
  if (valid <= 0) return;
  float cs[4] = {1.f, 1.f, 1.f, 1.f};
  if (!kInt4 && partial == nullptr) load_scales4(cs, scale, 0, ncol, N, s_vec);
#pragma unroll
  for (int b = 0; b < kPreBM / 8; ++b)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * b + 2 * t4 + e;
      if (m >= M) continue;
      float v[4] = {acc[0][b][e], acc[1][b][e], acc[0][b][2 + e], acc[1][b][2 + e]};
      const size_t at = static_cast<size_t>(m) * N + ncol;
      if (partial != nullptr) {
        store4<float>(partial + static_cast<size_t>(blockIdx.z) * M * N + at, v, valid, c_vec);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] *= cs[j];
        store4<TOut>(C + at, v, valid, c_vec);
      }
    }
}

// Launch the prefill tile (the caller sums a split product's partials).
template <bool kInt4, typename TOut>
cudaError_t launch_prefill(const bf16* X, const unsigned char* W, const float* scale, TOut* C,
                           float* partial, int M, int N, int K, int G, int splits,
                           cudaStream_t s) {
  using R = PreRing<kInt4>;
  const int rows = kInt4 ? K / 2 : K;
  const int steps = (rows + R::kRows - 1) / R::kRows;
  const int r_split = ((steps + splits - 1) / splits) * R::kRows;  // each split whole stages
  const dim3 grid((M + kPreBM - 1) / kPreBM, (N + kPreBN - 1) / kPreBN, splits);
  const bool grouped = kInt4 && (G / 2) % R::kRows == 0;
  const bool a_vec = K % 8 == 0 && aligned16(X);
  const bool b_vec = N % 16 == 0 && aligned16(W);
  const bool s_vec = N % 4 == 0 && aligned16(scale);
  const bool c_vec = N % 4 == 0 && aligned16(splits > 1 ? static_cast<const void*>(partial)
                                                        : static_cast<const void*>(C));
  // TMA takes rows of whole 16-byte chunks from 16-byte aligned starts
  CUtensorMap mx{}, mw{}, ms{};
  bool tma = a_vec && b_vec && (!kInt4 || (grouped && s_vec));
  if (tma) {
    tma = encode_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, X, K, M, K * 2ull,
                     kInt4 ? 32 : 64, kPreBM,
                     kInt4 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B) &&
          encode_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, W, N, rows, N, 128, R::kRows,
                     CU_TENSOR_MAP_SWIZZLE_128B) &&
          (!kInt4 || encode_map(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N, K / G, N * 4ull,
                                kPreBN, 1, CU_TENSOR_MAP_SWIZZLE_NONE));
    if (!tma) return cudaErrorInvalidValue;
  }
  // the opt-in belongs to the current device, so it is set at every launch
  auto kernel = kInt4 && !grouped ? prefill_kernel<kInt4, true, TOut>
                                  : prefill_kernel<kInt4, false, TOut>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kPreThreads, R::kBytes, s>>>(mx, mw, ms, X, W, scale, C,
                                             splits > 1 ? partial : nullptr, M, N, K, G, r_split,
                                             tma, a_vec, b_vec, s_vec, c_vec);
  return cudaGetLastError();
}

}  // namespace wstream
