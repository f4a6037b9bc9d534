// mma.sync helpers shared by the tensor-core kernels (K2 attention.cu and
// attention_backward.cu, K6 window_attention.cu, K7 paged_attention.cu, and
// through wstream.cuh K8a and K9): bf16 m16n8k16 products with float32
// accumulators, their fragment loads from shared memory, the bf16 packing of
// two floats, the exact widening of int8 codes into bf16 fragments, 2^x, and
// float32 products on the tensor cores in 3xTF32 (K2's float32 forward and
// its backward).
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

// Four 8x8 b16 matrices from shared memory (a lane gives one row address).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16, "col")
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Two floats that are exact in bf16 (the widened int8 codes): their top halves.
__device__ __forceinline__ unsigned pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Byte `byte` of `biased` (four int8 codes + 128, i.e. codes ^ 0x80808080) as
// the exact float of its code: 0x4B000000 | n is the float 2^23 + n.
__device__ __forceinline__ float int8_of(unsigned biased, int byte) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | byte)) - 8388736.f;
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- 3xTF32: float32 products on the tensor cores ------------------------------
//
// A float x is split as hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact in
// float32), each rounded to nearest with ties away from zero, cvt.rna's
// rounding: the tensor core reads only the top 19 bits of a tf32 register and
// would truncate a raw float. hi + lo keeps about 21 of float32's 24
// significand bits, and a.b is taken as ah.bh + ah.bl + al.bh (al.bl, below
// 2^-22 of a.b, is dropped); products of two tf32 values are exact.

// x rounded to tf32, as bits: half a tf32 unit added to the magnitude, the 13
// bits below it cleared. For finite x this is cvt.rna.tf32.f32, which sm_90
// executes as about five instructions (its checks for NaN and infinity) where
// this takes two.
__device__ __forceinline__ unsigned tf32_of(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - __uint_as_float(hi));
}

// c (16 x 8, float32) += a (16 x 8, tf32, row-major) . b (8 x 8, tf32, "col"):
// lane (g, t) = (lane / 4, lane % 4) holds a[g][t], a[g + 8][t], a[g][t + 4],
// a[g + 8][t + 4], b[t][g], b[t + 4][g] and c[g][2t, 2t + 1], c[g + 8][2t, 2t + 1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[n0 + i] += a . b_i for i < G (and n0 + i < N) in 3xTF32, a given as (ah,
// al), b_i's two registers as (bh[i], bl[i]). The tensor cores align the
// addends of a product to the largest and truncate the rest, the accumulator
// included: a long sum kept in the accumulator loses the low bits of every
// product to the running total's exponent. So each step's three products
// start from zero (the two small ones, then the large one) and are added to c
// in float32, rounded to nearest; each is issued over the G accumulators in
// turn, so that no tensor-core instruction waits on the one before it.
template <int G, int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N][4], int n0, const unsigned (&ah)[4],
                                           const unsigned (&al)[4], const unsigned (&bh)[G][2],
                                           const unsigned (&bl)[G][2]) {
  float t[G][4];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (n0 + i < N) mma_tf32(t[i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (n0 + i < N) mma_tf32(t[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (n0 + i < N) mma_tf32(t[i], ah, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (n0 + i < N)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n0 + i][e] += t[i][e];
}

// Four floats split into A-fragment registers (ah, al).
__device__ __forceinline__ void split_a(unsigned (&ah)[4], unsigned (&al)[4], float x0, float x1,
                                        float x2, float x3) {
  split_tf32(x0, ah[0], al[0]);
  split_tf32(x1, ah[1], al[1]);
  split_tf32(x2, ah[2], al[2]);
  split_tf32(x3, ah[3], al[3]);
}

// Two floats split into B-fragment registers (bh, bl).
__device__ __forceinline__ void split_b(unsigned (&bh)[2], unsigned (&bl)[2], float x0,
                                        float x1) {
  split_tf32(x0, bh[0], bl[0]);
  split_tf32(x1, bh[1], bl[1]);
}

// Float32 tiles in shared memory for 3xTF32 fragments: DP columns (a multiple
// of 8) in rows LD words apart, LD = 8 (mod 16), with column bit 3 flipped on
// rows whose bit 2 is set. A depth of 8 columns is read in the order
// (0, 2, 4, 6, 1, 3, 5, 7), so that a lane's A pair (t, t + 4) or B pair is
// columns (2t, 2t + 1): one 8-byte read of row g (rows 0-3 and 4-7 of a
// half-warp land on the 32 banks). A tile read as the B operand of a product
// over its rows (k = row) takes rows (2t, 2t + 1) of column g: 4-byte reads
// that the flipped bit spreads over the 32 banks too.
template <int DP>
struct F32Tile {
  static constexpr int LD = 16 * ((DP + 15) / 16) + 8;
  __device__ __forceinline__ static int at(int r, int c) { return r * LD + (c ^ ((r & 4) << 1)); }
};

// rows [t0, t0 + rows) of one (batch, head) into the F32Tile at dst, DP
// columns, zero past S and past D: 16-byte cp.async chunks when `vec` (D % 4
// == 0 and 16-byte aligned pointers), else 4-byte ones. The caller commits
// and waits.
template <int DP>
__device__ __forceinline__ void stage_f32(float* dst, const float* __restrict__ src, int t0,
                                          int rows, int S, int D, size_t row, bool vec) {
  using T = F32Tile<DP>;
  const int w = vec ? 4 : 1;  // floats a copy
  const int per_row = DP / w;
  for (int c = threadIdx.x; c < rows * per_row; c += blockDim.x) {
    const int r = c / per_row, cc = (c % per_row) * w;
    const int t = t0 + r;
    const bool ok = t < S && cc < D;
    const float* s = src + (ok ? static_cast<size_t>(t) * row + cc : 0);
    if (vec)
      cp_async16(dst + T::at(r, cc), s, ok);
    else
      cp_async4(dst + T::at(r, cc), s, ok);
  }
}

// The A fragment (hi, lo) of depth step kb from the 16 rows at r of an
// F32Tile: rows (g, g + 8), columns (2t, 2t + 1) of the step.
template <int DP>
__device__ __forceinline__ void tf32_a_frag(unsigned (&ah)[4], unsigned (&al)[4],
                                            const float* tile, int r, int kb, int g, int t4) {
  using T = F32Tile<DP>;
  const float2 x0 = *reinterpret_cast<const float2*>(tile + T::at(r + g, kb * 8 + 2 * t4));
  const float2 x1 = *reinterpret_cast<const float2*>(tile + T::at(r + g + 8, kb * 8 + 2 * t4));
  split_a(ah, al, x0.x, x1.x, x0.y, x1.y);
}

// acc[n] += A . B^T in 3xTF32 over depth DP for NT tiles of 8 rows of B: A
// the 16 rows of F32Tile `a` at ra, B's rows n * 8 + g of F32Tile `b` (the
// product's k is the column; S = Q.K^T, dP = dO.V^T and their transposes).
template <int DP, int NT>
__device__ __forceinline__ void tf32_product_over_columns(float (&acc)[NT][4], const float* a,
                                                          int ra, const float* b, int g,
                                                          int t4) {
  using T = F32Tile<DP>;
  constexpr int G = NT < 4 ? NT : 4;  // accumulators a round
#pragma unroll 1  // a step at a time: unrolled, the loads ran ahead and spilled at D = 72
  for (int kb = 0; kb < DP / 8; ++kb) {
    unsigned ah[4], al[4];
    tf32_a_frag<DP>(ah, al, a, ra, kb, g, t4);
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += G) {
      unsigned bh[G][2], bl[G][2];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float2 y =
            *reinterpret_cast<const float2*>(b + T::at((n0 + i) * 8 + g, kb * 8 + 2 * t4));
        split_b(bh[i], bl[i], y.x, y.y);
      }
      mma_3xtf32<G>(acc, n0, ah, al, bh, bl);
    }
  }
}

// out[n] += X . B in 3xTF32 over the NT * 8 rows of F32Tile `b` (the
// product's k is the row: P.V, dS.K, P^T.dO, dS^T.Q), X the accumulator
// fragments x[NT][4] of an earlier product, 16 rows by NT * 8 columns. The
// accumulator holds a lane's columns (2t, 2t + 1), an A fragment takes (t,
// t + 4): read in the order (0, 2, 4, 6, 1, 3, 5, 7) within each 8, with B's
// rows in that order too, the accumulator is the A fragment as it stands.
template <int DP, int NT>
__device__ __forceinline__ void tf32_product_over_rows(float (&out)[DP / 8][4],
                                                       const float (&x)[NT][4], const float* b,
                                                       int g, int t4) {
  using T = F32Tile<DP>;
  constexpr int N8 = DP / 8, G = 2;  // accumulators a round: 4 spilled K2's backward at D = 72
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    unsigned ah[4], al[4];
    split_a(ah, al, x[ks][0], x[ks][2], x[ks][1], x[ks][3]);
    const int j = ks * 8 + 2 * t4;
#pragma unroll
    for (int n0 = 0; n0 < N8; n0 += G) {
      unsigned bh[G][2], bl[G][2];
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (n0 + i < N8)
          split_b(bh[i], bl[i], b[T::at(j, (n0 + i) * 8 + g)],
                  b[T::at(j + 1, (n0 + i) * 8 + g)]);
      mma_3xtf32<G>(out, n0, ah, al, bh, bl);
    }
  }
}
