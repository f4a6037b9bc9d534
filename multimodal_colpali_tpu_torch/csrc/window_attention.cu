// K6: attention over independent windows, no mask, exact float32 softmax.
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
// Design. One block owns one window. Its q, k and v are copied into shared
// memory by cp.async (16-byte chunks where rows are whole chunks), zero-padded
// to SP = S and DP = D rounded up to 16. Three paths:
//   - bfloat16, S <= 144 and D <= 32 (ColFlor: every DaViT stage has 12 x 12
//     windows and head_dim 32): 3 warps, each taking 16 query rows at a time,
//     with everything in registers in the fragment layouts of mma.sync
//     m16n8k16. Q.K^T gives a row tile's [16, 144] float32 logits (72 a lane);
//     each row's exact float32 softmax (expf, a true division by the sum) is
//     reduced over the 4 lanes of a quad; the probabilities, rounded to bf16,
//     are packed straight into the A fragments of P.V, so P never goes to
//     shared memory; K and V fragments come by ldmatrix (V transposed). A block
//     takes 34.5 KB, so four windows share an SM.
//   - bfloat16, other shapes (S <= 512, D <= 128): 4 warps on 16 x 16 x 16 WMMA
//     tiles through a [16, SP] float32 logit strip in shared memory per warp;
//     the softmax runs in registers and writes the bf16 probabilities over the
//     row's own logits; P.V accumulates in registers and leaves through the
//     strip, rows past S and columns past D masked.
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

// The bf16 path for windows of up to 16 KB keys and a head_dim of up to
// 16 DB (ColFlor's 144 and 32 take KB = 9, DB = 2): each warp keeps a row
// tile's logits, probabilities and output in registers, in the fragment
// layouts of mma.sync m16n8k16 (the probabilities of two logit tiles are
// exactly the A operand of the P.V product, so P never goes to shared memory);
// K and V fragments come from shared memory by ldmatrix.
constexpr int kMmaWarps = 3;
template <int KB, int DB>
__global__ void __launch_bounds__(kMmaWarps * 32)
window_attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int S, int D, float scale,
                     bool vec) {
  constexpr int SP = 16 * KB, DP = 16 * DB, LD = DP + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + SP * LD;
  bf16* Vs = Ks + SP * LD;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // a fragment's row and column pair
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  load_tile_bf16(Qs, q + base, S, D, SP, DP, LD, vec);
  load_tile_bf16(Ks, k + base, S, D, SP, DP, LD, vec);
  load_tile_bf16(Vs, v + base, S, D, SP, DP, LD, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int it = warp; it * 16 < S; it += kMmaWarps) {
    unsigned qa[DB][4];
#pragma unroll
    for (int kb = 0; kb < DB; ++kb)
      ldmatrix_x4(qa[kb], Qs + (it * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD + kb * 16 +
                              8 * (lane / 16));
    float sc[2 * KB][4];  // logits: 2 KB tiles of 8 keys; rows g (0, 1) and g + 8 (2, 3)
#pragma unroll
    for (int j = 0; j < 2 * KB; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < KB; ++jp) {
      if (jp * 16 >= S) break;
#pragma unroll
      for (int kb = 0; kb < DB; ++kb) {
        unsigned b[4];
        ldmatrix_x4(b, Ks + (jp * 16 + lane % 8 + 8 * (lane / 16)) * LD + kb * 16 +
                           8 * ((lane / 8) % 2));
        mma_bf16(sc[2 * jp], qa[kb], b[0], b[1]);
        mma_bf16(sc[2 * jp + 1], qa[kb], b[2], b[3]);
      }
    }
    // exact float32 softmax of rows g and g + 8 over the S real keys; each
    // row's 144 values lie in the 4 lanes of a quad
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * KB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool real = j * 8 + 2 * t + e < S;
        sc[j][e] = real ? sc[j][e] * scale : -INFINITY;
        sc[j][2 + e] = real ? sc[j][2 + e] * scale : -INFINITY;
        m0 = fmaxf(m0, sc[j][e]);
        m1 = fmaxf(m1, sc[j][2 + e]);
      }
#pragma unroll
    for (int x = 1; x < 4; x *= 2) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, x));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, x));
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * KB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool real = j * 8 + 2 * t + e < S;
        sc[j][e] = real ? expf(sc[j][e] - m0) : 0.f;
        sc[j][2 + e] = real ? expf(sc[j][2 + e] - m1) : 0.f;
        s0 += sc[j][e];
        s1 += sc[j][2 + e];
      }
#pragma unroll
    for (int x = 1; x < 4; x *= 2) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, x);
      s1 += __shfl_xor_sync(0xffffffffu, s1, x);
    }
    // P.V: the probabilities, rounded to bf16, are the A fragments
    float acc[2 * DB][4];
#pragma unroll
    for (int n = 0; n < 2 * DB; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < KB; ++jp) {
      if (jp * 16 >= S) break;
      const unsigned pa[4] = {pack_bf16(sc[2 * jp][0] / s0, sc[2 * jp][1] / s0),
                              pack_bf16(sc[2 * jp][2] / s1, sc[2 * jp][3] / s1),
                              pack_bf16(sc[2 * jp + 1][0] / s0, sc[2 * jp + 1][1] / s0),
                              pack_bf16(sc[2 * jp + 1][2] / s1, sc[2 * jp + 1][3] / s1)};
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        unsigned b[4];
        ldmatrix_x4_trans(b, Vs + (jp * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD + db * 16 +
                                 8 * (lane / 16));
        mma_bf16(acc[2 * db], pa, b[0], b[1]);
        mma_bf16(acc[2 * db + 1], pa, b[2], b[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2 * DB; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = it * 16 + g + 8 * h;
        if (row >= S) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * t + e;
          if (col < D) o[base + static_cast<size_t>(row) * D + col] = __float2bfloat16(acc[n][2 * h + e]);
        }
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

}  // namespace

// out [N, S, D] = attention of q over k, v [N, S, D] per window, no mask;
// dtype 0 = float32, 1 = bfloat16 (q, k, v and out alike).
extern "C" int window_attention_launch(const void* q, const void* k, const void* v, void* out,
                                       int N, int S, int D, float scale, int dtype,
                                       void* stream) {
  if (N <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(q) && aligned16(k) && aligned16(v);
  if (dtype == kBFloat16) {
    const bool v8 = aligned && D % 8 == 0;
    if (S <= 144 && D <= 32)  // ColFlor's windows: fragments in registers
      return static_cast<int>(launch(window_attention_mma<9, 2>, kMmaWarps * 32,
                                     3ull * 144 * (32 + 8) * 2, static_cast<const bf16*>(q),
                                     static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                                     static_cast<bf16*>(out), N, S, D, scale, v8, s));
    if (S > 32 * kMaxPer || D > 16 * kMaxDT) return static_cast<int>(cudaErrorInvalidConfiguration);
    return static_cast<int>(launch(window_attention_bf16, kThreads, Bf16Layout(S, D).bytes(),
                                   static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                   static_cast<const bf16*>(v), static_cast<bf16*>(out), N, S,
                                   D, scale, v8, s));
  }
  if (dtype == kFloat32)
    return static_cast<int>(launch(window_attention_f32, kThreads, f32_bytes(S, D),
                                   static_cast<const float*>(q), static_cast<const float*>(k),
                                   static_cast<const float*>(v), static_cast<float*>(out), N, S,
                                   D, scale, false, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
