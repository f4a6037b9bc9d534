// K3: fused rescale + normalize of uint8 pixels.
//
// Replaces the TPU kernel multimodal_colpali_tpu/ops/preprocess.py::_normalize_kernel
// (pl.pallas_call at preprocess.py:54, wrapper normalize_images):
//
//   out[e] = bf16(x[e] * scale_c + bias_c),  c = e % 3 (NHWC, 3 channels),
//
// with scale_c = 1 / (255 std_c) and bias_c = -mean_c / std_c in float32,
// the product and sum one fmaf, rounded to nearest even.
//
// What bounds it on an H100: device memory alone. Each element is one byte
// in and two bytes out with one multiply-add between, no reuse and no
// tensor-core work (8 x 448 x 448 x 3 pixels: 14.4 MB, 4.3 us at 3.35 TB/s).
//
// Design. A thread takes one 48-byte chunk, 16 pixels: the least common
// multiple of a 16-byte load and 3 channels, so byte j of a chunk has channel
// j % 3 whatever the chunk, and the scales and biases are register constants
// chosen at compile time. A warp's 32 chunks (1,536 bytes) come in by three
// 16-byte loads a lane, neighbouring lanes on neighbouring addresses, into the
// warp's slot of shared memory; each lane reads its own chunk back, widens each
// byte to float exactly (0x4B000000 | byte is the float 2^23 + byte), applies
// one fmaf, rounds pairs to bf16x2, and writes its 96 bytes into the slot, which
// the warp stores by six coalesced 16-byte stores a lane. The grid comes from
// the element count alone. A warp whose chunks pass the end (n % 1,536 != 0)
// and every warp of a pointer that is not 16-byte aligned go element by element
// in the same kernel, a lane its own chunk.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 48;               // bytes (pixels x 3) a thread
constexpr int kWarpBytes = 32 * kChunk;  // a warp's pixels; its output is twice that

struct Affine {
  float scale[3], bias[3];
};

// Byte `byte` of `word` as the exact float of its value.
__device__ __forceinline__ float byte_f32(unsigned word, int byte) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | byte)) - 8388608.f;
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const uint8_t* __restrict__ x, bf16* __restrict__ out, long long n, Affine a) {
  __shared__ uint4 slot[kWarps][2 * kWarpBytes / 16];  // a warp's input, then its output
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long w0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) * kWarpBytes;
  if (w0 >= n) return;
  if (kVec && w0 + kWarpBytes <= n) {
    uint4* st = slot[warp];
    const uint4* src = reinterpret_cast<const uint4*>(x + w0);
#pragma unroll
    for (int i = 0; i < 3; ++i) st[lane + 32 * i] = __ldg(src + lane + 32 * i);
    __syncwarp();
    const uint4 v0 = st[3 * lane], v1 = st[3 * lane + 1], v2 = st[3 * lane + 2];
    __syncwarp();  // every lane holds its chunk before the output goes over the input
    const unsigned word[kChunk / 4] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y,
                                       v1.z, v1.w, v2.x, v2.y, v2.z, v2.w};
    unsigned packed[kChunk / 2];
#pragma unroll
    for (int j = 0; j < kChunk; j += 2)
      packed[j / 2] =
          pack2(fmaf(byte_f32(word[j / 4], j % 4), a.scale[j % 3], a.bias[j % 3]),
                fmaf(byte_f32(word[(j + 1) / 4], (j + 1) % 4), a.scale[(j + 1) % 3],
                     a.bias[(j + 1) % 3]));
#pragma unroll
    for (int i = 0; i < kChunk / 8; ++i)
      st[6 * lane + i] =
          make_uint4(packed[4 * i], packed[4 * i + 1], packed[4 * i + 2], packed[4 * i + 3]);
    __syncwarp();
    uint4* dst = reinterpret_cast<uint4*>(out + w0);
#pragma unroll
    for (int i = 0; i < 6; ++i) dst[lane + 32 * i] = st[lane + 32 * i];
    return;
  }
  const long long e0 = w0 + lane * kChunk;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {  // e0 % 3 == 0: element e0 + j has channel j % 3
    if (e0 + j >= n) break;
    out[e0 + j] = __float2bfloat16_rn(
        fmaf(static_cast<float>(x[e0 + j]), a.scale[j % 3], a.bias[j % 3]));
  }
}

}  // namespace

// out [n] bf16 = x [n] uint8 (NHWC, 3 channels) * scale_c + bias_c, c = e % 3.
// out must be 16-byte aligned (the wrapper allocates it); x may lie anywhere.
extern "C" int normalize_launch(const void* x, void* out, long long n, float s0, float s1,
                                float s2, float b0, float b1, float b2, void* stream) {
  if (n <= 0 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Affine a = {{s0, s1, s2}, {b0, b1, b2}};
  const long long blocks = (n + kWarps * kWarpBytes - 1) / (kWarps * kWarpBytes);
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto src = static_cast<const uint8_t*>(x);
  const auto dst = static_cast<bf16*>(out);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0)
    normalize_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(src, dst, n, a);
  else
    normalize_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(src, dst, n, a);
  return static_cast<int>(cudaGetLastError());
}
