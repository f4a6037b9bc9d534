// Helpers shared by the package's CUDA kernels.
//
// Every .cu file in this directory is built on its own into a shared library
// with a plain C interface (see _build.py) and loaded with ctypes. Each entry
// point returns cudaGetLastError() after its launch, so a launch that CUDA
// refuses (bad configuration, too much shared memory) reaches the
// Python wrapper as a non-zero code instead of disappearing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Element-type codes the Python wrappers pass in.
enum DtypeCode : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(signed char x) { return static_cast<float>(x); }

// x rounded to the nearest bfloat16 (ties to even) and widened back.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
