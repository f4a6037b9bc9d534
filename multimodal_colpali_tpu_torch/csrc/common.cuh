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

// cp.async (sm_80+): copy 16 (or 4) bytes from device to shared memory
// without passing through registers; with `valid` false nothing is read and
// the destination is zero-filled. commit closes a group of copies; wait<N>
// returns once at most N of this thread's groups are still in flight.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// mbarriers (sm_90) in shared memory, for copies that report their bytes to
// a barrier (TMA and bulk copies) instead of to the issuing thread.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {  // release
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
// arrives, and makes the phase wait for `bytes` more of TMA copies
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}
// arrives once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* b, int parity) {  // acquire
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}

// Bulk copy (sm_90): `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device memory to shared memory in one request, counted on
// barrier `b` as they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes,
                                          unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// Orders this thread's generic-proxy accesses to shared memory before later
// async-proxy ones (bulk copies into a buffer that was read or written).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
