// cp.async copies and fragment loads shared by the kernels on Hopper's CUDA
// cores: the f32 GEMM (tile_gemm.cuh) and the f32 flash attention
// (flash_attention.cu).
//
// cp_async4 / cp_async16 copy 4 or 16 bytes from device memory into shared
// memory without passing through registers; the source size operand cuts a
// copy at the edge of a tensor (bytes past it land as zero), so ragged
// shapes need no padded copies.  A copy of 0 bytes reads nothing but still
// names a valid address.  cp_commit closes a group of copies and
// cp_wait<N> waits until at most N of this thread's groups are in flight.
// ld_frag loads V consecutive floats from shared memory (LDS.128 for V = 4
// at a 16-byte aligned address).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage, as in tile_gemm.cuh: each library keeps its own copy.
namespace repro {
namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (4 or 0) from src and zero the rest of the 4 bytes at dst.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Copy `bytes` (0 to 16) from src and zero the rest of the 16 bytes at dst.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int V>
__device__ __forceinline__ void ld_frag(float* d, const float* s) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    d[0] = v.x;
    d[1] = v.y;
  } else {
    d[0] = *s;
  }
}

}  // namespace
}  // namespace repro
