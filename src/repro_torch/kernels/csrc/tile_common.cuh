// What the dense-tile kernels of Block-ILU(k) share (trsm.cu, tile_lu.cu):
// the warp constants, the rounded divide and the acquire/release pair of
// a counter in shared memory.
#pragma once
#include <cuda_runtime.h>

#define LANES 32
#define FULL_MASK 0xffffffffu

// num / u, rounded to nearest. A zero numerator, common in the sparse
// tiles of Block-ILU, gives the signed zero itself when u is finite and
// nonzero: __fdiv_rn takes a slow path for it. The warp passes the same
// num and u to every lane, so the branch never diverges.
__device__ __forceinline__ float divide(float num, float u) {
  if (num == 0.0f && u != 0.0f && isfinite(u))
    return __int_as_float((__float_as_int(num) ^ __float_as_int(u)) & 0x80000000);
  return __fdiv_rn(num, u);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A counter in shared memory, read with acquire and written with release
// at block scope: what a thread wrote before its release is seen by a
// thread that reads the new value with acquire.
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"(smem_addr(p)), "r"(v) : "memory");
}
