// Asynchronous copies from global into shared memory (cp.async): one element
// at a time for the kernels whose rows need not be 16-byte aligned
// (lowrank_contract.cu), 16 bytes at a time for records the wrapper packs
// aligned (radial_mvm.cu).

#pragma once

#include <cuda_runtime.h>

namespace cp_async {

// Asynchronous copy of one element into shared memory; src_bytes = 0
// zero-fills it.
template <int BYTES>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(BYTES), "r"(src_bytes)
               : "memory");
}
// Asynchronous copy of 16 bytes into shared memory, bypassing L1; both
// addresses 16-byte aligned; src_bytes = 0 zero-fills them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

}  // namespace cp_async
