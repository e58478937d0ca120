// Element-wise asynchronous copies from global into shared memory (cp.async),
// shared by the kernels that stage a tile's records one element at a time
// because their rows need not be 16-byte aligned (radial_mvm.cu,
// lowrank_contract.cu).

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
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

}  // namespace cp_async
