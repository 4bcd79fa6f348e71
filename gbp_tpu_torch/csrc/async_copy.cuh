// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later), for the rings of shared-memory stages of segsum.cu and
// windows.cu: a thread issues copies, closes them into a group with
// cp_async_commit(), and cp_async_wait<N>() returns once at most N of its
// groups are still in flight.  A __syncthreads() after the wait makes the
// other threads' copies visible.
#pragma once
#include <cuda_runtime.h>

namespace gbp {

// 16 bytes, both addresses 16-byte aligned; bypasses L1 (streamed once).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace gbp
