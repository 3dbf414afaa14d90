// Helpers shared by the kernels that stage device memory in shared memory
// with cp.async, and by those that combine split partial results in the
// last-arriving block of a launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace zg2 {

// Copy 16 bytes (gmem 16-byte aligned) or 4 bytes (4-byte aligned) to
// shared memory asynchronously. With ok false nothing is read and the
// destination is zero-filled (gmem must still be an aligned address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The split combine's ticket: every block of a group writes its partial
// result, then calls this. It returns true in exactly one block, the last
// to arrive, after which every partial of the group is visible to it (read
// them with __ldcg). That block resets the counter to 0 for the next
// launch on the stream. Call from every thread of the block.
__device__ __forceinline__ bool last_to_arrive(int* counter, int group_size) {
  __shared__ int last;
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == group_size - 1;
    if (last) *counter = 0;  // every other block of the group has taken its ticket
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

}  // namespace zg2
