// Asynchronous device-to-shared copies (cp.async, sm_80 and later), for
// the kernel that stages stage fields in shared memory by its own threads:
// the chunked DDP backward (ddp_backward_chunked.cuh).
//
// Each copy moves one scalar of one lane: a warp's copies of a field
// element cover neighbouring lanes, so they coalesce into one request per
// run of lanes.  A copy holds no register while it is in flight, so a
// thread can have a whole chunk of stages in flight at once.  After
// cp_async_wait the executing thread sees its own copies; K2 meets its
// warp at __syncwarp before it reads values another thread copied.

#pragma once

#include <cuda_runtime.h>

namespace nmpc {

// Copy sizeof(T) bytes (4 or 8) from device memory to shared memory,
// through L1 (.ca).
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte copies");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(sizeof(T))
               : "memory");
}

// Close the group of copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most PENDING committed groups are still in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Raise a kernel's dynamic shared-memory limit to `bytes` when it is above
// the 48 KB every kernel gets without asking (H100: up to 227 KB per
// block); returns the CUDA error of the call, 0 when none was needed.
template <typename Kernel>
int allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace nmpc
