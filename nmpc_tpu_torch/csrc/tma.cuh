// Tensor Memory Accelerator (TMA, sm_90) loads into shared memory with an
// mbarrier per buffer, for the sweep-fed and packed DDP backward
// (ddp_backward.cuh, ddp_backward_packed.cuh).
//
// The host encodes a tensor map of a 3-D batch-minor array with
// cuTensorMapEncodeTiled, taken from libcuda at run time through the CUDA
// runtime's entry-point query, so a unit needs no -lcuda; the kernel takes
// the map as a __grid_constant__ argument.  One thread arms a buffer's
// barrier once with the bytes all its boxes bring and issues the copy of
// each box; every thread that reads the buffer waits on the barrier's
// phase.  A box that reaches past the array's bounds, below 0 included, is
// filled with zeros and still counts its full size.  A box lands at a
// 128-byte aligned shared-memory address.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace nmpc {

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, or nullptr.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// The map of a [n2, n1, n0] array of T at `base` whose rows of n0 values
// lie `ld` values apart (ld >= n0), read in boxes of [b2, b1, b0].  TMA
// asks a 16-byte aligned base, ld * sizeof(T) a multiple of 16, b0 *
// sizeof(T) a multiple of 16 and every box extent at most 256.  Returns a
// CUDA runtime error code: 0, cudaErrorInvalidValue for arguments TMA
// does not take, cudaErrorNotSupported without the entry point, or
// cudaErrorUnknown where libcuda refuses the map.
template <typename T>
int encode_map_3d(CUtensorMap* map, const void* base, int n0, int n1,
                  int n2, int ld, int b0, int b1, int b2) {
  const uint64_t row = static_cast<uint64_t>(ld) * sizeof(T);
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || row % 16 != 0 ||
      ld < n0 || (b0 * sizeof(T)) % 16 != 0 || b0 > 256 || b1 > 256 ||
      b2 > 256 || b0 <= 0 || b1 <= 0 || b2 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n0),
                              static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2)};
  const cuuint64_t strides[2] = {row, row * static_cast<uint64_t>(n1)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1),
                             static_cast<cuuint32_t>(b2)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, tma_type<T>(), 3, const_cast<void*>(base), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorUnknown);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Initialize a barrier for `count` arrivals per phase (a buffer's: the
// thread that arms it); the threads that use it meet at a barrier (of the
// warp or the block) before they do.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on `bar` (a consumer that is done with a buffer).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arm `bar` for the `bytes` of this phase's boxes: one arrival, the one
// the barrier was initialized for.  One thread, before it issues the
// boxes.
__device__ __forceinline__ void mbar_arm(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Load the box at (c0, c1, c2) of `map` into `dst` (128-byte aligned
// shared memory), its bytes counted on `bar`.  One thread.
__device__ __forceinline__ void tma_load_3d(const CUtensorMap& map,
                                            uint64_t* bar, void* dst,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Wait until the barrier has completed the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}

}  // namespace nmpc
