// Helpers shared by the kernels that evaluate the problem's generated
// stage functions (ddp_backward_remat.cuh, ddp_forward_remat.cuh).
//
// A generated translation unit (nmpc_tpu_torch/kernels/tileval.py)
// defines, before it includes these templates,
//   gen_fields<T>(t, x, u, f)   the 2nx²+2nx·nu+nx+nu+nu² Riccati fields
//   gen_step<T>(t, x, u, o)     o[0..nx) next state, o[nx] running cost
//   gen_term<T>(t, x, o)        o[0] terminal cost
// as functions of one lane's scalars.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace nmpc {

// 32-thread blocks for the one-thread-per-lane kernels: B = 4096 lanes are
// 128 blocks, spread over as many SMs as the card has.
constexpr int kLaneThreads = 32;

// Stage i's time t0 + dt * i, as _stage_times computes it (dt * i, then
// + t0, each rounded: the _rn intrinsics are never contracted to an FMA).
__device__ __forceinline__ float stage_time(float t0, float dt, int i) {
  return __fadd_rn(t0, __fmul_rn(dt, static_cast<float>(i)));
}
__device__ __forceinline__ double stage_time(double t0, double dt, int i) {
  return __dadd_rn(t0, __dmul_rn(dt, static_cast<double>(i)));
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// Element (i, a, lane) of a batch-minor [N, n, B] array, and (i, a, c, lane)
// of an [N, n, m, B] one.
__device__ __forceinline__ size_t idx2(int i, int a, int n, int b, int B) {
  return (static_cast<size_t>(i) * n + a) * B + b;
}
__device__ __forceinline__ size_t idx3(int i, int a, int c, int n, int m,
                                       int b, int B) {
  return ((static_cast<size_t>(i) * n + a) * m + c) * B + b;
}

}  // namespace nmpc
