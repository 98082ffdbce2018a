// FMPC forward Δx/Δu recursion for Hopper (sm_90a).
//
// Replaces the TPU kernel nmpc_tpu/kernels/fmpc_forward_pallas.py::
// _forward_fmpc_call (kernel _make_kernel; entry
// forward_fmpc_deltas_pallas).  Its plain version is
// nmpc_tpu_torch/kernels/fmpc_forward.py::forward_fmpc_deltas_plain:
//   du_i = K_i dx_i + k_i,  dx_{i+1} = A_i dx_i + B_i du_i + x_bar_i,
// dxs[i] the delta before stage i, dxs[N] the final carry.  Each mat-vec
// sums in index order; A dx and B du are summed apart and then added, as
// the plain version's two torch.sum calls are.
//
// What bounds it on the card: the dependent chain of N stages per lane.
// Per stage and lane it reads A, B, x_bar, k, K (29 values at the
// cart-pole's (nx, nu) = (4, 1)) and writes dx, du (5); the arithmetic is
// ~60 flops.  One thread per lane keeps dx in registers and loads stage
// i+1's coefficients before stage i is computed (they do not depend on
// dx), the TPU kernel's double-buffered stage DMA.  The Δλ/Δs/Δν
// post-passes stay torch ops, as they stay XLA in JAX.
// Templated on the scalar type and (NX, NU); the wrapper
// (kernels/fmpc_forward.py) instantiates it per (nx, nu, dtype).

#pragma once

#include "remat_common.cuh"

namespace nmpc {

template <typename T, int NX, int NU>
struct FwdStage {
  T A[NX][NX];
  T Bm[NX][NU];
  T xb[NX];
  T k[NU];
  T K[NU][NX];
};

template <typename T, int NX, int NU>
__device__ __forceinline__ void load_fwd_stage(
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ xb, const T* __restrict__ ks,
    const T* __restrict__ Ks, int i, int b, int B, FwdStage<T, NX, NU>& s) {
#pragma unroll
  for (int r = 0; r < NX; ++r) {
#pragma unroll
    for (int c = 0; c < NX; ++c) s.A[r][c] = A[idx3(i, r, c, NX, NX, b, B)];
#pragma unroll
    for (int c = 0; c < NU; ++c) s.Bm[r][c] = Bm[idx3(i, r, c, NX, NU, b, B)];
    s.xb[r] = xb[idx2(i, r, NX, b, B)];
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    s.k[a] = ks[idx2(i, a, NU, b, B)];
#pragma unroll
    for (int c = 0; c < NX; ++c) s.K[a][c] = Ks[idx3(i, a, c, NU, NX, b, B)];
  }
}

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kLaneThreads)
fmpc_forward_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ xb, const T* __restrict__ ks,
                    const T* __restrict__ Ks, const T* __restrict__ dx0,
                    T* __restrict__ dxs, T* __restrict__ dus, int N, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T dx[NX];
#pragma unroll
  for (int r = 0; r < NX; ++r) dx[r] = dx0[static_cast<size_t>(r) * B + b];

  FwdStage<T, NX, NU> cur, nxt;
  load_fwd_stage<T, NX, NU>(A, Bm, xb, ks, Ks, 0, b, B, cur);
  for (int i = 0; i < N; ++i) {
    if (i + 1 < N) load_fwd_stage<T, NX, NU>(A, Bm, xb, ks, Ks, i + 1, b, B,
                                             nxt);
    T du[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T s = cur.K[a][0] * dx[0];
#pragma unroll
      for (int c = 1; c < NX; ++c) s = s + cur.K[a][c] * dx[c];
      du[a] = s + cur.k[a];
      dus[idx2(i, a, NU, b, B)] = du[a];
    }
    T dxn[NX];
#pragma unroll
    for (int r = 0; r < NX; ++r) {
      dxs[idx2(i, r, NX, b, B)] = dx[r];
      T sa = cur.A[r][0] * dx[0];
#pragma unroll
      for (int c = 1; c < NX; ++c) sa = sa + cur.A[r][c] * dx[c];
      T sb = cur.Bm[r][0] * du[0];
#pragma unroll
      for (int a = 1; a < NU; ++a) sb = sb + cur.Bm[r][a] * du[a];
      dxn[r] = sa + sb + cur.xb[r];
    }
#pragma unroll
    for (int r = 0; r < NX; ++r) dx[r] = dxn[r];
    cur = nxt;
  }
#pragma unroll
  for (int r = 0; r < NX; ++r) dxs[idx2(N, r, NX, b, B)] = dx[r];
}

// Launch on `stream`; returns cudaGetLastError() after the launch.  All
// arrays are contiguous batch-minor device arrays.
template <typename T, int NX, int NU>
int launch_fmpc_forward(int N, int B, const void* A, const void* Bm,
                        const void* xb, const void* ks, const void* Ks,
                        const void* dx0, void* dxs, void* dus, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kLaneThreads - 1) / kLaneThreads;
  fmpc_forward_kernel<T, NX, NU>
      <<<blocks, kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(A), static_cast<const T*>(Bm),
          static_cast<const T*>(xb), static_cast<const T*>(ks),
          static_cast<const T*>(Ks), static_cast<const T*>(dx0),
          static_cast<T*>(dxs), static_cast<T*>(dus), N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc
