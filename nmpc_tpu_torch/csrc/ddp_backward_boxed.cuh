// Boxed DDP Riccati backward fed by the derivative sweep, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_pallas.py::
// backward_pallas_boxed (_backward_pallas_call_boxed, kernel
// _make_kernel_boxed, stage _riccati_stage_boxed, QP _boxqp_t).  Its plain
// version is nmpc_tpu_torch/kernels/ddp_backward.py::
// backward_stacked_boxed.  The stage is riccati_stage.cuh::
// riccati_stage_boxed, the QP boxqp.cuh::boxqp.
//
// What bounds it on the card: the per-lane dependent chain, not bytes.
// Per stage and lane it reads the seven derivative fields and the three
// bound fields (30 values at nx = nu = 2) and writes k and K (6 values);
// between them the thread runs the Q expansion and a projected-Newton QP
// whose iterations and Armijo steps depend on the lane's data.  One thread
// per lane at B = 1024 is 32 warps on 132 SMs.
//
// What the design does about it, as ddp_backward.cu:
//   * one thread per lane walks i = N-1 ... 0 with the (Vx, Vxx, dV, ok)
//     carry and the QP's warm start k_next in registers;
//   * stage i-1's fields and bounds are loaded before stage i is computed
//     (the TPU kernel's double-buffered stage DMA);
//   * the QP's loops are the thread's own loops: a lane that needs more
//     QP iterations or Armijo steps runs them without the rest of the
//     batch, where the TPU kernel masks a while loop over all lanes.
// Templated on the scalar type and (NX, NU); the wrapper
// (kernels/ddp_backward_boxed.py) instantiates it per (dtype, nx, nu) in a
// small generated unit.

#pragma once

#include "remat_common.cuh"
#include "riccati_stage.cuh"

namespace nmpc {

template <typename T>
struct BoxedFields {
  const T* __restrict__ Fx;
  const T* __restrict__ Fu;
  const T* __restrict__ Lx;
  const T* __restrict__ Lu;
  const T* __restrict__ Lxx;
  const T* __restrict__ Luu;
  const T* __restrict__ Lxu;
  const T* __restrict__ lower;
  const T* __restrict__ upper;
  const T* __restrict__ u;
};

template <typename T, int NX, int NU>
__device__ __forceinline__ void load_boxed_stage(const BoxedFields<T>& f,
                                                 int i, int b, int B,
                                                 Stage<T, NX, NU>& s,
                                                 Bounds<T, NU>& box) {
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      s.Fx[a][c] = f.Fx[idx3(i, a, c, NX, NX, b, B)];
      s.Lxx[a][c] = f.Lxx[idx3(i, a, c, NX, NX, b, B)];
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      s.Fu[a][c] = f.Fu[idx3(i, a, c, NX, NU, b, B)];
      s.Lxu[a][c] = f.Lxu[idx3(i, a, c, NX, NU, b, B)];
    }
    s.Lx[a] = f.Lx[idx2(i, a, NX, b, B)];
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    s.Lu[a] = f.Lu[idx2(i, a, NU, b, B)];
#pragma unroll
    for (int c = 0; c < NU; ++c) s.Luu[a][c] = f.Luu[idx3(i, a, c, NU, NU, b, B)];
    box.lower[a] = f.lower[idx2(i, a, NU, b, B)];
    box.upper[a] = f.upper[idx2(i, a, NU, b, B)];
    box.u[a] = f.u[idx2(i, a, NU, b, B)];
  }
}

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kLaneThreads)
backward_boxed_kernel(BoxedFields<T> f, const T* __restrict__ VxT,
                      const T* __restrict__ VxxT, const T* __restrict__ lam_in,
                      BoxQPParams qp, T* __restrict__ ks, T* __restrict__ Ks,
                      T* __restrict__ dV, unsigned char* __restrict__ ok_out,
                      int N, int B, int reg_type) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  Carry<T, NX> carry;
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    carry.Vx[a] = VxT[static_cast<size_t>(a) * B + b];
#pragma unroll
    for (int e = 0; e < NX; ++e)
      carry.Vxx[a][e] = VxxT[(static_cast<size_t>(a) * NX + e) * B + b];
  }
  carry.dV0 = T(0);
  carry.dV1 = T(0);
  carry.ok = true;
  const T lam = lam_in[b];
  T k_next[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) k_next[a] = T(0);

  Stage<T, NX, NU> cur, nxt;
  Bounds<T, NU> box, box_nxt;
  load_boxed_stage<T, NX, NU>(f, N - 1, b, B, cur, box);
  for (int i = N - 1; i >= 0; --i) {
    if (i > 0) load_boxed_stage<T, NX, NU>(f, i - 1, b, B, nxt, box_nxt);
    T k[NU], K[NU][NX];
    riccati_stage_boxed<T, NX, NU>(cur, box, lam, reg_type, qp, carry,
                                   k_next, k, K);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      ks[idx2(i, a, NU, b, B)] = k[a];
#pragma unroll
      for (int e = 0; e < NX; ++e) Ks[idx3(i, a, e, NU, NX, b, B)] = K[a][e];
    }
    cur = nxt;
    box = box_nxt;
  }
  dV[b] = carry.dV0;
  dV[static_cast<size_t>(B) + b] = carry.dV1;
  ok_out[b] = carry.ok ? 1 : 0;
}

// Launch on `stream`; returns cudaGetLastError() after the launch.  All
// arrays are contiguous batch-minor device arrays; ok is one byte per
// lane.  fields: Fx, Fu, Lx, Lu, Lxx, Luu, Lxu, lower, upper, u.
template <typename T, int NX, int NU>
int launch_backward_boxed(int N, int B, int reg_type, BoxQPParams qp,
                          const void* const* fields, const void* VxT,
                          const void* VxxT, const void* lam, void* ks,
                          void* Ks, void* dV, void* ok, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto at = [fields](int j) { return static_cast<const T*>(fields[j]); };
  const BoxedFields<T> f{at(0), at(1), at(2), at(3), at(4),
                         at(5), at(6), at(7), at(8), at(9)};
  const int blocks = (B + kLaneThreads - 1) / kLaneThreads;
  backward_boxed_kernel<T, NX, NU>
      <<<blocks, kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          f, static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
          static_cast<const T*>(lam), qp, static_cast<T*>(ks),
          static_cast<T*>(Ks), static_cast<T*>(dV),
          static_cast<unsigned char*>(ok), N, B, reg_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc
