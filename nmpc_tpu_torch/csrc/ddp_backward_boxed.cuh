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
// between them the lane runs the Q expansion and a projected-Newton QP
// whose iterations and Armijo candidates depend on its data.  The QP sets
// the pace: on the vertical model's first iteration (B=1024, N=100, fp32)
// a lane runs 1.76 QP iterations and 7.0 Armijo candidates per stage on
// average (133 at most), and with one thread per lane a warp waits for
// the slowest of its 32 lanes (16.8 candidates per stage on average).
// With one thread per lane, B=1024 is also 32 warps on 132 SMs.
//
// What the design does about it:
//   * a group of kQpGroup threads per lane (boxqp.cuh::LaneGroup), so a
//     32-thread block holds 32 / kQpGroup lanes: a stage costs the warp
//     the slowest of those lanes, and B=1024 is 1024 * kQpGroup / 32
//     one-warp blocks over the SMs;
//   * every thread of a group walks i = N-1 ... 0 with the lane's
//     (Vx, Vxx, dV, ok) carry and the QP's warm start k_next in registers
//     and runs the serial work (loads, Q expansion, QP iterations, K solve,
//     value update) on the same values, so the group's branches agree;
//     rank 0 stores;
//   * the QP's Armijo search takes kQpGroup candidates at a time, one per
//     thread, from the block's step table in shared memory;
//   * the QP's loops run until the warp's last lane is done, and a slot
//     past the batch's end runs the last lane's data without storing, so
//     the whole warp meets at every ballot and shuffle;
//   * stage i-1's fields and bounds are loaded before stage i is computed
//     (the TPU kernel's double-buffered stage DMA).
// Templated on the scalar type, (NX, NU) and the group size; the wrapper
// (kernels/ddp_backward_boxed.py) instantiates it per (dtype, nx, nu) in a
// small generated unit.

#pragma once

#include "cp_async.cuh"
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

template <typename T, int NX, int NU, int G>
__global__ void __launch_bounds__(kLaneThreads)
backward_boxed_kernel(BoxedFields<T> f, const T* __restrict__ VxT,
                      const T* __restrict__ VxxT, const T* __restrict__ lam_in,
                      BoxQPParams qp, T* __restrict__ ks, T* __restrict__ Ks,
                      T* __restrict__ dV, unsigned char* __restrict__ ok_out,
                      int N, int B, int reg_type) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* steps = reinterpret_cast<T*>(smem_raw);
  fill_step_table<T>(steps, qp);
  // A slot past the batch's end runs the last lane's data and stores
  // nothing: every thread of a warp must reach the QP's exchanges.
  const int lane = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const int b = lane < B ? lane : B - 1;
  const bool writer = lane < B && LaneGroup<G>::rank() == 0;

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
    riccati_stage_boxed<T, NX, NU, G>(cur, box, lam, reg_type, qp, steps,
                                      carry, k_next, k, K);
    if (writer) {
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        ks[idx2(i, a, NU, b, B)] = k[a];
#pragma unroll
        for (int e = 0; e < NX; ++e)
          Ks[idx3(i, a, e, NU, NX, b, B)] = K[a][e];
      }
    }
    cur = nxt;
    box = box_nxt;
  }
  if (writer) {
    dV[b] = carry.dV0;
    dV[static_cast<size_t>(B) + b] = carry.dV1;
    ok_out[b] = carry.ok ? 1 : 0;
  }
}

// Launch on `stream`; returns the CUDA error of the launch (or of raising
// the shared-memory limit for a step table above 48 KB).  All arrays are
// contiguous batch-minor device arrays; ok is one byte per lane.  fields:
// Fx, Fu, Lx, Lu, Lxx, Luu, Lxu, lower, upper, u.  G is the threads per
// lane; kQpGroup unless a measurement asks for another.
template <typename T, int NX, int NU, int G = kQpGroup>
int launch_backward_boxed(int N, int B, int reg_type, BoxQPParams qp,
                          const void* const* fields, const void* VxT,
                          const void* VxxT, const void* lam, void* ks,
                          void* Ks, void* dV, void* ok, void* stream) {
  if (B <= 0 || N <= 0 || qp.max_ls_iter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto at = [fields](int j) { return static_cast<const T*>(fields[j]); };
  const BoxedFields<T> f{at(0), at(1), at(2), at(3), at(4),
                         at(5), at(6), at(7), at(8), at(9)};
  constexpr int lanes = kLaneThreads / G;   // lanes per block
  const int blocks = (B + lanes - 1) / lanes;
  const size_t smem = static_cast<size_t>(qp.max_ls_iter + 1) * sizeof(T);
  const int err = allow_dynamic_smem(backward_boxed_kernel<T, NX, NU, G>,
                                     smem);
  if (err != 0) return err;
  backward_boxed_kernel<T, NX, NU, G>
      <<<blocks, kLaneThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          f, static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
          static_cast<const T*>(lam), qp, static_cast<T*>(ks),
          static_cast<T*>(Ks), static_cast<T*>(dV),
          static_cast<unsigned char*>(ok), N, B, reg_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc
