// DDP Riccati backward with the stage derivatives recomputed in the kernel
// from the trajectory, for Hopper (sm_90a), unboxed and boxed.
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_remat.py::
// backward_remat (_backward_remat_call, kernel _make_kernel_remat, fields
// _stage_fields_tile with its aux group).  Its plain version is
// nmpc_tpu_torch/kernels/ddp_backward_remat.py::backward_remat_plain: the
// derivative sweep (_derivative_sweep_lanes) and backward_stacked, or
// backward_stacked_boxed.  The fields come from gen_fields, generated
// from the problem's own callables (kernels/tileval.py) with the input
// mask applied; a boxed unit also generates gen_aux, the stage's bounds.
// The stage is riccati_stage or riccati_stage_boxed (riccati_stage.cuh),
// shared with the sweep-fed kernels ddp_backward.cu and
// ddp_backward_boxed.cuh.
//
// What bounds it on the card: latency, not bytes.  Per stage and lane it
// reads x_i and u_i (5 values at nx=4, nu=1; 4 at the vertical model's
// nx = nu = 2) and writes k and K; the generated fields, the Riccati stage
// and, boxed, the QP run on registers between the loads.  Unboxed, one
// thread per lane is one warp per SM at B=4096: the N dependent stages of
// each thread are the critical path.  Boxed, the QP sets the pace: its
// iterations and Armijo candidates depend on the lane's data (vertical
// model, first iteration, B=1024, N=100, fp32: 1.76 iterations and 7.0
// candidates per lane and stage on average, 133 candidates at most), and
// a warp waits for its slowest lane.
//
// What the design does about it:
//   * unboxed, one thread per lane walks i = N-1 ... 0 with the (Vx, Vxx,
//     dV, ok) carry in registers, as ddp_backward.cu does; the derivative
//     buffer of the sweep never exists;
//   * boxed, a group of G = kQpGroup threads per lane (boxqp.cuh::
//     LaneGroup), 32 / G lanes per 32-thread block: every thread of the
//     group generates the same fields and bounds and runs the same stage
//     with the QP's warm start in registers, so the group's branches
//     agree, and the QP's Armijo search takes G candidates at a time from
//     the block's step table in shared memory; rank 0 stores; a slot past
//     the batch's end runs the last lane's data without storing, so the
//     whole warp meets at every ballot and shuffle of the QP;
//   * (x_{i-1}, u_{i-1}) are loaded before stage i's arithmetic (the TPU
//     kernel's double-buffered stage DMA), batch-minor and coalesced;
//   * 32-thread blocks spread the lanes over as many SMs as possible.
// Templated on the scalar type, (NX, NU), BOXED and the group size; the
// generated unit instantiates it for the dtype it was traced at.

#pragma once

#include "cp_async.cuh"
#include "remat_common.cuh"
#include "riccati_stage.cuh"

// The boxed kernel reads the stage's bounds from gen_aux, which only a
// boxed unit generates; declared here for the units that do not.
template <typename T>
__host__ __device__ void gen_aux(T t, const T* x, const T* u, T* o);

namespace nmpc {

template <typename T, int NX, int NU>
__device__ __forceinline__ void load_xu(const T* __restrict__ xs,
                                        const T* __restrict__ us, int i,
                                        int b, int B, T x[NX], T u[NU]) {
#pragma unroll
  for (int a = 0; a < NX; ++a) x[a] = xs[idx2(i, a, NX, b, B)];
#pragma unroll
  for (int a = 0; a < NU; ++a) u[a] = us[idx2(i, a, NU, b, B)];
}

// Unpack gen_fields' flat output (Fx, Fu, Lx, Lu, Lxx, Luu, Lxu, each
// row-major) into a Riccati stage.
template <typename T, int NX, int NU>
__device__ __forceinline__ void unpack_fields(const T* f,
                                              Stage<T, NX, NU>& s) {
  int k = 0;
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c) s.Fx[a][c] = f[k++];
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = 0; c < NU; ++c) s.Fu[a][c] = f[k++];
#pragma unroll
  for (int a = 0; a < NX; ++a) s.Lx[a] = f[k++];
#pragma unroll
  for (int a = 0; a < NU; ++a) s.Lu[a] = f[k++];
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = 0; c < NX; ++c) s.Lxx[a][c] = f[k++];
#pragma unroll
  for (int a = 0; a < NU; ++a)
#pragma unroll
    for (int c = 0; c < NU; ++c) s.Luu[a][c] = f[k++];
#pragma unroll
  for (int a = 0; a < NX; ++a)
#pragma unroll
    for (int c = 0; c < NU; ++c) s.Lxu[a][c] = f[k++];
}

template <typename T, int NX, int NU, bool BOXED, int G>
__global__ void __launch_bounds__(kLaneThreads)
backward_remat_kernel(const T* __restrict__ xs, const T* __restrict__ us,
                      const T* __restrict__ VxT, const T* __restrict__ VxxT,
                      const T* __restrict__ lam_in,
                      const T* __restrict__ t0_in, T dt, BoxQPParams qp,
                      T* __restrict__ ks, T* __restrict__ Ks,
                      T* __restrict__ dV, unsigned char* __restrict__ ok_out,
                      int N, int B, int reg_type) {
  constexpr int kFields = 2 * NX * NX + 2 * NX * NU + NX + NU + NU * NU;
  static_assert(BOXED || G == 1, "the unboxed kernel runs a lane a thread");
  const T* steps = nullptr;
  if constexpr (BOXED) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    fill_step_table<T>(reinterpret_cast<T*>(smem_raw), qp);
    steps = reinterpret_cast<const T*>(smem_raw);
  }
  // Boxed, a slot past the batch's end runs the last lane's data and
  // stores nothing: every thread of a warp must reach the QP's exchanges.
  const int lane = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  if (!BOXED && lane >= B) return;
  const int b = lane < B ? lane : B - 1;
  const bool writer = !BOXED || (lane < B && LaneGroup<G>::rank() == 0);

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
  const T t0 = *t0_in;
  T k_next[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) k_next[a] = T(0);

  T x[NX], u[NU], x_next[NX], u_next[NU];
  load_xu<T, NX, NU>(xs, us, N - 1, b, B, x, u);
  for (int i = N - 1; i >= 0; --i) {
    if (i > 0) load_xu<T, NX, NU>(xs, us, i - 1, b, B, x_next, u_next);
    const T t_i = stage_time(t0, dt, i);
    T f[kFields];
    gen_fields<T>(t_i, x, u, f);
    Stage<T, NX, NU> s;
    unpack_fields<T, NX, NU>(f, s);
    T k[NU], K[NU][NX];
    if constexpr (BOXED) {
      T aux[2 * NU];
      gen_aux<T>(t_i, x, u, aux);
      Bounds<T, NU> box;
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        box.lower[a] = aux[a];
        box.upper[a] = aux[NU + a];
        box.u[a] = u[a];
      }
      riccati_stage_boxed<T, NX, NU, G>(s, box, lam, reg_type, qp, steps,
                                        carry, k_next, k, K);
    } else {
      riccati_stage<T, NX, NU>(s, lam, reg_type, carry, k, K);
    }
    if (writer) {
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        ks[idx2(i, a, NU, b, B)] = k[a];
#pragma unroll
        for (int e = 0; e < NX; ++e)
          Ks[idx3(i, a, e, NU, NX, b, B)] = K[a][e];
      }
    }
#pragma unroll
    for (int a = 0; a < NX; ++a) x[a] = x_next[a];
#pragma unroll
    for (int a = 0; a < NU; ++a) u[a] = u_next[a];
  }
  if (writer) {
    dV[b] = carry.dV0;
    dV[static_cast<size_t>(B) + b] = carry.dV1;
    ok_out[b] = carry.ok ? 1 : 0;
  }
}

// Launch on `stream`; returns the CUDA error of the launch (boxed: or of
// raising the shared-memory limit for a step table above 48 KB).  All
// arrays are contiguous batch-minor device arrays; t0 is one device
// scalar; ok is one byte per lane.  qp is read by the boxed kernel only,
// which runs G threads per lane (kQpGroup unless a measurement asks for
// another); the unboxed one runs one.
template <typename T, int NX, int NU, bool BOXED = false,
          int G = (BOXED ? kQpGroup : 1)>
int launch_backward_remat(int N, int B, int reg_type, double dt,
                          const void* xs, const void* us, const void* VxT,
                          const void* VxxT, const void* lam, const void* t0,
                          void* ks, void* Ks, void* dV, void* ok,
                          void* stream, BoxQPParams qp = BoxQPParams{}) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int lanes = kLaneThreads / G;   // lanes per block
  const int blocks = (B + lanes - 1) / lanes;
  size_t smem = 0;
  if constexpr (BOXED) {
    if (qp.max_ls_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
    smem = static_cast<size_t>(qp.max_ls_iter + 1) * sizeof(T);
    const int err = allow_dynamic_smem(
        backward_remat_kernel<T, NX, NU, BOXED, G>, smem);
    if (err != 0) return err;
  }
  backward_remat_kernel<T, NX, NU, BOXED, G>
      <<<blocks, kLaneThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(xs), static_cast<const T*>(us),
          static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
          static_cast<const T*>(lam), static_cast<const T*>(t0),
          static_cast<T>(dt), qp, static_cast<T*>(ks), static_cast<T*>(Ks),
          static_cast<T*>(dV), static_cast<unsigned char*>(ok), N, B,
          reg_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc
