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
// The stage is riccati_stage_group or riccati_stage_boxed (riccati_stage
// .cuh), shared with the packed kernel ddp_backward_packed.cuh (K3) and
// the sweep-fed boxed kernel ddp_backward_boxed.cuh (K4).
//
// What bounds it on the card: latency, not bytes.  Per stage and lane it
// reads x_i and u_i (5 values at nx=4, nu=1; 4 at the vertical model's
// nx = nu = 2) and writes k and K; the generated fields, the Riccati stage
// and, boxed, the QP run on registers between the loads.  Unboxed, one
// thread per lane read 16.8 MB at B=4096, N=100 in the ~0.16 ms K1 takes
// for 83.9 MB (PERF.md): each stage cost a lane ~1.6 us, the serial chain
// of gen_fields (~140 generated operations and a sine and cosine at the
// cart-pole) and the ~700 instructions of riccati_stage issued from one
// warp, whether an SM holds one lane or 32 (one warp per SM at B=4096, 8
// warps on the card at the tick shape, B=256).  Boxed, the QP sets the
// pace: its iterations and Armijo candidates depend on the lane's data
// (vertical model, first iteration, B=1024, N=100, fp32: 1.76 iterations
// and 7.0 candidates per lane and stage on average, 133 candidates at
// most), and a warp waits for its slowest lane.
//
// What the design does about it:
//   * unboxed, a group of G = kRematGroup threads per lane (row_group.cuh),
//     row_lanes(B) lanes per block: the fields depend on (t_i, x_i, u_i)
//     alone, so in each round thread r of the group generates the fields
//     of stage hi - 1 - r, one stage a thread, into its warp's slab in
//     shared memory, [G stages][F values][32 / G lanes] (the packed
//     layout, lane fastest, the stages padded so that the G writers of a
//     lane hit distinct banks);
//     then the group runs those G stages of the recursion from the slab
//     with riccati_stage.cuh::riccati_stage_group (the NX-sized rows and
//     columns split over the group, K, Qux, Vx and Vn exchanged by
//     shuffles).  The loads
//     of (x, u) for the next round go out before this round's arithmetic;
//     the last round is short where G does not divide N.  Every value is
//     computed by one thread in the order of one thread per lane, so each
//     G gives G = 1's bits (-fmad=false).  A warp's slab is about 32 F
//     sizeof(T) bytes at any G: a block holds as many warps as fit 227 KB
//     (row_group.cuh::remat_lanes; (8, 1) at fp64, F = 154, 16 lanes), and
//     an F of which not even one warp fits (F >= 906 at fp64) runs one
//     thread per lane with the fields in registers (G = 0), as the same
//     riccati_stage_group reading them at stride 1;
//   * boxed, a group of G = kQpGroup threads per lane (boxqp.cuh::
//     LaneGroup), 32 / G lanes per 32-thread block: every thread of the
//     group generates the same fields and bounds and runs the same stage
//     with the QP's warm start in registers, so the group's branches
//     agree, and the QP's Armijo search takes G candidates at a time from
//     the block's step table in shared memory; rank 0 stores; (x_{i-1},
//     u_{i-1}) are loaded before stage i's arithmetic;
//   * either way a slot past the batch's end runs the last lane's data
//     without storing, so the whole warp meets at every exchange (unboxed,
//     a warp wholly past it returns at once).
// Templated on the scalar type, (NX, NU), BOXED and the group size; the
// generated unit instantiates it for the dtype it was traced at.

#pragma once

#include "cp_async.cuh"
#include "remat_common.cuh"
#include "riccati_stage.cuh"
#include "row_group.cuh"

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

// The boxed kernel (K5 boxed).
template <typename T, int NX, int NU, int G>
__global__ void __launch_bounds__(kLaneThreads)
backward_remat_boxed_kernel(const T* __restrict__ xs,
                            const T* __restrict__ us,
                            const T* __restrict__ VxT,
                            const T* __restrict__ VxxT,
                            const T* __restrict__ lam_in,
                            const T* __restrict__ t0_in, T dt, BoxQPParams qp,
                            T* __restrict__ ks, T* __restrict__ Ks,
                            T* __restrict__ dV,
                            unsigned char* __restrict__ ok_out, int N, int B,
                            int reg_type) {
  constexpr int kFields = 2 * NX * NX + 2 * NX * NU + NX + NU + NU * NU;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fill_step_table<T>(reinterpret_cast<T*>(smem_raw), qp);
  const T* steps = reinterpret_cast<const T*>(smem_raw);
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

// The unboxed kernel (K5): G threads per lane, the fields of G stages
// generated ahead per round (one stage a thread) into the warp's slab; G =
// 0: one thread per lane, each stage's fields generated into registers
// (an F whose slab no block holds: row_group.cuh::kRematLaneGroup).
template <typename T, int NX, int NU, int G>
__global__ void __launch_bounds__(kMaxRowLanes * 8)
backward_remat_kernel(const T* __restrict__ xs, const T* __restrict__ us,
                      const T* __restrict__ VxT, const T* __restrict__ VxxT,
                      const T* __restrict__ lam_in,
                      const T* __restrict__ t0_in, T dt,
                      T* __restrict__ ks, T* __restrict__ Ks,
                      T* __restrict__ dV, unsigned char* __restrict__ ok_out,
                      int N, int B, int reg_type) {
  constexpr int F = PackedLayout<NX, NU>::F;
  constexpr bool kSlab = G > 0;
  constexpr int GT = kSlab ? G : 1;         // threads per lane
  constexpr int W = 32 / GT;                // lanes of a warp
  constexpr int stride = slab_stage_stride<GT>(F);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane0 = blockIdx.x * (blockDim.x / GT) + warp * W;
  if (lane0 >= B) return;                   // a warp wholly past the batch
  const int slot = static_cast<int>(threadIdx.x % 32) / GT;
  const int r = LaneGroup<GT>::rank();
  const int lane = lane0 + slot;
  const bool live = lane < B;
  const int b = live ? lane : B - 1;
  T* const slab = reinterpret_cast<T*>(smem_raw) + warp * GT * stride + slot;
  T* const mine = slab + r * stride;       // the stage this thread writes

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

  T x[NX], u[NU];
  if (N - 1 - r >= 0) load_xu<T, NX, NU>(xs, us, N - 1 - r, b, B, x, u);
  for (int hi = N; hi > 0; hi -= GT) {
    // this thread's stage of the round, then the next round's loads
    const int ig = hi - 1 - r;
    T f[F];
    if (ig >= 0) {
      gen_fields<T>(stage_time(t0, dt, ig), x, u, f);
      if constexpr (kSlab) {
#pragma unroll
        for (int e = 0; e < F; ++e) mine[e * W] = f[e];
      }
    }
    if (ig - GT >= 0) load_xu<T, NX, NU>(xs, us, ig - GT, b, B, x, u);
    if constexpr (kSlab) __syncwarp();
    const int len = hi < GT ? hi : GT;
    for (int s = 0; s < len; ++s) {
      T k[NU], K[NU][NX];
      if constexpr (kSlab)
        riccati_stage_group<T, NX, NU, GT>(slab + s * stride, W, lam,
                                           reg_type, carry, k, K);
      else
        riccati_stage_group<T, NX, NU, 1>(f, 1, lam, reg_type, carry, k, K);
      if (live)
        store_gains_group<T, NX, NU, GT>(k, K, hi - 1 - s, b, B, ks, Ks);
    }
    // the slab is read before the next round writes it
    if constexpr (kSlab) __syncwarp();
  }
  if (live && r == 0) {
    dV[b] = carry.dV0;
    dV[static_cast<size_t>(B) + b] = carry.dV1;
    ok_out[b] = carry.ok ? 1 : 0;
  }
}

// Launch on `stream`; returns the CUDA error of the launch (or of raising
// the shared-memory limit above 48 KB: the boxed step table, the unboxed
// field slab).  All arrays are contiguous batch-minor device arrays; t0 is
// one device scalar; ok is one byte per lane.  qp is read by the boxed
// kernel only.  G threads per lane: kQpGroup boxed, kRematLaneGroup
// unboxed (0: one thread, the fields in registers), unless a measurement
// asks for another.
template <typename T, int NX, int NU, bool BOXED = false,
          int G = (BOXED ? kQpGroup : kRematLaneGroup<T, NX, NU>)>
int launch_backward_remat(int N, int B, int reg_type, double dt,
                          const void* xs, const void* us, const void* VxT,
                          const void* VxxT, const void* lam, const void* t0,
                          void* ks, void* Ks, void* dV, void* ok,
                          void* stream, BoxQPParams qp = BoxQPParams{}) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (BOXED) {
    constexpr int lanes = kLaneThreads / G;   // lanes per block
    const int blocks = (B + lanes - 1) / lanes;
    if (qp.max_ls_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(qp.max_ls_iter + 1) * sizeof(T);
    const int err = allow_dynamic_smem(
        backward_remat_boxed_kernel<T, NX, NU, G>, smem);
    if (err != 0) return err;
    backward_remat_boxed_kernel<T, NX, NU, G><<<blocks, kLaneThreads, smem,
                                                st>>>(
        static_cast<const T*>(xs), static_cast<const T*>(us),
        static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
        static_cast<const T*>(lam), static_cast<const T*>(t0),
        static_cast<T>(dt), qp, static_cast<T*>(ks), static_cast<T*>(Ks),
        static_cast<T*>(dV), static_cast<unsigned char*>(ok), N, B,
        reg_type);
  } else {
    constexpr int F = PackedLayout<NX, NU>::F;
    static_assert(G == 0 || slab_warps<T, G>(F) > 0,
                  "a warp's field slab passes a block's shared memory");
    const int L = remat_lanes<T, G>(F, B);
    const size_t smem = remat_smem_bytes<T, G>(F, L);
    const int err =
        allow_dynamic_smem(backward_remat_kernel<T, NX, NU, G>, smem);
    if (err != 0) return err;
    backward_remat_kernel<T, NX, NU, G>
        <<<(B + L - 1) / L, L * (G > 0 ? G : 1), smem, st>>>(
        static_cast<const T*>(xs), static_cast<const T*>(us),
        static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
        static_cast<const T*>(lam), static_cast<const T*>(t0),
        static_cast<T>(dt), static_cast<T*>(ks), static_cast<T*>(Ks),
        static_cast<T*>(dV), static_cast<unsigned char*>(ok), N, B,
        reg_type);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc
