// DDP line-search rollouts with the problem's dynamics and costs evaluated
// in the kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernels nmpc_tpu/kernels/ddp_forward_remat.py::
// forward_selected_remat (_forward_selected_call, kernel
// _make_kernel_selected; K6) and forward_costs_remat (_forward_costs_call,
// kernel _make_kernel_costs; K7), which share the stage body
// _stage_forward.  Plain versions: solvers/stages.py::
// _forward_selected_lanes and _forward_costs_lanes.  The stage body here,
// forward_stage, is shared the same way, so the alpha column a lane's
// head-path accept was decided from (K6) and the sweep's columns (K7) come
// from the same arithmetic.
//
// Stage (as _forward_selected_lanes): u = (u_ref + alpha k) + K dx, with
// K dx summed left to right over nx; (x', c) = gen_step(t_i, x, u); the
// cost summed in horizon order, then the terminal cost at t0 + N dt.
//
// What bounds them on the card: each lane's chain.  Per stage and thread
// they read (x_ref, u_ref, k, K): 10 values at nx=4, nu=1, and run the
// generated step (the cart-pole's: ~40 scalar ops, a sin, a cos and two
// IEEE divisions); the N stages of a thread are a dependent chain.  One
// thread per lane (K6) is only B threads: 4096 at the headline, 256 at
// the tick loop.  K6 on the cart-pole takes as long on one warp (B=32) as
// at B=4096, ~0.28 us a stage at fp32 (its chain floor; PERF.md,
// Findings): that chain hides the loads of the stage ahead, the TPU
// kernel's double-buffered DMA; a step without such calls (the vertical
// model's) is short enough that the loads show.
//
// What the design does about it:
//   * K6: one thread per lane, state and cost sum in registers, its
//     references fed by the rule of kernels/ddp_forward_remat.py::
//     ref_chunk, from the H100's measurements, and a unit builds only the
//     one kernel its rule names: for a step that calls a transcendental
//     function (C = 0) the next stage's references read into registers
//     while a stage runs, as before (a deeper ring, in shared memory or
//     in registers, only added work to the chain); for any other step
//     (C = 8) fwd_ring.cuh's ring of chunks of C stages in shared memory,
//     filled by a producer warp's TMA boxes (references TMA does not take
//     as they are copied once by the wrapper), each stage's references
//     read into registers before the stage ahead of it runs
//     (fwd_stages_ahead).  xs, us and costs are written batch-minor,
//     coalesced across a warp.  forward_stage and the unit's flags are as
//     before, so its bits are;
//   * K7: one thread per (alpha, lane) pair, A x B threads (11x K6's), so
//     that more loads are in flight; the lanes of one alpha are adjacent
//     (coalesced), and the A threads of one lane read the same references,
//     which the 50 MB L2 serves after the first; stage i+1's references
//     loaded into registers before stage i, no shared memory.

#pragma once

#include "fwd_ring.cuh"

namespace nmpc {

// 128-thread blocks for the (alpha, lane) kernel.
constexpr int kPairThreads = 128;

template <typename T, int NX, int NU>
struct StageRefs {
  T xr[NX];
  T ur[NU];
  T k[NU];
  T K[NU][NX];
};

template <typename T, int NX, int NU>
__device__ __forceinline__ void load_refs(StageRefs<T, NX, NU>& r,
                                          const T* __restrict__ xs,
                                          const T* __restrict__ us,
                                          const T* __restrict__ ks,
                                          const T* __restrict__ Ks, int i,
                                          int b, int B) {
#pragma unroll
  for (int a = 0; a < NX; ++a) r.xr[a] = xs[idx2(i, a, NX, b, B)];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    r.ur[a] = us[idx2(i, a, NU, b, B)];
    r.k[a] = ks[idx2(i, a, NU, b, B)];
#pragma unroll
    for (int c = 0; c < NX; ++c) r.K[a][c] = Ks[idx3(i, a, c, NU, NX, b, B)];
  }
}

// One line-search stage: the feedback law, then the generated step.
// Advances x in place, writes the input to u, returns the stage cost.
template <typename T, int NX, int NU>
__device__ __forceinline__ T forward_stage(T t, T x[NX],
                                           const StageRefs<T, NX, NU>& r,
                                           T alpha, T u[NU]) {
  T dx[NX];
#pragma unroll
  for (int c = 0; c < NX; ++c) dx[c] = x[c] - r.xr[c];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    T s = r.K[a][0] * dx[0];
#pragma unroll
    for (int c = 1; c < NX; ++c) s = s + r.K[a][c] * dx[c];
    u[a] = (r.ur[a] + alpha * r.k[a]) + s;
  }
  T o[NX + 1];
  gen_step<T>(t, x, u, o);
#pragma unroll
  for (int c = 0; c < NX; ++c) x[c] = o[c];
  return o[NX];
}

template <typename T, int NX, int NU>
__device__ __forceinline__ T terminal_cost(T tN, const T x[NX]) {
  T c;
  gen_term<T>(tN, x, &c);
  return c;
}

// K6's stage fields: x_ref [NX], u_ref [NU], k [NU], K [NU][NX].
template <int NX, int NU>
using RefFields = FwdFields<NX, NU, NU, NU * NX>;

template <typename T, int NX, int NU>
__device__ __forceinline__ StageRefs<T, NX, NU> refs_at(
    const FwdView<T, RefFields<NX, NU>>& v, int s) {
  StageRefs<T, NX, NU> r;
#pragma unroll
  for (int a = 0; a < NX; ++a) r.xr[a] = v(0, s, a);
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    r.ur[a] = v(1, s, a);
    r.k[a] = v(2, s, a);
#pragma unroll
    for (int c = 0; c < NX; ++c) r.K[a][c] = v(3, s, a * NX + c);
  }
  return r;
}

// K6 on fwd_ring.cuh's ring: the rollout at each lane's alpha, one thread
// per lane, the references by the ring of chunks of C stages, each
// stage's read into registers before the stage ahead of it runs.
template <typename T, int NX, int NU, int C>
__global__ void __launch_bounds__(kMaxRowLanes + 32)
forward_selected_ring_kernel(
    const __grid_constant__ FwdInputs<T, RefFields<NX, NU>> in,
    const T* __restrict__ alpha_in, const T* __restrict__ t0_in, T dt,
    T n_dt, T* __restrict__ xs_out, T* __restrict__ us_out,
    T* __restrict__ costs, T* __restrict__ csum, int N, int B) {
  using Fs = RefFields<NX, NU>;
  fwd_block<T, Fs, 1, C>(
      in, N, B, [&](auto& feed, const FwdLayout<T, Fs>& l,
                    const GroupLane<1>& at) {
        const int b = at.b;
        const T alpha = alpha_in[b];
        const T t0 = *t0_in;
        T x[NX];
#pragma unroll
        for (int a = 0; a < NX; ++a) {
          x[a] = in.ptr[0][static_cast<size_t>(a) * in.ld + b];
          if (at.live) xs_out[idx2(0, a, NX, b, B)] = x[a];
        }
        T ctot = T(0);
        auto run = [&](const StageRefs<T, NX, NU>& r, int i) {
          T u[NU];
          const T c = forward_stage<T, NX, NU>(stage_time(t0, dt, i), x, r,
                                               alpha, u);
          ctot = ctot + c;
          if (!at.live) return;
#pragma unroll
          for (int a = 0; a < NX; ++a) xs_out[idx2(i + 1, a, NX, b, B)] = x[a];
#pragma unroll
          for (int a = 0; a < NU; ++a) us_out[idx2(i, a, NU, b, B)] = u[a];
          costs[static_cast<size_t>(i) * B + b] = c;
        };
        fwd_stages_ahead<T, Fs, C>(
            feed, l, N,
            [](const FwdView<T, Fs>& v, int s) {
              return refs_at<T, NX, NU>(v, s);
            },
            run);
        const T cT = terminal_cost<T, NX, NU>(add_rn(t0, n_dt), x);
        if (!at.live) return;
        costs[static_cast<size_t>(N) * B + b] = cT;
        csum[b] = ctot + cT;
      });
}

// K7: the cost sum of every (alpha, lane) pair, alphas[A].
template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kPairThreads)
forward_costs_kernel(const T* __restrict__ xs, const T* __restrict__ us,
                     const T* __restrict__ ks, const T* __restrict__ Ks,
                     const T* __restrict__ alphas,
                     const T* __restrict__ t0_in, T dt, T n_dt,
                     T* __restrict__ csum, int N, int B, int A) {
  const size_t g = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= static_cast<size_t>(A) * B) return;
  const int a_idx = static_cast<int>(g / B);
  const int b = static_cast<int>(g % B);
  const T alpha = alphas[a_idx];
  const T t0 = *t0_in;
  T x[NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) x[a] = xs[idx2(0, a, NX, b, B)];
  StageRefs<T, NX, NU> cur, nxt;
  load_refs<T, NX, NU>(cur, xs, us, ks, Ks, 0, b, B);
  T ctot = T(0);
  for (int i = 0; i < N; ++i) {
    if (i + 1 < N) load_refs<T, NX, NU>(nxt, xs, us, ks, Ks, i + 1, b, B);
    T u[NU];
    ctot = ctot + forward_stage<T, NX, NU>(stage_time(t0, dt, i), x, cur,
                                           alpha, u);
    cur = nxt;
  }
  csum[g] = ctot + terminal_cost<T, NX, NU>(add_rn(t0, n_dt), x);
}

// K6 at C = 0: the rollout at each lane's alpha, one thread per lane,
// stage i+1's references read into registers before stage i runs (the TPU
// kernel's double-buffered stage DMA); contiguous inputs.
template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kLaneThreads)
forward_selected_kernel(const T* __restrict__ xs, const T* __restrict__ us,
                        const T* __restrict__ ks, const T* __restrict__ Ks,
                        const T* __restrict__ alpha_in,
                        const T* __restrict__ t0_in, T dt, T n_dt,
                        T* __restrict__ xs_out, T* __restrict__ us_out,
                        T* __restrict__ costs, T* __restrict__ csum, int N,
                        int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T alpha = alpha_in[b];
  const T t0 = *t0_in;
  T x[NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    x[a] = xs[idx2(0, a, NX, b, B)];
    xs_out[idx2(0, a, NX, b, B)] = x[a];
  }
  StageRefs<T, NX, NU> cur, nxt;
  load_refs<T, NX, NU>(cur, xs, us, ks, Ks, 0, b, B);
  T ctot = T(0);
  for (int i = 0; i < N; ++i) {
    if (i + 1 < N) load_refs<T, NX, NU>(nxt, xs, us, ks, Ks, i + 1, b, B);
    T u[NU];
    const T c = forward_stage<T, NX, NU>(stage_time(t0, dt, i), x, cur,
                                         alpha, u);
#pragma unroll
    for (int a = 0; a < NX; ++a) xs_out[idx2(i + 1, a, NX, b, B)] = x[a];
#pragma unroll
    for (int a = 0; a < NU; ++a) us_out[idx2(i, a, NU, b, B)] = u[a];
    costs[static_cast<size_t>(i) * B + b] = c;
    ctot = ctot + c;
    cur = nxt;
  }
  const T cT = terminal_cost<T, NX, NU>(add_rn(t0, n_dt), x);
  costs[static_cast<size_t>(N) * B + b] = cT;
  csum[b] = ctot + cT;
}

// Launchers: on `stream`, return a CUDA error code (K6: of a field's
// tensor map, of the shared-memory attribute) or cudaGetLastError() after
// the launch.  Arrays are batch-minor device arrays; t0 is one device
// scalar; n_dt is N * dt computed in double, as the plain version's t0 +
// N * dt.  K6 reads xs [N + 1, NX, B], us, ks [N, NU, B] and Ks [N, NU,
// NX, B] with their lanes ld values apart: at C = 0 by the one-stage
// register prefetch (ld = B), else by the ring in chunks of C stages
// (ld * sizeof(T) and each address multiples of 16 bytes); C is the
// wrapper's rule (ddp_forward_remat.py::ref_chunk) or a measurement's.
// K7's inputs and every output contiguous.
template <typename T, int NX, int NU, int C>
int launch_forward_selected(int N, int B, int ld, double dt, double n_dt,
                            const void* xs, const void* us, const void* ks,
                            const void* Ks, const void* alpha,
                            const void* t0, void* xs_out, void* us_out,
                            void* costs, void* csum, void* stream) {
  using Fs = RefFields<NX, NU>;
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (C == 0) {
    if (ld != B) return static_cast<int>(cudaErrorInvalidValue);
    forward_selected_kernel<T, NX, NU>
        <<<(B + kLaneThreads - 1) / kLaneThreads, kLaneThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(xs), static_cast<const T*>(us),
            static_cast<const T*>(ks), static_cast<const T*>(Ks),
            static_cast<const T*>(alpha), static_cast<const T*>(t0),
            static_cast<T>(dt), static_cast<T>(n_dt), static_cast<T*>(xs_out),
            static_cast<T*>(us_out), static_cast<T*>(costs),
            static_cast<T*>(csum), N, B);
  } else {
    static_assert(fwd_smem<T, Fs>(C, fwd_least_lanes<1>()) <= kMaxBlockSmem,
                  "a block's ring of chunks passes its shared memory");
    const int L = fwd_lanes<T, Fs, 1>(C, B);
    const void* fields[Fs::NF] = {xs, us, ks, Ks};
    FwdInputs<T, Fs> in;
    int err = fwd_inputs<T, Fs>(in, fields, N, B, ld, L, C);
    if (err != 0) return err;
    const size_t smem = fwd_smem<T, Fs>(C, L);
    err = allow_dynamic_smem(forward_selected_ring_kernel<T, NX, NU, C>, smem);
    if (err != 0) return err;
    forward_selected_ring_kernel<T, NX, NU, C>
        <<<(B + L - 1) / L, L + 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
            in, static_cast<const T*>(alpha), static_cast<const T*>(t0),
            static_cast<T>(dt), static_cast<T>(n_dt), static_cast<T*>(xs_out),
            static_cast<T*>(us_out), static_cast<T*>(costs),
            static_cast<T*>(csum), N, B);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NX, int NU>
int launch_forward_costs(int N, int B, int A, double dt, double n_dt,
                         const void* xs, const void* us, const void* ks,
                         const void* Ks, const void* alphas, const void* t0,
                         void* csum, void* stream) {
  if (B <= 0 || N <= 0 || A <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t threads = static_cast<size_t>(A) * B;
  const int blocks = static_cast<int>((threads + kPairThreads - 1) /
                                      kPairThreads);
  forward_costs_kernel<T, NX, NU>
      <<<blocks, kPairThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(xs), static_cast<const T*>(us),
          static_cast<const T*>(ks), static_cast<const T*>(Ks),
          static_cast<const T*>(alphas), static_cast<const T*>(t0),
          static_cast<T>(dt), static_cast<T>(n_dt), static_cast<T*>(csum),
          N, B, A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc
