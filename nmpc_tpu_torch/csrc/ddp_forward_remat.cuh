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
// What bounds them on the card: latency.  Per stage and thread they read
// (x_ref, u_ref, k, K): 10 values at nx=4, nu=1, and run ~50 scalar ops of
// the generated step; the N stages of a thread are a dependent chain.
// One thread per lane (K6) is only B threads: 4096 at the headline, 256
// at the tick loop.
//
// What the design does about it:
//   * K6: one thread per lane, state and cost sum in registers; stage
//     i+1's references are loaded before stage i's arithmetic (the TPU
//     kernel's double-buffered DMA); xs, us and costs are written
//     batch-minor, coalesced across a warp;
//   * K7: one thread per (alpha, lane) pair, A x B threads (11x K6's), so
//     that more loads are in flight; the lanes of one alpha are adjacent
//     (coalesced), and the A threads of one lane read the same references,
//     which the 50 MB L2 serves after the first;
//   * no shared memory; nothing but the outputs goes back to memory.

#pragma once

#include "remat_common.cuh"

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

// K6: the rollout at each lane's alpha.
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

// Launchers: on `stream`, return cudaGetLastError() after the launch.  All
// arrays are contiguous batch-minor device arrays; t0 is one device scalar;
// n_dt is N * dt computed in double, as the plain version's t0 + N * dt.
template <typename T, int NX, int NU>
int launch_forward_selected(int N, int B, double dt, double n_dt,
                            const void* xs, const void* us, const void* ks,
                            const void* Ks, const void* alpha,
                            const void* t0, void* xs_out, void* us_out,
                            void* costs, void* csum, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kLaneThreads - 1) / kLaneThreads;
  forward_selected_kernel<T, NX, NU>
      <<<blocks, kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(xs), static_cast<const T*>(us),
          static_cast<const T*>(ks), static_cast<const T*>(Ks),
          static_cast<const T*>(alpha), static_cast<const T*>(t0),
          static_cast<T>(dt), static_cast<T>(n_dt),
          static_cast<T*>(xs_out), static_cast<T*>(us_out),
          static_cast<T*>(costs), static_cast<T*>(csum), N, B);
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
