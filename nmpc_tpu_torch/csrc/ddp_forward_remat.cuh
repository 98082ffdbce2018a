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
//   * K7: one thread per (alpha, lane) pair, A x B threads (11x K6's), fed
//     by the rule of kernels/ddp_forward_remat.py::costs_chunk, and a unit
//     builds only the kernel its rule names: at C = 0 each thread reads its
//     lane's references on its own (the A threads of a lane the same
//     words, served by the 50 MB L2 after the first: about A times the
//     bytes its bound counts), stage i+1's loaded into registers before
//     stage i, in 128-thread blocks, the lanes of one alpha adjacent; at C
//     > 0 fwd_ring.cuh's ring brings a lane's references into shared
//     memory once for its A alpha-threads: a block of L lanes
//     (fwd_costs_lanes) x A threads, alpha-major (a warp reads neighbouring
//     lanes of one alpha, or one broadcast word for the alphas it shares),
//     and the producer warp.

#pragma once

#include "fwd_ring.cuh"

namespace nmpc {

// 128-thread blocks for the (alpha, lane) kernel at C = 0.
constexpr int kPairThreads = 128;

// K7's ring: lanes per block, 32 halved while the batch fills fewer than
// kFillBlocks blocks, down to 8 (B = 4096: 32; B = 1024 and 256: 8, 128
// and 32 blocks); the alphas a block takes, as many as its consumer warps
// hold within kCostsThreads threads with the producer warp (the sweep's
// 11 at 32 lanes, 44 at 8), the rest in further blocks along y.  The
// bound leaves a thread up to 168 registers (K6's ring stage takes 138).
constexpr int kCostsThreads = 384;
__host__ __device__ inline int fwd_costs_lanes(int B) {
  int L = kMaxRowLanes;
  while (L > 8 && (B + L - 1) / L < kFillBlocks) L /= 2;
  return L;
}
__host__ __device__ constexpr int fwd_costs_alphas(int L, int A) {
  return A < (kCostsThreads - 32) / L ? A : (kCostsThreads - 32) / L;
}

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

// K7 on fwd_ring.cuh's ring: the cost sum at alphas[A] of L lanes, the
// block's AB alphas from alpha blockIdx.y AB, thread t of the consumers
// (rounded up to whole warps) on the block's lane t % L at its alpha t / L
// (a thread past the block's alphas runs its last and stores nothing); a
// lane's references read from the ring by its alpha-threads, each stage's
// into registers before the stage ahead of it runs.
template <typename T, int NX, int NU, int C>
__global__ void __launch_bounds__(kCostsThreads)
forward_costs_ring_kernel(
    const __grid_constant__ FwdInputs<T, RefFields<NX, NU>> in,
    const T* __restrict__ alphas, const T* __restrict__ t0_in, T dt, T n_dt,
    T* __restrict__ csum, int N, int B, int A, int L) {
  using Fs = RefFields<NX, NU>;
  constexpr int R = fwd_ring<T>(Fs::F, C);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int consumers = static_cast<int>(blockDim.x) - 32;
  const int base = static_cast<int>(blockIdx.x) * L;   // the block's lane 0
  const FwdLayout<T, Fs> l(C, L);
  const StageRing<T, R> ring(smem_raw, fwd_buffer_bytes<T, Fs>(C, L));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      mbar_init(&ring.full[s]);
      mbar_init(&ring.empty[s], consumers / 32);   // every consumer warp
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= consumers) {   // the producer warp
    fwd_produce<T, Fs, R>(ring, in, l, base, N, C);
    return;
  }
  const int t = static_cast<int>(threadIdx.x);
  const int AB = fwd_costs_alphas(L, A);
  const int j0 = static_cast<int>(blockIdx.y) * AB + t / L;
  const int j = j0 < A ? j0 : A - 1;
  const bool live = j0 < A && t / L < AB && base + t % L < B;
  const int b = base + t % L < B ? base + t % L : B - 1;
  const T alpha = alphas[j];
  const T t0 = *t0_in;
  T x[NX];
#pragma unroll
  for (int a = 0; a < NX; ++a)
    x[a] = in.ptr[0][static_cast<size_t>(a) * in.ld + b];
  T ctot = T(0);
  StageRingFeed<T, R> feed{ring, b - base, L};
  fwd_stages_ahead<T, Fs, C>(
      feed, l, N,
      [](const FwdView<T, Fs>& v, int s) { return refs_at<T, NX, NU>(v, s); },
      [&](const StageRefs<T, NX, NU>& r, int i) {
        T u[NU];
        ctot = ctot + forward_stage<T, NX, NU>(stage_time(t0, dt, i), x, r,
                                               alpha, u);
      });
  const T cT = terminal_cost<T, NX, NU>(add_rn(t0, n_dt), x);
  if (live) csum[static_cast<size_t>(j) * B + b] = ctot + cT;
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

// K7 reads xs, us, ks and Ks with their lanes ld values apart: at C = 0
// by the parent's pair kernel (ld = B), else by the ring in chunks of C
// stages (ld * sizeof(T) and each address multiples of 16 bytes); C is the
// wrapper's rule (ddp_forward_remat.py::costs_chunk) or a measurement's.
template <typename T, int NX, int NU, int C>
int launch_forward_costs(int N, int B, int A, int ld, double dt, double n_dt,
                         const void* xs, const void* us, const void* ks,
                         const void* Ks, const void* alphas, const void* t0,
                         void* csum, void* stream) {
  using Fs = RefFields<NX, NU>;
  if (B <= 0 || N <= 0 || A <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (C == 0) {
    if (ld != B) return static_cast<int>(cudaErrorInvalidValue);
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
  } else {
    static_assert(fwd_smem<T, Fs>(C, kMaxRowLanes) <= kMaxBlockSmem,
                  "a block's ring of chunks passes its shared memory");
    const int L = fwd_costs_lanes(B);
    const int AB = fwd_costs_alphas(L, A);
    const void* fields[Fs::NF] = {xs, us, ks, Ks};
    FwdInputs<T, Fs> in;
    int err = fwd_inputs<T, Fs>(in, fields, N, B, ld, L, C);
    if (err != 0) return err;
    const size_t smem = fwd_smem<T, Fs>(C, L);
    err = allow_dynamic_smem(forward_costs_ring_kernel<T, NX, NU, C>, smem);
    if (err != 0) return err;
    const dim3 grid((B + L - 1) / L, (A + AB - 1) / AB);
    forward_costs_ring_kernel<T, NX, NU, C>
        <<<grid, (L * AB + 31) / 32 * 32 + 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
            in, static_cast<const T*>(alphas), static_cast<const T*>(t0),
            static_cast<T>(dt), static_cast<T>(n_dt), static_cast<T*>(csum),
            N, B, A, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nmpc
