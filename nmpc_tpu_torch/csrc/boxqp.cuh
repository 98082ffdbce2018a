// Projected-Newton BoxQP (reference BoxQP.h:141-347) run by a group of G
// threads per lane, for the boxed Riccati stage (riccati_stage.cuh::
// riccati_stage_boxed).  Replaces the TPU kernel's in-kernel QP
// nmpc_tpu/kernels/ddp_backward_pallas.py::_boxqp_t with the semantics of
// the plain version nmpc_tpu_torch/kernels/ddp_backward.py::boxqp_stacked:
//   * the clamped set by exact bound equality, the free-subspace Newton
//     step through the masked system (F H F + C) and the Cholesky's LLT
//     failure rule;
//   * the bad-direction test sdg > 1e-10;
//   * Armijo (obj_c - obj) / (step sdg) >= armijo_param over the schedule
//     1, f, f^2, ... formed by repeated multiplication in T; a step below
//     min_step stops the search as exhaustion (MAX_LS_ITER) whatever
//     Armijo says, and an exhausted schedule takes the last candidate;
//   * the free set and factor of the previous iteration kept on a
//     small-improvement exit; MAX_ITER and MAX_LS_ITER count as success.
//
// What bounds it on the card: the QP's dependent chain, and a warp's
// slowest lane.  One Armijo candidate is a clip, an objective and an IEEE
// division, and a serial search waits for each before the next.  On the
// vertical model's first iteration (B=1024, N=100, fp32) a lane runs 1.76
// QP iterations and 7.0 candidates per stage on average, 133 at most; with
// one lane per thread a warp waits for the slowest of its 32 lanes, 16.8
// candidates per stage on average.
//
// What the design does about it: every lane is a group of G threads
// (LaneGroup, G a power of two, aligned in the warp), so a warp holds
// 32 / G lanes.  Every thread of a group runs the serial parts (the
// iterations' gradient, Cholesky and Newton direction) on the same
// values in the same order, so the group's branches agree without any
// exchange.  The Armijo schedule is evaluated G candidates at a time, the
// TPU kernel's ls_block head made parallel: thread j takes candidate
// k0 + j, a ballot finds the block's first stop, and a shuffle hands its
// candidate to the group; without a stop the next block starts at k0 + G.
// The QP's loops run until the warp's last lane is done (a lane that is
// done idles), so the whole warp reaches every ballot and shuffle at the
// same point: exchanges over one group's mask while the warp's other
// groups were elsewhere split the warp, and measured 4x slower than a
// thread per lane (PERF.md, Findings).  The steps come from a table in shared
// memory that the block's first thread fills by repeated multiplication
// (fill_step_table), so candidate k carries the bits of the sequential
// search's k-th step.  Every clip is a select, so a clipped value carries
// the bound's bits for the next == test.

#pragma once

#include "linalg.cuh"

namespace nmpc {

// BoxQPConfig's fields (core/types.py); each threshold is compared at T,
// as the plain version compares a T tensor with a Python float.
struct BoxQPParams {
  int max_iter;
  int max_ls_iter;
  double grad_thre;
  double rel_improve_thre;
  double step_factor;
  double min_step;
  double armijo_param;
};

// max / min that return NaN when either operand is NaN, as torch.maximum
// and torch.minimum do; otherwise one operand's bits.
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  return min_nan(max_nan(v, lo), hi);
}

// 0.5 x'Hx + g'x, summed as the plain version's _obj_bl.
template <typename T, int NU>
__device__ __forceinline__ T qp_objective(const T H[NU][NU], const T g[NU],
                                          const T x[NU]) {
  T xg = x[0] * g[0];
  T xHx = T(0);
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    if (a > 0) xg = xg + x[a] * g[a];
    T hx = H[a][0] * x[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) hx = hx + H[a][l] * x[l];
    xHx = (a == 0) ? x[0] * hx : xHx + x[a] * hx;
  }
  return xg + T(0.5) * xHx;
}

// The G threads of one lane: G a power of two up to 32, the groups
// aligned in the warp (thread t is rank t % G of lane t / G).  Every
// exchange names the whole warp and is reached by all its 32 threads at
// the same point, whatever their lanes' state, so a warp stays converged
// at each of them: any is the warp's vote, ballot gathers a predicate of
// each thread of the caller's group (bit j from rank j), bcast hands
// every thread of a group rank src's value.
template <int G>
struct LaneGroup {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0,
                "a lane's group is a power of two of at most 32 threads");
  static constexpr unsigned kWarp = 0xffffffffu;
  static constexpr unsigned kBits = G == 32 ? kWarp : (1u << G) - 1u;

  __device__ static int rank() {
    return static_cast<int>(threadIdx.x) & (G - 1);
  }
  __device__ static int offset() {
    return static_cast<int>(threadIdx.x & 31u) & ~(G - 1);
  }
  __device__ static bool any(bool pred) { return __any_sync(kWarp, pred); }
  __device__ static unsigned ballot(bool pred) {
    return (__ballot_sync(kWarp, pred) >> offset()) & kBits;
  }
  template <typename T>
  __device__ static T bcast(T v, int src) {
    return __shfl_sync(kWarp, v, src, G);
  }
};

// The threads per lane of the boxed kernels (ddp_backward_boxed.cuh,
// ddp_backward_remat.cuh boxed), chosen by measurement on the H100 among
// 4, 8 and 16 (PERF.md, Findings): 16 is faster at B=1024 and slower than one
// thread per lane at B=4096, where 2048 warps of replicated serial work
// saturate the SMs' issue; 8 is faster than or level with it at both.
constexpr int kQpGroup = 8;

// The Armijo schedule 1, f, f^2, ... (max_ls_iter + 1 steps), formed by
// repeated multiplication at T as the plain version's _step_schedule and
// the sequential search form it, written to shared memory by the block's
// first thread.  Every thread of the block must call it: it ends in a
// block barrier.
template <typename T>
__device__ __forceinline__ void fill_step_table(T* steps,
                                                const BoxQPParams& p) {
  if (threadIdx.x == 0) {
    T step = T(1);
    for (int k = 0; k <= p.max_ls_iter; ++k) {
      steps[k] = step;
      step = step * T(p.step_factor);
    }
  }
  __syncthreads();
}

// Minimize 0.5 x'Hx + g'x on [lo, hi] from the warm start x0, by the G
// threads of the lane's group, each with the same arguments; `steps` is
// the fill_step_table schedule.  Every thread of the warp must call it
// (the loops run until the warp's last lane is done; a lane that is done
// idles).  Writes the solution to x, and the free set (0/1) and lower
// Cholesky factor of the last factorization the plain version keeps to
// free / L, in every thread of the group.  Returns false on a failing
// status (HESSIAN_NOT_PD, POSITIVE_DIR_DERIV).
template <typename T, int NU, int G>
__device__ __forceinline__ bool boxqp(const T H[NU][NU], const T g[NU],
                                      const T lo[NU], const T hi[NU],
                                      const T x0[NU], const BoxQPParams& p,
                                      const T* steps, T x[NU], T free[NU],
                                      T L[NU][NU]) {
  using Group = LaneGroup<G>;
  const int n_ls = p.max_ls_iter + 1;
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    x[a] = clip(x0[a], lo[a], hi[a]);
    free[a] = T(1);
#pragma unroll
    for (int c = 0; c < NU; ++c) L[a][c] = (a == c) ? T(1) : T(0);
  }
  T obj = qp_objective<T, NU>(H, g, x);
  T old_obj = obj;
  bool ok = true;   // max_iter = 0 leaves the warm start, as the plain one
  bool running = true;
  for (int it = 1; it <= p.max_iter && Group::any(running); ++it) {
    const bool improve_done =
        it > 1 && (old_obj - obj) < T(p.rel_improve_thre) * fabs(old_obj);
    if (running) old_obj = obj;

    T grad[NU], fm[NU], cm[NU];
    bool all_clamped = true;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T hx = H[a][0] * x[0];
#pragma unroll
      for (int l = 1; l < NU; ++l) hx = hx + H[a][l] * x[l];
      grad[a] = g[a] + hx;
      const bool clamped = (x[a] == lo[a] && grad[a] > T(0)) ||
                           (x[a] == hi[a] && grad[a] < T(0));
      fm[a] = clamped ? T(0) : T(1);
      cm[a] = clamped ? T(1) : T(0);
      all_clamped = all_clamped && clamped;
    }
    T Hm[NU][NU], Lc[NU][NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        Hm[a][c] = fm[a] * H[a][c] * fm[c] + (a == c ? cm[c] : T(0));
        Lc[a][c] = T(0);
      }
    }
    const bool chol_ok = cholesky<T, NU>(Hm, Lc);

    T gn2 = fm[0] * grad[0] * grad[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) gn2 = gn2 + fm[a] * grad[a] * grad[a];
    const bool small_grad = gn2 < T(p.grad_thre * p.grad_thre);

    // Newton direction on the free subspace (BoxQP.h:256-279)
    T rhs[NU][1], sol[NU][1], d[NU];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T hc = H[a][0] * (cm[0] * x[0]);
#pragma unroll
      for (int l = 1; l < NU; ++l) hc = hc + H[a][l] * (cm[l] * x[l]);
      rhs[a][0] = fm[a] * (g[a] + hc);
    }
    neg_chol_solve<T, NU, 1>(Lc, rhs, sol);
    T sdg = T(0);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      d[a] = fm[a] * (sol[a][0] - fm[a] * x[a]);
      sdg = (a == 0) ? d[0] * grad[0] : sdg + d[a] * grad[a];
    }
    const bool bad_dir = sdg > T(1e-10);
    const bool pre_exit =
        improve_done || all_clamped || !chol_ok || small_grad || bad_dir;

    // Armijo backtracking with projection (BoxQP.h:293-309), G candidates
    // at a time: rank j takes candidate k0 + j and says whether the
    // sequential search would stop there (Armijo, a step below min_step,
    // or the schedule's last candidate) and whether that stop is
    // exhaustion; the first stop of the block is the search's.
    bool searching = running && !pre_exit;
    bool exhausted = false;
    T xc[NU], objc = obj;
    for (int k0 = 0; Group::any(searching); k0 += G) {
      const int k = k0 + Group::rank();
      T xk[NU];
      T objk = obj;
      bool stop = false, exh = false;
#pragma unroll
      for (int a = 0; a < NU; ++a) xk[a] = x[a];
      if (searching && k < n_ls) {
        const T step = steps[k];
#pragma unroll
        for (int a = 0; a < NU; ++a)
          xk[a] = clip(x[a] + step * d[a], lo[a], hi[a]);
        objk = qp_objective<T, NU>(H, g, xk);
        const bool armijo =
            (objk - old_obj) / (step * sdg) >= T(p.armijo_param);
        const bool below = step < T(p.min_step);
        stop = armijo || below || k + 1 >= n_ls;
        exh = below || !armijo;
      }
      const unsigned stops = Group::ballot(stop);
      const unsigned exhs = Group::ballot(exh);
      const int first = stops != 0u ? __ffs(static_cast<int>(stops)) - 1 : 0;
      T xf[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) xf[a] = Group::bcast(xk[a], first);
      const T objf = Group::bcast(objk, first);
      if (searching && stops != 0u) {
#pragma unroll
        for (int a = 0; a < NU; ++a) xc[a] = xf[a];
        objc = objf;
        exhausted = (exhs >> first) & 1u;
        searching = false;
      }
    }

    if (running) {
      // The statuses in the reference's check order: SMALL_IMPROVEMENT,
      // ALL_CLAMPED, HESSIAN_NOT_PD, SMALL_GRADIENT, POSITIVE_DIR_DERIV,
      // MAX_LS_ITER, MAX_ITER.  The loop ends on any, so the last
      // iteration's decides ok.
      ok = improve_done || all_clamped ||
           (chol_ok && (small_grad || !bad_dir));
      if (!pre_exit) {
#pragma unroll
        for (int a = 0; a < NU; ++a) x[a] = xc[a];
        obj = objc;
      }
      if (!improve_done) {
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          free[a] = fm[a];
#pragma unroll
          for (int c = 0; c < NU; ++c) L[a][c] = Lc[a][c];
        }
      }
      running = !(pre_exit || exhausted || it >= p.max_iter);
    }
  }
  return ok;
}

}  // namespace nmpc
