// Projected-Newton BoxQP on one thread's registers (reference BoxQP.h:141-
// 347), for the boxed Riccati stage (riccati_stage.cuh::
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
// The TPU kernel unrolls a head of both loops and masks a while-loop tail
// because its lanes cannot branch; a thread can, so both are plain loops
// that stop where the lane stops.  Every clip is a select, so a clipped
// value carries the bound's bits for the next == test.

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

// Minimize 0.5 x'Hx + g'x on [lo, hi] from the warm start x0.  Writes the
// solution to x, and the free set (0/1) and lower Cholesky factor of the
// last factorization the plain version keeps to free / L.  Returns false
// on a failing status (HESSIAN_NOT_PD, POSITIVE_DIR_DERIV).
template <typename T, int NU>
__device__ bool boxqp(const T H[NU][NU], const T g[NU], const T lo[NU],
                      const T hi[NU], const T x0[NU], const BoxQPParams& p,
                      T x[NU], T free[NU], T L[NU][NU]) {
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
  for (int it = 1; it <= p.max_iter; ++it) {
    const bool improve_done =
        it > 1 && (old_obj - obj) < T(p.rel_improve_thre) * fabs(old_obj);
    old_obj = obj;

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

    // Armijo backtracking with projection (BoxQP.h:293-309)
    bool exhausted = false;
    T xc[NU], objc = obj;
    if (!pre_exit) {
      T step = T(1);
      for (int k = 0;; ++k) {
#pragma unroll
        for (int a = 0; a < NU; ++a) xc[a] = clip(x[a] + step * d[a], lo[a],
                                                  hi[a]);
        objc = qp_objective<T, NU>(H, g, xc);
        if (step < T(p.min_step) || k + 1 >= n_ls) {
          exhausted = step < T(p.min_step) ||
                      !((objc - old_obj) / (step * sdg) >= T(p.armijo_param));
          break;
        }
        if ((objc - old_obj) / (step * sdg) >= T(p.armijo_param)) break;
        step = step * T(p.step_factor);
      }
    }

    // The statuses in the reference's check order: SMALL_IMPROVEMENT,
    // ALL_CLAMPED, HESSIAN_NOT_PD, SMALL_GRADIENT, POSITIVE_DIR_DERIV,
    // MAX_LS_ITER, MAX_ITER.  The loop ends on any, so the last
    // iteration's decides ok.
    const bool done = pre_exit || exhausted || it >= p.max_iter;
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
    if (done) break;
  }
  return ok;
}

}  // namespace nmpc
