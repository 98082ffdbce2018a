// The projected-Newton BoxQP and the boxed Riccati stage at the wide
// boxed shapes (4 < nu <= 16 at nx <= 9, where the one-group QP's
// registers do not serve; the centroidal model's (9, 16)), for the boxed
// backward K4 there
// (ddp_backward_boxed_wide.cuh).  Everywhere else the boxed kernels run
// boxqp.cuh::boxqp and riccati_stage.cuh::riccati_stage_boxed.
//
// The same QP as boxqp.cuh (the TPU kernel's in-kernel QP
// nmpc_tpu/kernels/ddp_backward_pallas.py::_boxqp_t :182, with the
// semantics of the plain nmpc_tpu_torch/kernels/ddp_backward.py::
// boxqp_stacked: the clamped set by exact bound equality, the masked
// system F H F + C and the LLT failure rule, sdg > 1e-10, the Armijo
// schedule from the block's step table with a step below min_step as
// exhaustion and an exhausted schedule taking its last candidate, the
// free set and factor kept on a small-improvement exit, MAX_ITER and
// MAX_LS_ITER counted as success), and the same stage as
// riccati_stage_boxed (_riccati_stage_boxed :433-508), split otherwise.
// boxqp.cuh has every thread of a lane's group repeat the serial NU x NU
// work in registers (H, the masked system, its factor and the kept one):
// at nu = 16 that passes the register file many times over, as K1's
// stage did before riccati_stage_wide.cuh (ptxas spilled 17,610 / 27,468
// bytes at fp32 there).  Here, as in riccati_stage_wide.cuh:
//   * the stage's Q expansion is riccati_stage_wide.cuh's row tasks;
//     Quu_F (the QP's H), Qu (its g) and the bounds less u go to the
//     lane's scratch in shared memory (WideBoxedScratch), which the
//     group reads where they are;
//   * each QP iteration the lane's threads split by rows the gradient,
//     the masked system and the Newton step's right-hand side, and the
//     masked system's Cholesky (riccati_stage_wide.cuh::wide_cholesky:
//     every thread forms every pivot, each row of L exchanged through
//     the scratch at __syncwarp) with the right-hand side's forward
//     substitution beside it; every thread then runs the backward
//     substitution whole, in neg_chol_solve's order, so that each holds
//     the Newton direction without an exchange;
//   * the Armijo schedule is evaluated G candidates at a time, one a
//     thread, as in boxqp.cuh (each candidate's objective in _obj_bl's
//     order); the block's first stop, found by a ballot, is the search's,
//     and every thread forms the chosen iterate itself from its step
//     (the same operations on the same values as the thread that
//     evaluated it), so only the objective is exchanged;
//   * the factor of each iteration goes to one of two buffers, the other
//     holding the factor the plain version keeps (a small-improvement
//     exit keeps the previous one); K's columns are solved with it, one
//     column a thread, clamped rows exactly 0.
// Every value is computed by one thread with the operations and the order
// of boxqp.cuh and riccati_stage_boxed at G = 1; only which thread
// computes it depends on G, so every G gives G = 1's bits (the units
// build with -fmad=false).  The QP's loops run until the warp's last lane
// is done (a done lane idles), so the whole warp meets at every barrier,
// ballot and shuffle.

#pragma once

#include "boxqp.cuh"
#include "riccati_stage_wide.cuh"

namespace nmpc {

// A lane's scratch of the boxed wide stage, offsets in values: the
// unboxed stage's (WideScratch, whose Lt holds the first factor buffer
// and Fd the masked system's diagonal), then the QP's.
template <int NX, int NU>
struct WideBoxedScratch {
  using W = WideScratch<NX, NU>;
  static constexpr int US = W::US;
  static constexpr int H = W::size;          // Quu_F [NU][US]: the QP's H
  static constexpr int Lo = H + NU * US;     // lower - u [NU]
  static constexpr int Hi = Lo + NU;         // upper - u [NU]
  static constexpr int Kn = Hi + NU;         // the warm start [NU]
  static constexpr int Gr = Kn + NU;         // the gradient [NU]
  static constexpr int R = Gr + NU;          // the Newton step's rhs [NU]
  static constexpr int L1 = R + NU;          // the second factor buffer
  static constexpr int size = L1 + NU * NU;
};

// 0.5 x'Hx + g'x with H's rows US values apart, summed as boxqp.cuh::
// qp_objective (the plain version's _obj_bl).
template <typename T, int NU, int US>
__device__ __forceinline__ T qp_objective_rows(const T* H, const T* g,
                                               const T (&x)[NU]) {
  T xg = x[0] * g[0];
  T xHx = T(0);
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    if (a > 0) xg = xg + x[a] * g[a];
    const T* h = H + a * US;
    T hx = h[0] * x[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) hx = hx + h[l] * x[l];
    xHx = (a == 0) ? x[0] * hx : xHx + x[a] * hx;
  }
  return xg + T(0.5) * xHx;
}

// Minimize 0.5 x'Hx + g'x on [lo, hi] from the warm start x0 by the G
// threads of the lane's group (every thread of the warp calls it at the
// same point).  H ([NU][US]), g, lo, hi and x0 lie in the lane's
// scratch; Gr, R and Fd are the QP's [NU] scratch, Lb its two factor
// buffers ([NU][NU], L by columns: Lb[k NU + i] = L[i][k], the diagonal
// at Lb[j NU + j]); `steps` is the block's fill_step_table schedule.  On
// return every thread of the group holds the solution in x, the free set
// of the last factorization the plain version keeps in `free_set` (bit
// a: input a free) and that factor in Lb[kept], the lane's QP
// iterations in `iters` and the Armijo candidates its searches visited in
// all in `evals` (the plain version's stats).  Returns false on a failing
// status (HESSIAN_NOT_PD, POSITIVE_DIR_DERIV).
template <typename T, int NU, int G, int US>
__device__ __forceinline__ bool boxqp_wide(
    const T* H, const T* g, const T* lo, const T* hi, const T* x0,
    const BoxQPParams& p, const T* steps, T* Gr, T* R, T* Fd,
    T* const (&Lb)[2], T (&x)[NU], unsigned& free_set, int& kept,
    int& iters, int& evals) {
  static_assert(NU < 32, "the free set is a 32-bit mask");
  using Group = LaneGroup<G>;
  constexpr int JU = (NU + G - 1) / G;        // rows a thread owns
  const int r = Group::rank();
  const int n_ls = p.max_ls_iter + 1;
#pragma unroll
  for (int a = 0; a < NU; ++a) x[a] = clip(x0[a], lo[a], hi[a]);
  free_set = (1u << NU) - 1u;
  kept = 0;
  iters = 0;
  evals = 0;
  if (p.max_iter <= 0) {   // the plain version's initial factor: I
    for (int e = r; e < NU * NU; e += G)
      Lb[0][e] = (e % (NU + 1) == 0) ? T(1) : T(0);
  }
  T obj = qp_objective_rows<T, NU, US>(H, g, x);
  T old_obj = obj;
  bool ok = true;   // max_iter = 0 leaves the warm start, as the plain one
  bool running = true;
  int cur = 0;      // the buffer this iteration factors into
  for (int it = 1; it <= p.max_iter && Group::any(running); ++it) {
    __syncwarp();   // every thread is done with the last iteration's Gr
    const bool improve_done =
        it > 1 && (old_obj - obj) < T(p.rel_improve_thre) * fabs(old_obj);
    if (running) {
      old_obj = obj;
      ++iters;
    }

    // the gradient by rows
#pragma unroll
    for (int j = 0; j < JU; ++j) {
      const int a = j * G + r;
      if (JU * G == NU || a < NU) {
        const T* h = H + a * US;
        T hx = h[0] * x[0];
#pragma unroll
        for (int l = 1; l < NU; ++l) hx = hx + h[l] * x[l];
        Gr[a] = g[a] + hx;
      }
    }
    __syncwarp();
    // the clamped set and the gradient's norm on the free set, in every
    // thread
    unsigned fbits = 0u;
    bool all_clamped = true;
    T gn2 = T(0);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      const T gr = Gr[a];
      const bool clamped =
          (x[a] == lo[a] && gr > T(0)) || (x[a] == hi[a] && gr < T(0));
      fbits |= clamped ? 0u : (1u << a);
      all_clamped = all_clamped && clamped;
      const T fa = clamped ? T(0) : T(1);
      gn2 = (a == 0) ? fa * gr * gr : gn2 + fa * gr * gr;
    }
    auto fm = [fbits](int a) { return ((fbits >> a) & 1u) ? T(1) : T(0); };
    auto cm = [fbits](int a) { return ((fbits >> a) & 1u) ? T(0) : T(1); };
    const bool small_grad = gn2 < T(p.grad_thre * p.grad_thre);

    // this thread's rows of the masked system F H F + C and of the Newton
    // step's right-hand side F (g + H C x)
    T AF[JU][NU];
#pragma unroll
    for (int j = 0; j < JU; ++j) {
      const int i = j * G + r;
      if (JU * G == NU || i < NU) {
        const T* h = H + i * US;
#pragma unroll
        for (int c = 0; c < NU; ++c)
          AF[j][c] = fm(i) * h[c] * fm(c) + (i == c ? cm(c) : T(0));
        T hc = h[0] * (cm(0) * x[0]);
#pragma unroll
        for (int l = 1; l < NU; ++l) hc = hc + h[l] * (cm(l) * x[l]);
        R[i] = fm(i) * (g[i] + hc);
      }
    }
    T* Lt = Lb[cur];
    T y[1][NU], Ld[NU];
    const bool chol_ok = wide_cholesky<T, NU, G, 1, 1>(AF, Fd, Lt, R, y, Ld);
    if (r == 0) {   // the diagonal beside the columns, for the kept factor
#pragma unroll
      for (int j = 0; j < NU; ++j) Lt[j * NU + j] = Ld[j];
    }
    // the Newton direction on the free subspace (BoxQP.h:256-279):
    // neg_chol_solve's backward substitution, whole in every thread
#pragma unroll
    for (int i = NU - 1; i >= 0; --i) {
      T t = y[0][i];
#pragma unroll
      for (int k = i + 1; k < NU; ++k) t = t - Lt[i * NU + k] * y[0][k];
      y[0][i] = t / Ld[i];
    }
    T d[NU];
    T sdg = T(0);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      d[a] = fm(a) * (-y[0][a] - fm(a) * x[a]);
      sdg = (a == 0) ? d[0] * Gr[0] : sdg + d[a] * Gr[a];
    }
    const bool bad_dir = sdg > T(1e-10);
    const bool pre_exit =
        improve_done || all_clamped || !chol_ok || small_grad || bad_dir;

    // Armijo backtracking with projection (BoxQP.h:293-309), G candidates
    // at a time as in boxqp.cuh: rank j takes candidate k0 + j; the first
    // stop of the block is the search's
    bool searching = running && !pre_exit;
    bool exhausted = false;
    int kc = 0;
    T objc = obj;
    for (int k0 = 0; Group::any(searching); k0 += G) {
      const int k = k0 + r;
      T objk = obj;
      bool stop = false, exh = false;
      if (searching && k < n_ls) {
        const T step = steps[k];
        T xk[NU];
#pragma unroll
        for (int a = 0; a < NU; ++a)
          xk[a] = clip(x[a] + step * d[a], lo[a], hi[a]);
        objk = qp_objective_rows<T, NU, US>(H, g, xk);
        const bool armijo =
            (objk - old_obj) / (step * sdg) >= T(p.armijo_param);
        const bool below = step < T(p.min_step);
        stop = armijo || below || k + 1 >= n_ls;
        exh = below || !armijo;
      }
      const unsigned stops = Group::ballot(stop);
      const unsigned exhs = Group::ballot(exh);
      const int first = stops != 0u ? __ffs(static_cast<int>(stops)) - 1 : 0;
      const T objf = Group::bcast(objk, first);
      if (searching && stops != 0u) {
        kc = k0 + first;
        objc = objf;
        exhausted = (exhs >> first) & 1u;
        searching = false;
      }
    }

    if (running) {
      // the statuses in the reference's check order, as boxqp.cuh
      ok = improve_done || all_clamped ||
           (chol_ok && (small_grad || !bad_dir));
      if (!pre_exit) {
        const T step = steps[kc];
#pragma unroll
        for (int a = 0; a < NU; ++a)
          x[a] = clip(x[a] + step * d[a], lo[a], hi[a]);
        obj = objc;
        evals += kc + 1;
      }
      if (!improve_done) {
        free_set = fbits;
        kept = cur;
        cur ^= 1;
      }
      running = !(pre_exit || exhausted || it >= p.max_iter);
    }
  }
  return ok;
}

// One boxed backward stage of one lane on its G threads, the TPU kernel's
// _riccati_stage_boxed (every thread of the warp calls it at the same
// point): the Q expansion (wide_q_expansion); k from boxqp_wide on
// (Quu_F, Qu) over [lower - u, upper - u], warm-started from the later
// stage's k (s[Kn], updated to this stage's); K's columns
// -free (L L^T)^-1 (free Qux_reg) through the QP's kept factor, zero on
// clamped inputs; the value update with the unregularized Q terms
// (wide_value_update).  `s` is the lane's WideBoxedScratch, `p` the
// stage's fields with the bounds (Layout's lower, upper, u).  The QP's ok
// gates the carry's; iters, evals and free_set receive the QP's
// iterations, Armijo candidates and free set.  On return k and K sit in s[X] as riccati_stage_wide leaves
// them.
template <typename T, int NX, int NU, int G, int L, typename Layout>
__device__ __forceinline__ void riccati_stage_boxed_wide(
    const T* __restrict__ p, T lam, int reg_type, const BoxQPParams& qp,
    const T* steps, T* s, T& dV0, T& dV1, bool& ok, int& iters,
    int& evals, unsigned& free_set) {
  using W = WideScratch<NX, NU>;
  using S = WideBoxedScratch<NX, NU>;
  constexpr int JU = (NU + G - 1) / G;        // input rows a thread owns
  constexpr int JK = (NX + G - 1) / G;        // K's columns a thread
  const int r = LaneGroup<G>::rank();
  auto field = [p](int e) { return p[e * L]; };
  {
    T AF[(NU + NX + G - 1) / G][NU];
    wide_q_expansion<T, NX, NU, G, L, Layout>(p, lam, reg_type, s, AF);
#pragma unroll
    for (int j = 0; j < JU; ++j) {
      const int m = j * G + r;
      if (JU * G == NU || m < NU) {
#pragma unroll
        for (int c = 0; c < NU; ++c) s[S::H + m * S::US + c] = AF[j][c];
        s[S::Lo + m] = field(Layout::lower + m) - field(Layout::u + m);
        s[S::Hi + m] = field(Layout::upper + m) - field(Layout::u + m);
      }
    }
  }
  __syncwarp();
  T x[NU];
  int kept;
  T* const Lb[2] = {s + W::Lt, s + S::L1};
  ok = boxqp_wide<T, NU, G, S::US>(s + S::H, s + W::Qu, s + S::Lo,
                                   s + S::Hi, s + S::Kn, qp, steps,
                                   s + S::Gr, s + S::R, s + W::Fd, Lb, x,
                                   free_set, kept, iters, evals) &&
       ok;
  __syncwarp();   // every thread has read the warm start and the factors
#pragma unroll
  for (int j = 0; j < JU; ++j) {
    const int m = j * G + r;
    if (JU * G == NU || m < NU) {
      s[W::X + m * W::XS] = x[m];
      s[S::Kn + m] = x[m];
    }
  }
  // K's column a by rank a % G: neg_chol_solve of free Qux_reg's column
  // (s[X]'s column 1 + a) with the kept factor, times free
  const T* Lk = Lb[kept];
  auto fr = [free_set](int a) {
    return ((free_set >> a) & 1u) ? T(1) : T(0);
  };
#pragma unroll
  for (int j = 0; j < JK; ++j) {
    const int a = j * G + r;
    if (JK * G == NX || a < NX) {
      T* col = s + W::X + 1 + a;   // row i at col[i XS]
      T yk[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T t = fr(i) * col[i * W::XS];
#pragma unroll
        for (int k = 0; k < i; ++k) t = t - Lk[k * NU + i] * yk[k];
        yk[i] = t / Lk[i * NU + i];
      }
#pragma unroll
      for (int i = NU - 1; i >= 0; --i) {
        T t = yk[i];
#pragma unroll
        for (int k = i + 1; k < NU; ++k) t = t - Lk[i * NU + k] * yk[k];
        yk[i] = t / Lk[i * NU + i];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) col[i * W::XS] = fr(i) * -yk[i];
    }
  }
  __syncwarp();
  wide_value_update<T, NX, NU, G>(s, dV0, dV1);
}

}  // namespace nmpc
