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
//     masked system's Cholesky (qp_cholesky: every thread forms every
//     pivot, each sum kept running in its one-thread order so that a
//     pivot waits on one term, the pivot and L[k+1][k] by shuffle, the
//     rest of each column of L exchanged through the scratch at
//     __syncwarp) with the right-hand side's forward substitution beside
//     it; every thread then runs the backward substitution whole, in
//     neg_chol_solve's order, so that each holds the Newton direction
//     without an exchange, reading L by 16-byte loads;
//   * the square roots and divisions of the Cholesky and the
//     substitutions are straight-line (rn_ops.cuh: the IEEE result with
//     no branch, so that nothing is kept from overlapping them); where
//     one cannot vouch for a result the iteration's solve runs again
//     with the native operations;
//   * the Armijo schedule is evaluated G candidates at a time, one a
//     thread, as in boxqp.cuh (each candidate's objective in _obj_bl's
//     order); the block's first stop, found by a ballot, is the search's,
//     and every thread forms the chosen iterate itself from its step
//     (the same operations on the same values as the thread that
//     evaluated it), so only the objective is exchanged;
//   * the factor of each iteration (and its pivots' reciprocals) goes to
//     one of two buffers, the other holding the factor the plain version
//     keeps (a small-improvement exit keeps the previous one); K's
//     columns are solved with it, one column a thread, the forward
//     substitution running as the Cholesky's does, clamped rows exactly
//     0.
// Every value is computed by one thread with the operations and the order
// of boxqp.cuh and riccati_stage_boxed at G = 1; only which thread
// computes it depends on G, so every G gives G = 1's bits (the units
// build with -fmad=false).  The QP's loops run until the warp's last lane
// is done (a done lane idles), so the whole warp meets at every barrier,
// ballot and shuffle.

#pragma once

#include "boxqp.cuh"
#include "riccati_stage_wide.cuh"
#include "rn_ops.cuh"

namespace nmpc {

// 16 bytes of T (four floats, two doubles) read from shared memory by one
// load, into v[0 .. n - 1].
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  }
};
template <>
struct Vec16<double> {
  static constexpr int n = 2;
  __device__ static void load(const double* p, double* v) {
    const double2 w = *reinterpret_cast<const double2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  }
};

// v[c] = p[c] for every c in [a, N) (and the values before a that share
// its 16 bytes), p 16-byte aligned, by 16-byte loads: a column of the
// QP's factor buffers, which start 16-byte aligned.
template <typename T, int N>
__device__ __forceinline__ void load_tail(const T* p, int a, T (&v)[N]) {
  constexpr int n = Vec16<T>::n;
  static_assert(N % n == 0, "a column is whole 16-byte loads");
#pragma unroll
  for (int q = 0; q < N; q += n)
    if (q + n > a) Vec16<T>::load(p + q, v + q);
}

// A lane's scratch of the boxed wide stage, offsets in values: the
// unboxed stage's (WideScratch), then the QP's.  The QP's two factor
// buffers keep L by columns FS values apart (a multiple of four), then
// 1 / L's diagonal (the pivots' rounded reciprocals), each 16-byte
// aligned as the lane's scratch is, so that a column reads by 16-byte
// loads; the first takes the place of WideScratch's Lt and Fd, which the
// boxed stage does not use, where it fits there.
template <int NX, int NU>
struct WideBoxedScratch {
  using W = WideScratch<NX, NU>;
  static constexpr int up4(int v) { return (v + 3) / 4 * 4; }
  static constexpr int US = W::US;
  static constexpr int FS = up4(NU);         // a factor column's stride
  static constexpr int H = W::size;          // Quu_F [NU][US]: the QP's H
  static constexpr int Lo = H + NU * US;     // lower - u [NU]
  static constexpr int Hi = Lo + NU;         // upper - u [NU]
  static constexpr int Kn = Hi + NU;         // the warm start [NU]
  static constexpr int Gr = Kn + NU;         // the gradient [NU]
  static constexpr int R = Gr + NU;          // the Newton step's rhs [NU]
  static constexpr int LS = NU * FS + FS;     // a factor buffer
  static constexpr bool in_lt = up4(W::Lt) + LS <= W::Vn;
  // the factor buffers: [NU][FS], then [FS] (NU used)
  static constexpr int L0 = in_lt ? up4(W::Lt) : up4(R + NU);
  static constexpr int L1 = in_lt ? up4(R + NU) : L0 + LS;
  static constexpr int size = L1 + LS;
};

// The phases of a wide boxed stage that the profile build times
// (ddp_backward_boxed_wide.cuh's launch at kProfile): clock64() cycles a
// (stage, lane) on the group's rank 0, the QP's summed over its
// iterations, stored after the QP stats (ddp_backward_boxed.py::
// WIDE_PHASES names them in this order).
enum WidePhase : int {
  kPhWait,     // the ring's wait for the stage's buffer
  kPhExpand,   // the Q expansion; the QP's H and bounds to the scratch
  kPhGrad,     // the gradient, the clamped set and its norm
  kPhSystem,   // the masked system and the Newton step's right-hand side
  kPhChol,     // its Cholesky and the forward substitution
  kPhSolve,    // the backward substitution, the direction and sdg
  kPhArmijo,   // the Armijo rounds and the iterate's update
  kPhKcols,    // K's columns through the kept factor
  kPhValue,    // the value update
  kPhStore,    // the gains' stores
  kWidePhases
};

// The profile build's clock (On): start() zeroes the sums, lap(p) adds
// the cycles since the last start or lap to phase p.  Off, it is empty,
// and the build is the normal one.
template <bool On>
struct PhaseClock {
  __device__ void start() {}
  __device__ void lap(int) {}
};
template <>
struct PhaseClock<true> {
  long long t = 0, acc[kWidePhases] = {};
  __device__ void start() {
#pragma unroll
    for (int q = 0; q < kWidePhases; ++q) acc[q] = 0;
    t = clock64();
  }
  __device__ void lap(int q) {
    const long long now = clock64();
    acc[q] += now - t;
    t = now;
  }
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

// The QP's masked system's Cholesky by rows on the lane's G threads, with
// the forward substitution of the Newton step's right-hand side: the sums
// of the plain version's _chol_bl and _chol_solve_bl, each still taken k
// = 0, 1, ... in order, but kept running (right-looking): term k leaves
// every sum as soon as column k of L is known, so that a pivot waits on
// one term, not on a re-summation of all before it (as riccati_stage_
// wide.cuh::wide_cholesky, K1's, does between its barriers).  This thread
// holds rows i = j G + r < NU of the system in AF[j] and their diagonals
// in Dg[j]; they become its rows of L, each entry also written by columns
// to Lt (Lt[k FS + i] = L[i][k]), the diagonal beside them (Lt[k FS + k]
// = L[k][k], by rank 0).  At pivot k:
//   * d reaches every thread by one shuffle from the owner of row k, who
//     subtracted L[k][k-1]^2 from its diagonal as soon as it formed
//     L[k][k-1]; every thread forms sqrt(d) and 1 / sqrt(d) itself;
//   * L[k+1][k] reaches every thread by a shuffle too, and each subtracts
//     L[i][k] L[k+1][k] from its rows' column k + 1 at once (the next
//     pivot's terms); column k's other rows go through Lt at one
//     __syncwarp (read by 16-byte loads), after which each thread
//     subtracts its terms from its
//     rows' later columns and every thread from the right-hand side's
//     running sums, y[k] the k-th (read from R after the first barrier).
// Square roots and divisions by Ops (rn_ops.cuh; `tiny` marks a result
// it cannot vouch for).  On return y holds the forward solution in every
// thread, Lt the factor and Lt[NU FS + k] = 1 / L[k][k], visible to the
// group.  Returns whether every pivot was > 0 and finite (the LLT rule).
template <typename T, int NU, int G, int FS, typename Ops>
__device__ __forceinline__ bool qp_cholesky(T (&AF)[(NU + G - 1) / G][NU],
                                            T (&Dg)[(NU + G - 1) / G],
                                            const T* R, T* Lt, T (&y)[NU],
                                            bool& tiny) {
  using Group = LaneGroup<G>;
  constexpr int JU = (NU + G - 1) / G;        // rows a thread owns
  const int r = Group::rank();
  bool good = true;
  T d = Group::bcast(Dg[0], 0);   // row 0's diagonal, from its owner
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    good = good && (d > T(0)) && finite(d);
    const T Ld = Ops::sqrt_pos(d > T(0) ? d : T(1), tiny);
    const typename Ops::Rcp rd = Ops::rcp(Ld);
    const T inv = Ops::div(T(1), rd, tiny);
    T lnext = T(0);   // L[k+1][k]
#pragma unroll
    for (int jr = 0; jr < JU; ++jr) {
      const int i = jr * G + r;
      if (jr * G + G - 1 > k && i > k && i < NU) {
        AF[jr][k] = AF[jr][k] * inv;
        Lt[k * FS + i] = AF[jr][k];
        Dg[jr] = Dg[jr] - AF[jr][k] * AF[jr][k];
      }
    }
    if (r == 0) {
      Lt[k * FS + k] = Ld;
      Lt[NU * FS + k] = inv;
    }
    if (k + 1 < NU) {
      const int jn = (k + 1) / G, src = (k + 1) % G;   // row k + 1's owner
      d = Group::bcast(Dg[jn], src);
      lnext = Group::bcast(AF[jn][k], src);
#pragma unroll
      for (int jr = 0; jr < JU; ++jr) {
        const int i = jr * G + r;
        if (jr * G + G - 1 > k + 1 && i > k + 1 && i < NU)
          AF[jr][k + 1] = AF[jr][k + 1] - AF[jr][k] * lnext;
      }
    }
    __syncwarp();   // column k of L in Lt; R after the first
    if (k == 0) {
#pragma unroll
      for (int c = 0; c < NU; ++c) y[c] = R[c];
    }
    y[k] = Ops::div(y[k], rd, tiny);
    T col[FS];   // L[c][k] for c > k + 1
    load_tail<T, FS>(Lt + k * FS, k + 2, col);
#pragma unroll
    for (int c = k + 1; c < NU; ++c) {
      const T lc = c == k + 1 ? lnext : col[c];   // L[c][k]
      y[c] = y[c] - lc * y[k];
      if (c > k + 1) {
#pragma unroll
        for (int jr = 0; jr < JU; ++jr) {
          const int i = jr * G + r;
          if (jr * G + G - 1 > c && i > c && i < NU)
            AF[jr][c] = AF[jr][c] - AF[jr][k] * lc;
        }
      }
    }
  }
  return good;
}

// The backward substitution of L^T x = y in place, whole in one thread, in
// neg_chol_solve's order (each row's sum over k = i + 1 ... NU - 1
// ascending while x becomes known from NU - 1 down, so no running sum),
// L by columns FS values apart in Lt (row i of L^T read by 16-byte
// loads), 1 / L's diagonal after it, divisions by Ops.
template <typename T, int NU, int FS, typename Ops>
__device__ __forceinline__ void back_substitute(const T* Lt, T (&y)[NU],
                                                bool& tiny) {
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) {
    T row[FS];   // L[k][i] for k >= i
    load_tail<T, FS>(Lt + i * FS, i, row);
    T t = y[i];
#pragma unroll
    for (int k = i + 1; k < NU; ++k) t = t - row[k] * y[k];
    y[i] = Ops::div(t, Ops::from(row[i], Lt[NU * FS + i]), tiny);
  }
}

// K's column: -(L L^T)^-1 of the right-hand side in yk, in place, by the
// kept factor Lk (by columns FS values apart): the forward substitution
// right-looking (column k of L by 16-byte loads takes its term from every
// later row's running sum, each sum's terms still k = 0, 1, ... in
// order), then back_substitute; divisions by Ops.
template <typename T, int NU, int FS, typename Ops>
__device__ __forceinline__ void chol_solve_column(const T* Lk, T (&yk)[NU],
                                                  bool& tiny) {
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    T lk[FS];   // L[i][k] for i >= k
    load_tail<T, FS>(Lk + k * FS, k, lk);
    yk[k] = Ops::div(yk[k], Ops::from(lk[k], Lk[NU * FS + k]), tiny);
#pragma unroll
    for (int i = k + 1; i < NU; ++i) yk[i] = yk[i] - lk[i] * yk[k];
  }
  back_substitute<T, NU, FS, Ops>(Lk, yk, tiny);
}

// The Newton step's solve on the free subspace (BoxQP.h:244-279) by Ops:
// this thread's rows of the masked system F H F + C (free set fbits;
// their diagonals apart) and of the right-hand side F (g + H C x) to R,
// the system's Cholesky into Lt (qp_cholesky) and the solution, whole in
// every thread, into y (back_substitute).  Returns the LLT rule's
// verdict; `tiny` marks a result Ops cannot vouch for.
template <typename T, int NU, int G, int US, int FS, typename Ops, bool P>
__device__ __forceinline__ bool qp_newton(const T* H, const T* g,
                                          const T (&x)[NU], unsigned fbits,
                                          T* R, T* Lt, T (&y)[NU],
                                          bool& tiny, PhaseClock<P>& clk) {
  constexpr int JU = (NU + G - 1) / G;        // rows a thread owns
  const int r = LaneGroup<G>::rank();
  auto fm = [fbits](int a) { return ((fbits >> a) & 1u) ? T(1) : T(0); };
  auto cm = [fbits](int a) { return ((fbits >> a) & 1u) ? T(0) : T(1); };
  T AF[JU][NU], Dg[JU];
#pragma unroll
  for (int j = 0; j < JU; ++j) {
    const int i = j * G + r;
    if (JU * G == NU || i < NU) {
      const T* h = H + i * US;
#pragma unroll
      for (int c = 0; c < NU; ++c)
        AF[j][c] = fm(i) * h[c] * fm(c) + (i == c ? cm(c) : T(0));
      Dg[j] = fm(i) * h[i] * fm(i) + cm(i);
      T hc = h[0] * (cm(0) * x[0]);
#pragma unroll
      for (int l = 1; l < NU; ++l) hc = hc + h[l] * (cm(l) * x[l]);
      R[i] = fm(i) * (g[i] + hc);
    } else {
      Dg[j] = T(0);
    }
  }
  clk.lap(kPhSystem);
  const bool chol_ok = qp_cholesky<T, NU, G, FS, Ops>(AF, Dg, R, Lt, y, tiny);
  clk.lap(kPhChol);
  back_substitute<T, NU, FS, Ops>(Lt, y, tiny);
  return chol_ok;
}

// chol_solve_column's sums with the native operations, in place in the
// column (row i at col[i XS]) instead of registers: where a division is
// native (fp64), its slow path is a call, and the registers live across
// it are spilled unless few are.
template <typename T, int NU, int FS, int XS>
__device__ __forceinline__ void chol_solve_column_in_place(const T* Lk,
                                                           T* col) {
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    T lk[FS];   // L[i][k] for i >= k
    load_tail<T, FS>(Lk + k * FS, k, lk);
    const T yk = col[k * XS] / lk[k];
    col[k * XS] = yk;
#pragma unroll
    for (int i = k + 1; i < NU; ++i)
      col[i * XS] = col[i * XS] - lk[i] * yk;
  }
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) {
    T row[FS];   // L[k][i] for k >= i
    load_tail<T, FS>(Lk + i * FS, i, row);
    T t = col[i * XS];
#pragma unroll
    for (int k = i + 1; k < NU; ++k) t = t - row[k] * col[k * XS];
    col[i * XS] = t / row[i];
  }
}

// Minimize 0.5 x'Hx + g'x on [lo, hi] from the warm start x0 by the G
// threads of the lane's group (every thread of the warp calls it at the
// same point).  H ([NU][US]), g, lo, hi and x0 lie in the lane's
// scratch; Gr the gradient and R the Newton step's right-hand side ([NU]
// each), Lb the QP's first factor
// buffer and Lb + LD its second (each L by columns: Lb[k FS + i] =
// L[i][k], the diagonal at Lb[j FS + j], then 1 / the diagonal; one
// pointer and a constant apart, so that the compiler keeps them in
// shared memory's address space); `steps` is the block's
// fill_step_table schedule.  On return every thread of the group holds
// the solution in x, the free set of the last factorization the plain
// version keeps in `free_set` (bit a: input a free) and that factor at
// Lb + kept LD, the lane's QP
// iterations in `iters` and the Armijo candidates its searches visited in
// all in `evals` (the plain version's stats).  Returns false on a failing
// status (HESSIAN_NOT_PD, POSITIVE_DIR_DERIV).
template <typename T, int NU, int G, int US, int FS, int LD, bool P>
__device__ __forceinline__ bool boxqp_wide(
    const T* H, const T* g, const T* lo, const T* hi, const T* x0,
    const BoxQPParams& p, const T* steps, T* Gr, T* R, T* Lb,
    T (&x)[NU], unsigned& free_set, int& kept, int& iters, int& evals,
    PhaseClock<P>& clk) {
  static_assert(NU < 32, "the free set is a 32-bit mask");
  using Group = LaneGroup<G>;
  constexpr int JU = (NU + G - 1) / G;        // rows a thread owns
  const int r = Group::rank();
  const int n_ls = p.max_ls_iter + 1;
  free_set = (1u << NU) - 1u;
  kept = 0;
  iters = 0;
  evals = 0;
  if (p.max_iter <= 0) {   // the plain version's initial factor: I
    for (int e = r; e < NU * FS + NU; e += G)
      Lb[e] = (e >= NU * FS || e % FS == e / FS) ? T(1) : T(0);
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) x[a] = clip(x0[a], lo[a], hi[a]);
  T obj = qp_objective_rows<T, NU, US>(H, g, x);
  clk.lap(kPhGrad);
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
    const bool small_grad = gn2 < T(p.grad_thre * p.grad_thre);
    clk.lap(kPhGrad);

    // the Newton direction on the free subspace, straight-line (RnOps);
    // where a result is marked, solved again with the native operations
    T* Lt = Lb + cur * LD;
    T y[NU];   // the solution, then the direction
    bool tiny = false;
    bool chol_ok = qp_newton<T, NU, G, US, FS, RnOps<T>>(H, g, x, fbits, R,
                                                         Lt, y, tiny, clk);
    if (Group::any(tiny))
      chol_ok = qp_newton<T, NU, G, US, FS, NativeOps<T>>(
          H, g, x, fbits, R, Lt, y, tiny, clk);
    T sdg = T(0);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      y[a] = fm(a) * (-y[a] - fm(a) * x[a]);   // the direction d
      sdg = (a == 0) ? y[0] * Gr[0] : sdg + y[a] * Gr[a];
    }
    const T (&d)[NU] = y;
    const bool bad_dir = sdg > T(1e-10);
    const bool pre_exit =
        improve_done || all_clamped || !chol_ok || small_grad || bad_dir;
    clk.lap(kPhSolve);

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
    clk.lap(kPhArmijo);
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
template <typename T, int NX, int NU, int G, int L, typename Layout,
          bool P>
__device__ __forceinline__ void riccati_stage_boxed_wide(
    const T* __restrict__ p, T lam, int reg_type, const BoxQPParams& qp,
    const T* steps, T* s, T& dV0, T& dV1, bool& ok, int& iters,
    int& evals, unsigned& free_set, PhaseClock<P>& clk) {
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
  clk.lap(kPhExpand);
  T x[NU];
  int kept;
  constexpr int LD = S::L1 - S::L0;   // the second buffer's offset
  ok = boxqp_wide<T, NU, G, S::US, S::FS, LD>(
           s + S::H, s + W::Qu, s + S::Lo, s + S::Hi, s + S::Kn, qp, steps,
           s + S::Gr, s + S::R, s + S::L0, x, free_set, kept, iters, evals,
           clk) &&
       ok;
  __syncwarp();   // every thread has read the warm start and the factors
  if (r == 0) {   // (x[m] by rank m would index x at run time: local memory)
#pragma unroll
    for (int m = 0; m < NU; ++m) {
      s[W::X + m * W::XS] = x[m];
      s[S::Kn + m] = x[m];
    }
  }
  // K's column a by rank a % G: neg_chol_solve of free Qux_reg's column
  // (s[X]'s column 1 + a) with the kept factor, times free
  const T* Lk = s + S::L0 + kept * LD;
  auto fr = [free_set](int a) {
    return ((free_set >> a) & 1u) ? T(1) : T(0);
  };
#pragma unroll
  for (int j = 0; j < JK; ++j) {
    const int a = j * G + r;
    const bool mine = JK * G == NX || a < NX;
    T* col = s + W::X + 1 + (mine ? a : 0);   // row i at col[i XS]
    if constexpr (RnOps<T>::exact) {   // native: in place (fp64)
      if (mine) {
#pragma unroll
        for (int i = 0; i < NU; ++i) col[i * W::XS] = fr(i) * col[i * W::XS];
        chol_solve_column_in_place<T, NU, S::FS, W::XS>(Lk, col);
#pragma unroll
        for (int i = 0; i < NU; ++i) col[i * W::XS] = fr(i) * -col[i * W::XS];
      }
      continue;
    }
    T yk[NU];
    bool tiny = false;
    if (mine) {
#pragma unroll
      for (int i = 0; i < NU; ++i) yk[i] = fr(i) * col[i * W::XS];
      chol_solve_column<T, NU, S::FS, RnOps<T>>(Lk, yk, tiny);
    }
    if constexpr (!RnOps<T>::exact) {
      if (LaneGroup<G>::any(tiny) && mine) {   // natively
#pragma unroll
        for (int i = 0; i < NU; ++i) yk[i] = fr(i) * col[i * W::XS];
        chol_solve_column<T, NU, S::FS, NativeOps<T>>(Lk, yk, tiny);
      }
    }
    if (mine) {
#pragma unroll
      for (int i = 0; i < NU; ++i) col[i * W::XS] = fr(i) * -yk[i];
    }
  }
  __syncwarp();
  clk.lap(kPhKcols);
  wide_value_update<T, NX, NU, G>(s, dV0, dV1);
  clk.lap(kPhValue);
}

}  // namespace nmpc
