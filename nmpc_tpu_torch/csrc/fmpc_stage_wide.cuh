// The condensed PDIP Riccati stage of FMPC at the wide shapes, where a
// lane's stage passes a thread's registers: (NX, NU, NG) past (8, 4, 16)
// (fmpc_group.cuh::kFmpcWide), up to (16, 16, 64).  K8, K9 and K10 run it
// there (fmpc_backward_wide.cuh, fmpc_backward_packed_wide.cuh); at the
// narrow shapes they run fmpc_stage.cuh::fmpc_stage_group.
//
// The same stage as fmpc_stage_group (the TPU kernel's _fmpc_stage,
// nmpc_tpu/kernels/fmpc_backward_pallas.py:175, with its Gauss-Jordan
// fallback _inv_t :48; the plain version's solvers/fmpc.py::
// _riccati_condensed), split as riccati_stage_wide.cuh splits K1's.
// fmpc_stage_group unrolls every field of a stage into each thread's
// registers (A, B, C, D, the scalings: 936 values at the masses' (12, 3,
// 30)) and runs the NU-sized half and the condensation's NG-term sums
// alike in every thread; here:
//   * the lane's G threads split every product by entries, task q by rank
//     q % G, each kind of product continuing the ranks where the one
//     before it ended: the (s, nu) scalings by rows g of NG; P A, P B and
//     P x_bar; F = Qxx + A^T P A, H = Qxu + A^T P B, G = Quu + B^T P B,
//     rhs = B^T (P x_bar - s) + Lu_t and Lx_t, each entry with its
//     condensation sum over NG (C^T diag(nu/s) C, ...) folded in; the new
//     s and G K; P - K^T (G K); the symmetrized P;
//   * what a thread computes for another lives in the lane's scratch in
//     shared memory (fmpc_group.cuh::WideFmpcScratch: the carry s and P
//     too), exchanged at __syncwarp (a lane's group lies within one
//     warp); the stage's fields are read where they landed (the ring's
//     slab, value e of a field at p[e L]), never copied whole;
//   * G's Cholesky runs by rows with the forward substitution of the NX +
//     1 right-hand sides (rhs_k and the rows of H) folded in, every thread
//     forming every pivot (riccati_stage_wide.cuh::wide_cholesky), and
//     each right-hand side's backward substitution is solved whole by one
//     thread in linalg.cuh::neg_chol_solve's order;
//   * the Gauss-Jordan fallback with partial pivoting runs by rows in the
//     scratch (gauss_jordan_rows), on a warp where a lane's LLT failed and
//     break_if_llt_fails is off; every thread replays the pivot search's
//     swaps from the pivot column, so the rows move as the sequential
//     search moves them.
// Every value is computed by one thread with the operations and the order
// of each sum of fmpc_stage_group at G = 1 (index order, the plain
// version's order up to torch's reordering of long sums); only which
// thread computes it depends on G, so every G gives G = 1's bits (the
// units build with -fmad=false), ok and the NaN lanes included.  The card
// runs it at kFmpcWideGroup = 32 threads, one lane a warp.
//
// Scalar type T, (NX, NU, NG), G threads a lane (a power of two up to 32),
// the stage's fields `f` (its A(e), Bm(e), C(e), D(e), Lxx(e), Luu(e),
// Lxu(e), xb(e), Lxb(e), Lub(e) and scalings(g, nu_s, tilde) of row g),
// and a clock (FmpcClock) that the profile build of K8 and K9 reads
// between the stage's parts; in every other build it is empty.

#pragma once

#include "fmpc_group.cuh"
#include "riccati_stage_wide.cuh"

namespace nmpc {

// The parts of a lane's stage that the profile build of K8 and K9
// (fmpc_backward_wide.cuh, P) times, in this order after the outputs
// (kernels/fmpc_backward.py::WIDE_PHASES names them).
enum FmpcWidePhase : int {
  kFwWait,     // the feed's wait for the stage's buffer
  kFwScale,    // the (s, nu) scalings and P A, P B, P x_bar
  kFwSums,     // F, H, G, rhs and Lx_t with their condensation sums
  kFwFactor,   // G's Cholesky, the substitutions, the LU fallback
  kFwUpdate,   // the new s, G K, P - K^T G K and the symmetrized P
  kFwStore,    // the stores of k, K, s and P
  kFmpcWidePhases
};

// The profile build's clock (On): start() zeroes the sums, lap(p) adds
// the cycles since the last start or lap to part p.  Off, it is empty,
// and the build is the normal one.
template <bool On>
struct FmpcClock {
  __device__ void start() {}
  __device__ void lap(int) {}
};
template <>
struct FmpcClock<true> {
  long long t = 0, acc[kFmpcWidePhases] = {};
  __device__ void start() {
#pragma unroll
    for (int q = 0; q < kFmpcWidePhases; ++q) acc[q] = 0;
    t = clock64();
  }
  __device__ void lap(int q) {
    const long long now = clock64();
    acc[q] += now - t;
    t = now;
  }
};

// The first of the tasks q, q + G, ... of rank r when a kind of product's
// tasks follow `before` tasks of the kinds ahead of it.
template <int G>
__device__ __forceinline__ int next_task(int r, int before) {
  return (r - before % G + G) % G;
}

// The Gauss-Jordan inverse with partial pivoting of G (rows `gs` values
// apart at Gm) by rows of the lane's G threads into Gi, Ga the working
// copy ([NU][NU] each): the rules and the order of linalg.cuh::
// gauss_jordan_inverse (a row swaps when its entry in the pivot column is
// strictly larger in magnitude than the pivot row's, which the swap
// replaces; a zero pivot becomes 1e-30).  Every thread replays the swaps
// of a column from the pivot column and moves its own rows, forms the
// normalized pivot row, then eliminates in its own rows.  Every thread of
// the warp calls it.
template <typename T, int NU, int G>
__device__ __forceinline__ void gauss_jordan_rows(const T* __restrict__ Gm,
                                                  int gs, T* Ga, T* Gi) {
  constexpr int J = (NU + G - 1) / G;   // rows a thread owns
  const int r = LaneGroup<G>::rank();
  for (int q = r; q < NU * NU; q += G) {
    const int i = q / NU, j = q % NU;
    Ga[q] = Gm[i * gs + j];
    Gi[q] = i == j ? T(1) : T(0);
  }
  __syncwarp();
  for (int col = 0; col < NU; ++col) {
    // which row each of this thread's positions holds after the column's
    // swaps: position q > col still holds row q when the search reaches
    // it, and takes the pivot position's row if it swaps
    int src[J];
#pragma unroll
    for (int jr = 0; jr < J; ++jr) src[jr] = jr * G + r;
    int cur = col;
    T best = fabs(Ga[col * NU + col]);
    for (int q = col + 1; q < NU; ++q) {
      const T v = fabs(Ga[q * NU + col]);
      if (v > best) {
#pragma unroll
        for (int jr = 0; jr < J; ++jr)
          if (jr * G + r == q) src[jr] = cur;
        cur = q;
        best = v;
      }
    }
#pragma unroll
    for (int jr = 0; jr < J; ++jr)
      if (jr * G + r == col) src[jr] = cur;
    T ra[J][NU], ri[J][NU];
#pragma unroll
    for (int jr = 0; jr < J; ++jr) {
      const int i = jr * G + r;
      if (i < NU && src[jr] != i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          ra[jr][j] = Ga[src[jr] * NU + j];
          ri[jr][j] = Gi[src[jr] * NU + j];
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int jr = 0; jr < J; ++jr) {
      const int i = jr * G + r;
      if (i < NU && src[jr] != i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          Ga[i * NU + j] = ra[jr][j];
          Gi[i * NU + j] = ri[jr][j];
        }
      }
    }
    __syncwarp();
    const T piv = Ga[col * NU + col];
    const T ipiv = T(1) / (piv == T(0) ? T(1e-30) : piv);
    T pa[NU], pi[NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      pa[j] = Ga[col * NU + j] * ipiv;
      pi[j] = Gi[col * NU + j] * ipiv;
    }
    __syncwarp();
#pragma unroll
    for (int jr = 0; jr < J; ++jr) {
      const int i = jr * G + r;
      if (i >= NU) continue;
      if (i == col) {
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          Ga[i * NU + j] = pa[j];
          Gi[i * NU + j] = pi[j];
        }
        continue;
      }
      const T f = Ga[i * NU + col];
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        Ga[i * NU + j] = Ga[i * NU + j] - f * pa[j];
        Gi[i * NU + j] = Gi[i * NU + j] - f * pi[j];
      }
    }
    __syncwarp();
  }
}

// One condensed Riccati stage of one lane on its G threads (every thread
// of the warp calls it at the same point).  `s` is the lane's
// WideFmpcScratch, holding the carry (s, P) on entry and the next one on
// return (visible to the whole group); ok is each thread's copy of the
// lane's flag (equal across the group).  On return the stage's k and K
// sit in s[X] (k in column 0, K[m][a] at s[X + m XS + 1 + a]) until the
// next stage's Cholesky.
template <typename T, int NX, int NU, int NG, int G, typename Fields,
          typename Clock>
__device__ __forceinline__ void fmpc_stage_wide(const Fields& f, T dt,
                                                bool break_if_llt_fails,
                                                T* s, bool& ok, Clock& clk) {
  using S = WideFmpcScratch<NX, NU, NG>;
  constexpr int XS = S::XS, US = S::US;
  const int r = LaneGroup<G>::rank();
  const T* P = s + S::P;
  const T* sv = s + S::s;
  const T* ns = s + S::ns;
  const T* tl = s + S::tl;
  const T* PA = s + S::PA;
  const T* PB = s + S::PB;
  const T* Pxb = s + S::Pxb;
  T* R = s + S::R;
  T* X = s + S::X;

  // The (s, nu) scalings of each row, P A, P B and P x_bar (row a of P
  // times A's, B's and x_bar's columns).
  for (int g = r; g < NG; g += G) {
    T a, b;
    f.scalings(g, a, b);
    s[S::ns + g] = a;
    s[S::tl + g] = b;
  }
  constexpr int n0 = NG, n1 = n0 + NX * NX, n2 = n1 + NX * NU;
  for (int q = next_task<G>(r, n0); q < NX * NX; q += G) {
    const int a = q / NX, c = q % NX;
    T t = P[a * NX] * f.A(c);
    for (int l = 1; l < NX; ++l) t = t + P[a * NX + l] * f.A(l * NX + c);
    s[S::PA + q] = t;
  }
  for (int q = next_task<G>(r, n1); q < NX * NU; q += G) {
    const int a = q / NU, c = q % NU;
    T t = P[a * NX] * f.Bm(c);
    for (int l = 1; l < NX; ++l) t = t + P[a * NX + l] * f.Bm(l * NU + c);
    s[S::PB + q] = t;
  }
  for (int q = next_task<G>(r, n2); q < NX; q += G) {
    T t = P[q * NX] * f.xb(0);
    for (int l = 1; l < NX; ++l) t = t + P[q * NX + l] * f.xb(l);
    s[S::Pxb + q] = t;
  }
  __syncwarp();
  clk.lap(kFwScale);

  // F = Qxx + A^T (P A), H = Qxu + A^T (P B) (row a of H to column 1 + a
  // of R), G = Quu + B^T (P B), rhs_k = B^T (P x_bar - s) + Lu_t (column
  // 0 of R) and Lx_t (FmpcSolver.hpp:572-583), each Q block with its
  // condensation sum over NG (row g of C scaled by nu_s[g]).
  constexpr int m1 = NX * NX, m2 = m1 + NX * NU, m3 = m2 + NU * NU,
                m4 = m3 + NU;
  for (int q = r; q < NX * NX; q += G) {
    const int a = q / NX, c = q % NX;
    T m = f.C(a) * (ns[0] * f.C(c));
    for (int g = 1; g < NG; ++g)
      m = m + f.C(g * NX + a) * (ns[g] * f.C(g * NX + c));
    const T qxx = dt * f.Lxx(q) + m;
    T t = f.A(a) * PA[c];
    for (int l = 1; l < NX; ++l) t = t + f.A(l * NX + a) * PA[l * NX + c];
    s[S::F + q] = qxx + t;
  }
  for (int q = next_task<G>(r, m1); q < NX * NU; q += G) {
    const int a = q / NU, c = q % NU;
    T m = f.C(a) * (ns[0] * f.D(c));
    for (int g = 1; g < NG; ++g)
      m = m + f.C(g * NX + a) * (ns[g] * f.D(g * NU + c));
    const T qxu = dt * f.Lxu(q) + m;
    T t = f.A(a) * PB[c];
    for (int l = 1; l < NX; ++l) t = t + f.A(l * NX + a) * PB[l * NU + c];
    R[c * XS + 1 + a] = qxu + t;
  }
  for (int q = next_task<G>(r, m2); q < NU * NU; q += G) {
    const int a = q / NU, c = q % NU;
    T m = f.D(a) * (ns[0] * f.D(c));
    for (int g = 1; g < NG; ++g)
      m = m + f.D(g * NU + a) * (ns[g] * f.D(g * NU + c));
    const T quu = dt * f.Luu(q) + m;
    T t = f.Bm(a) * PB[c];
    for (int l = 1; l < NX; ++l) t = t + f.Bm(l * NU + a) * PB[l * NU + c];
    s[S::Gm + a * US + c] = quu + t;
  }
  for (int q = next_task<G>(r, m3); q < NU; q += G) {
    T m = f.D(q) * tl[0];
    for (int g = 1; g < NG; ++g) m = m + f.D(g * NU + q) * tl[g];
    const T lu = f.Lub(q) + m;
    T t = f.Bm(q) * (Pxb[0] - sv[0]);
    for (int l = 1; l < NX; ++l)
      t = t + f.Bm(l * NU + q) * (Pxb[l] - sv[l]);
    R[q * XS] = t + lu;
  }
  for (int q = next_task<G>(r, m4); q < NX; q += G) {
    T m = f.C(q) * tl[0];
    for (int g = 1; g < NG; ++g) m = m + f.C(g * NX + q) * tl[g];
    s[S::Lxt + q] = f.Lxb(q) + m;
  }
  __syncwarp();
  clk.lap(kFwSums);

  // LLT(G) by rows with the forward substitution of the NX + 1 right-hand
  // sides, then each own right-hand side's backward substitution: k and
  // the columns of K, negated, to X (FmpcSolver.hpp:594-605).
  constexpr int JU = (NU + G - 1) / G;        // rows of G a thread owns
  constexpr int M = NX + 1;                   // right-hand sides
  constexpr int JC = (M + G - 1) / G;         // right-hand sides a thread
  T AF[JU][NU];
#pragma unroll
  for (int jr = 0; jr < JU; ++jr) {
    const int i = jr * G + r;
#pragma unroll
    for (int c = 0; c < NU; ++c) AF[jr][c] = i < NU ? s[S::Gm + i * US + c] : T(0);
  }
  T Ld[NU], y[JC][NU];
  const T* Lt = s + S::Lt;
  const bool pd = wide_cholesky<T, NU, G, M, XS>(AF, s + S::Fd, s + S::Lt,
                                                 R, y, Ld);
#pragma unroll
  for (int jc = 0; jc < JC; ++jc) {
    const int c = jc * G + r;
#pragma unroll
    for (int i = NU - 1; i >= 0; --i) {
      T t = y[jc][i];
#pragma unroll
      for (int k = i + 1; k < NU; ++k) t = t - Lt[i * NU + k] * y[jc][k];
      y[jc][i] = t / Ld[i];
    }
    if (JC * G == M || c < M) {
#pragma unroll
      for (int i = 0; i < NU; ++i) X[i * XS + c] = -y[jc][i];
    }
  }
  __syncwarp();
  // the LU fallback on a non-PD G (FmpcSolver.hpp:608-617): G's inverse on
  // every lane of a warp where one needs it, k = -G^-1 rhs_k and K = -G^-1
  // H^T on the lanes that do
  const bool lu = !break_if_llt_fails && !pd;
  if (break_if_llt_fails) ok = ok && pd;
  if (LaneGroup<G>::any(lu)) {
    const T* Gi = s + S::Gi;
    gauss_jordan_rows<T, NU, G>(s + S::Gm, US, s + S::Ga, s + S::Gi);
    if (lu) {
      for (int q = r; q < NU * M; q += G) {
        const int m = q / M, c = q % M;
        T t = Gi[m * NU] * R[c];
        for (int l = 1; l < NU; ++l) t = t + Gi[m * NU + l] * R[l * XS + c];
        X[m * XS + c] = -t;
      }
    }
    __syncwarp();
  }
  clk.lap(kFwFactor);

  // s = A^T (s - P x_bar) - Lx_t - H k and G K (FmpcSolver.hpp:633-635)
  for (int q = r; q < NX; q += G) {
    T t1 = f.A(q) * (sv[0] - Pxb[0]);
    for (int l = 1; l < NX; ++l)
      t1 = t1 + f.A(l * NX + q) * (sv[l] - Pxb[l]);
    T t2 = R[1 + q] * X[0];
    for (int l = 1; l < NU; ++l) t2 = t2 + R[l * XS + 1 + q] * X[l * XS];
    s[S::sn + q] = t1 - s[S::Lxt + q] - t2;
  }
  for (int q = next_task<G>(r, NX); q < NU * NX; q += G) {
    const int m = q / NX, c = q % NX;
    T t = s[S::Gm + m * US] * X[1 + c];
    for (int l = 1; l < NU; ++l)
      t = t + s[S::Gm + m * US + l] * X[l * XS + 1 + c];
    s[S::GK + q] = t;
  }
  __syncwarp();
  // P - K^T (G K) (to P A's place), then P symmetrized and the new s
  // (FmpcSolver.hpp:636-637)
  for (int q = r; q < NX * NX; q += G) {
    const int a = q / NX, c = q % NX;
    T t = X[1 + a] * s[S::GK + c];
    for (int l = 1; l < NU; ++l)
      t = t + X[l * XS + 1 + a] * s[S::GK + l * NX + c];
    s[S::PA + q] = s[S::F + q] - t;
  }
  __syncwarp();
  for (int q = r; q < NX * NX; q += G) {
    const int a = q / NX, c = q % NX;
    s[S::P + q] = T(0.5) * (s[S::PA + q] + s[S::PA + c * NX + a]);
  }
  for (int q = next_task<G>(r, NX * NX); q < NX; q += G)
    s[S::s + q] = s[S::sn + q];
  __syncwarp();
  clk.lap(kFwUpdate);
}

}  // namespace nmpc
