// One stage of the condensed primal-dual Riccati recursion of FMPC as a
// device function: the device counterpart of the stage body of
// nmpc_tpu_torch/solvers/fmpc.py::_backward_bm (TPU:
// nmpc_tpu/kernels/fmpc_backward_pallas.py::_fmpc_stage; reference
// FmpcSolver.hpp:551-637), on a group of threads per lane
// (fmpc_stage_group: the streaming, resident and packed kernels K8, K9
// and K10, with fmpc_condense_group, the (s, nu) condensation K8 and K9
// fold in).  Every
// contraction sums its terms in index order, one product after the other,
// as the plain version's torch.sum over the contracted axis does; built
// without FMA contraction, each operation rounds as the plain version's
// separate torch ops do.  Templated on the scalar type and (NX, NU, NG).

#pragma once

#include "linalg.cuh"
#include "riccati_stage.cuh"

namespace nmpc {

// The (s, P, ok) carry of one lane.
template <typename T, int NX>
struct FmpcCarry {
  T s[NX];
  T P[NX][NX];
  bool ok;
};

// The (s, nu) condensation scalings of one inequality row of one stage
// (kernels/fmpc_backward.py::condensation, FmpcSolver.hpp:572-579):
// nu_s = on ? nu / s : 0 and tilde = on ? (nu_s g_bar - nu) + eps / s : 0
// (on: the row's mask > 0), in condensation()'s order of operations with
// IEEE division, so each value has the bits of the plain version's torch
// ops.
template <typename T>
__device__ __forceinline__ void fmpc_condense(T s, T nu, T g_bar, bool on,
                                              T eps, T& nu_s, T& tilde) {
  const T q = nu / s;
  nu_s = on ? q : T(0);
  tilde = on ? (q * g_bar - nu) + eps / s : T(0);
}

// The scalings of one stage in every thread of a lane's group (K8, K9): s,
// nu and g_bar read from the stage's fields (fmpc_group.cuh::
// ChunkStageFields), gm [NG] the stage's row of the inequality mask, eps
// the lane's barrier parameter.  Thread r of the group forms rows g = r,
// r + G, ... < NG; the group exchanges them by shuffles over the whole
// warp (every thread of the warp calls it at the same point).
template <typename T, int NG, int G, typename Fields>
__device__ __forceinline__ void fmpc_condense_group(const Fields& f,
                                                    const T* __restrict__ gm,
                                                    T eps, T nu_s[NG],
                                                    T tilde[NG]) {
  constexpr int J = (NG + G - 1) / G;
  const int r = LaneGroup<G>::rank();
  T ns[J], tl[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int g = min(j * G + r, NG - 1);
    fmpc_condense<T>(f.ss(g), f.nu(g), f.gbar(g), gm[g] > T(0), eps, ns[j],
                     tl[j]);
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if constexpr (G == 1) {
      nu_s[g] = ns[g];
      tilde[g] = tl[g];
    } else {
      nu_s[g] = LaneGroup<G>::bcast(ns[g / G], g % G);
      tilde[g] = LaneGroup<G>::bcast(tl[g / G], g % G);
    }
  }
}

// One stage run by the G threads of one lane's group (LaneGroup<G>: G a
// power of two, aligned in the warp), each holding the whole (s, P, ok)
// carry: the stage's fields, the condensation scalings nu_s and tilde
// among them, are read from `f` (fmpc_group.cuh: a lane's column of a
// stage in shared memory, K8's chunks of each field with the scalings its
// group formed, CondensedStageFields, or K10's chunks of the packed
// buffer, PackedStageFields).  Thread r owns the indices a = r, r + G, ...
// < NX: rows a of Qxx and Qxu and entry a of Lx_t (each a condensation
// sum over NG), rows a of P A, P B and P x_bar, rows a of F and H, entry
// a of the new s, row a of P - K^T (G K) and column a of K and G K.
// Every thread runs the NU-sized rest alike: Quu, Lu_t, G, rhs, the
// Cholesky, k, the Gauss-Jordan fallback and ok, so every branch agrees
// across the group.  G, rhs and A^T (P A) need every row of P B, P x_bar
// and P A: with SHARE the group exchanges the rows it computed by
// shuffles over the whole warp, without it every thread computes every
// row (the measurement that chose SHARE: PERF.md, Findings).  The group
// exchanges the columns of G K once the gains are known, and the rows of
// the new s and P - K^T (G K) at the end; every thread then forms the
// symmetrized P.  Each value is computed by one thread with the plain
// version's operations and the index order of each of its sums (a column
// of K by neg_chol_solve on that column alone, as neg_chol_solve solves
// its columns independently); only which thread computes it depends on G,
// so every G gives G = 1's bits (under the same contraction flags; the
// units build with -fmad=false).  An owned index is never part of a
// condition: indices past NX (G > NX, or NX not a multiple of G) repeat
// index NX - 1 and are never exchanged.  Every thread of the warp must
// call it at the same point.  Returns k in every thread and the owned
// columns of K (Kc[j][m] = K[m][a], a = r + j G) in their owner.
template <typename T, int NX, int NU, int NG, int G, bool SHARE,
          typename Fields>
__device__ __forceinline__ void fmpc_stage_group(
    const Fields& f, T dt, bool break_if_llt_fails, FmpcCarry<T, NX>& c,
    T k[NU], T Kc[(NX + G - 1) / G][NU]) {
  constexpr int J = (NX + G - 1) / G;   // indices per thread
  const int r = LaneGroup<G>::rank();
  int own[J];
#pragma unroll
  for (int j = 0; j < J; ++j) own[j] = min(j * G + r, NX - 1);
  T A[NX][NX], Bm[NX][NU], C[NG][NX], D[NG][NU], xb[NX], nu_s[NG],
      tilde[NG];
#pragma unroll
  for (int l = 0; l < NX; ++l) {
#pragma unroll
    for (int b = 0; b < NX; ++b) A[l][b] = f.A(l * NX + b);
#pragma unroll
    for (int b = 0; b < NU; ++b) Bm[l][b] = f.Bm(l * NU + b);
    xb[l] = f.xb(l);
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int b = 0; b < NX; ++b) C[g][b] = f.C(g * NX + b);
#pragma unroll
    for (int b = 0; b < NU; ++b) D[g][b] = f.D(g * NU + b);
    nu_s[g] = f.nu_s(g);
    tilde[g] = f.tilde(g);
  }

  // The condensation (sums over NG): Quu and Lu_t alike in every
  // thread, the own rows of Qxx and Qxu and entries of Lx_t.
  T Quu[NU][NU], Lu_t[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int b = 0; b < NU; ++b) {
      T m = D[0][a] * (nu_s[0] * D[0][b]);
#pragma unroll
      for (int g = 1; g < NG; ++g) m = m + D[g][a] * (nu_s[g] * D[g][b]);
      Quu[a][b] = dt * f.Luu(a * NU + b) + m;
    }
    T t = D[0][a] * tilde[0];
#pragma unroll
    for (int g = 1; g < NG; ++g) t = t + D[g][a] * tilde[g];
    Lu_t[a] = f.Lub(a) + t;
  }
  T Qxx[J][NX], Qxu[J][NU], Lx_t[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int a = own[j];
    T Ca[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) Ca[g] = f.C(g * NX + a);
#pragma unroll
    for (int b = 0; b < NX; ++b) {
      T m = Ca[0] * (nu_s[0] * C[0][b]);
#pragma unroll
      for (int g = 1; g < NG; ++g) m = m + Ca[g] * (nu_s[g] * C[g][b]);
      Qxx[j][b] = dt * f.Lxx(a * NX + b) + m;
    }
#pragma unroll
    for (int b = 0; b < NU; ++b) {
      T m = Ca[0] * (nu_s[0] * D[0][b]);
#pragma unroll
      for (int g = 1; g < NG; ++g) m = m + Ca[g] * (nu_s[g] * D[g][b]);
      Qxu[j][b] = dt * f.Lxu(a * NU + b) + m;
    }
    T t = Ca[0] * tilde[0];
#pragma unroll
    for (int g = 1; g < NG; ++g) t = t + Ca[g] * tilde[g];
    Lx_t[j] = f.Lxb(a) + t;
  }

  // P A, P B and P x_bar: every row in every thread, each owned row
  // computed by its owner (SHARE) or by every thread.
  T PA[NX][NX], PB[NX][NU], Pxb[NX];
  if constexpr (SHARE && G > 1) {
    T PAo[J][NX], PBo[J][NU], Pxbo[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      T Pa[NX];   // row own[j] of P
#pragma unroll
      for (int l = 0; l < NX; ++l) {
        Pa[l] = c.P[0][l];
#pragma unroll
        for (int e = 1; e < NX; ++e) Pa[l] = own[j] == e ? c.P[e][l] : Pa[l];
      }
#pragma unroll
      for (int b = 0; b < NX; ++b) {
        T s = Pa[0] * A[0][b];
#pragma unroll
        for (int l = 1; l < NX; ++l) s = s + Pa[l] * A[l][b];
        PAo[j][b] = s;
      }
#pragma unroll
      for (int b = 0; b < NU; ++b) {
        T s = Pa[0] * Bm[0][b];
#pragma unroll
        for (int l = 1; l < NX; ++l) s = s + Pa[l] * Bm[l][b];
        PBo[j][b] = s;
      }
      T s = Pa[0] * xb[0];
#pragma unroll
      for (int l = 1; l < NX; ++l) s = s + Pa[l] * xb[l];
      Pxbo[j] = s;
    }
#pragma unroll
    for (int a = 0; a < NX; ++a) {
#pragma unroll
      for (int b = 0; b < NX; ++b)
        PA[a][b] = LaneGroup<G>::bcast(PAo[a / G][b], a % G);
#pragma unroll
      for (int b = 0; b < NU; ++b)
        PB[a][b] = LaneGroup<G>::bcast(PBo[a / G][b], a % G);
      Pxb[a] = LaneGroup<G>::bcast(Pxbo[a / G], a % G);
    }
  } else {
#pragma unroll
    for (int a = 0; a < NX; ++a) {
#pragma unroll
      for (int b = 0; b < NX; ++b) {
        T s = c.P[a][0] * A[0][b];
#pragma unroll
        for (int l = 1; l < NX; ++l) s = s + c.P[a][l] * A[l][b];
        PA[a][b] = s;
      }
#pragma unroll
      for (int b = 0; b < NU; ++b) {
        T s = c.P[a][0] * Bm[0][b];
#pragma unroll
        for (int l = 1; l < NX; ++l) s = s + c.P[a][l] * Bm[l][b];
        PB[a][b] = s;
      }
      T s = c.P[a][0] * xb[0];
#pragma unroll
      for (int l = 1; l < NX; ++l) s = s + c.P[a][l] * xb[l];
      Pxb[a] = s;
    }
  }

  // F = Qxx + A^T P A and H = Qxu + A^T P B on the own rows, G = Quu +
  // B^T P B and rhs = B^T (P x_bar - s) + Lu_t alike (FmpcSolver.hpp:
  // 581-583).
  T F[J][NX], H[J][NU], Aa[J][NX];   // Aa[j]: column own[j] of A
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int l = 0; l < NX; ++l) Aa[j][l] = f.A(l * NX + own[j]);
#pragma unroll
    for (int b = 0; b < NX; ++b) {
      T s = Aa[j][0] * PA[0][b];
#pragma unroll
      for (int l = 1; l < NX; ++l) s = s + Aa[j][l] * PA[l][b];
      F[j][b] = Qxx[j][b] + s;
    }
#pragma unroll
    for (int b = 0; b < NU; ++b) {
      T s = Aa[j][0] * PB[0][b];
#pragma unroll
      for (int l = 1; l < NX; ++l) s = s + Aa[j][l] * PB[l][b];
      H[j][b] = Qxu[j][b] + s;
    }
  }
  T Gm[NU][NU], rhs[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int b = 0; b < NU; ++b) {
      T s = Bm[0][a] * PB[0][b];
#pragma unroll
      for (int l = 1; l < NX; ++l) s = s + Bm[l][a] * PB[l][b];
      Gm[a][b] = Quu[a][b] + s;
    }
    T s = Bm[0][a] * (Pxb[0] - c.s[0]);
#pragma unroll
    for (int l = 1; l < NX; ++l) s = s + Bm[l][a] * (Pxb[l] - c.s[l]);
    rhs[a] = s + Lu_t[a];
  }

  // LLT(G) and the LU fallback (FmpcSolver.hpp:594-618): k alike, the
  // own columns of K.
  T L[NU][NU];
  const bool pd = cholesky<T, NU>(Gm, L);
  {
    T rhs_m[NU][1], k_m[NU][1];
#pragma unroll
    for (int a = 0; a < NU; ++a) rhs_m[a][0] = rhs[a];
    neg_chol_solve<T, NU, 1>(L, rhs_m, k_m);
#pragma unroll
    for (int a = 0; a < NU; ++a) k[a] = k_m[a][0];
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    T col_in[NU][1], col[NU][1];
#pragma unroll
    for (int m = 0; m < NU; ++m) col_in[m][0] = H[j][m];
    neg_chol_solve<T, NU, 1>(L, col_in, col);
#pragma unroll
    for (int m = 0; m < NU; ++m) Kc[j][m] = col[m][0];
  }
  if (break_if_llt_fails) {
    c.ok = c.ok && pd;
  } else if (!pd) {
    T Ginv[NU][NU];
    gauss_jordan_inverse<T, NU>(Gm, Ginv);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T s = Ginv[a][0] * rhs[0];
#pragma unroll
      for (int l = 1; l < NU; ++l) s = s + Ginv[a][l] * rhs[l];
      k[a] = -s;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int m = 0; m < NU; ++m) {
        T s = Ginv[m][0] * H[j][0];
#pragma unroll
        for (int l = 1; l < NU; ++l) s = s + Ginv[m][l] * H[j][l];
        Kc[j][m] = -s;
      }
    }
  }

  // s = A^T (s - P x_bar) - Lx_t - H k and the own columns of G K, then
  // G K exchanged; P = F - K^T (G K) on the own rows, then s and P's rows
  // exchanged and P symmetrized (FmpcSolver.hpp:633-637).
  T s_own[J], GKo[J][NU];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    T t1 = Aa[j][0] * (c.s[0] - Pxb[0]);
#pragma unroll
    for (int l = 1; l < NX; ++l) t1 = t1 + Aa[j][l] * (c.s[l] - Pxb[l]);
    T t2 = H[j][0] * k[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) t2 = t2 + H[j][l] * k[l];
    s_own[j] = t1 - Lx_t[j] - t2;
#pragma unroll
    for (int m = 0; m < NU; ++m) {
      T s = Gm[m][0] * Kc[j][0];
#pragma unroll
      for (int l = 1; l < NU; ++l) s = s + Gm[m][l] * Kc[j][l];
      GKo[j][m] = s;
    }
  }
  T GK[NU][NX];
#pragma unroll
  for (int b = 0; b < NX; ++b) {
#pragma unroll
    for (int m = 0; m < NU; ++m) {
      if constexpr (G == 1) {
        GK[m][b] = GKo[b][m];
      } else {
        GK[m][b] = LaneGroup<G>::bcast(GKo[b / G][m], b % G);
      }
    }
  }
  T Pn_own[J][NX];
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int b = 0; b < NX; ++b) {
      T s = Kc[j][0] * GK[0][b];
#pragma unroll
      for (int l = 1; l < NU; ++l) s = s + Kc[j][l] * GK[l][b];
      Pn_own[j][b] = F[j][b] - s;
    }
  }
  T Pn[NX][NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    if constexpr (G == 1) {
      c.s[a] = s_own[a];
    } else {
      c.s[a] = LaneGroup<G>::bcast(s_own[a / G], a % G);
    }
#pragma unroll
    for (int b = 0; b < NX; ++b) {
      if constexpr (G == 1) {
        Pn[a][b] = Pn_own[a][b];
      } else {
        Pn[a][b] = LaneGroup<G>::bcast(Pn_own[a / G][b], a % G);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int b = 0; b < NX; ++b) c.P[a][b] = T(0.5) * (Pn[a][b] + Pn[b][a]);
  }
}

}  // namespace nmpc
