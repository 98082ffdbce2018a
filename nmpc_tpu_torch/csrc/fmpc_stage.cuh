// One stage of the condensed primal-dual Riccati recursion of FMPC as a
// device function on one thread's registers: the device counterpart of the
// stage body of nmpc_tpu_torch/solvers/fmpc.py::_backward_bm (TPU:
// nmpc_tpu/kernels/fmpc_backward_pallas.py::_fmpc_stage; reference
// FmpcSolver.hpp:551-637).  Every contraction sums its terms in index
// order, one product after the other, as the plain version's torch.sum
// over the contracted axis does; built without FMA contraction, each
// operation rounds as the plain version's separate torch ops do.
// Templated on the scalar type and (NX, NU, NG).

#pragma once

#include "linalg.cuh"

namespace nmpc {

// One stage's coefficients, row-major as the batch-minor arrays, with the
// condensation scalings nu/s and tilde = (nu/s) g_bar - nu + eps/s already
// applied to the mask (zero on masked rows).
template <typename T, int NX, int NU, int NG>
struct FmpcStage {
  T A[NX][NX];
  T Bm[NX][NU];
  T C[NG][NX];
  T D[NG][NU];
  T Lxx[NX][NX];
  T Luu[NU][NU];
  T Lxu[NX][NU];
  T xb[NX];
  T Lxb[NX];
  T Lub[NU];
  T nu_s[NG];
  T tilde[NG];
};

// The (s, P, ok) carry of one lane.
template <typename T, int NX>
struct FmpcCarry {
  T s[NX];
  T P[NX][NX];
  bool ok;
};

// Stage i: writes the gains k, K and replaces the carry by (s_i, P_i).
template <typename T, int NX, int NU, int NG>
__device__ __forceinline__ void fmpc_stage(const FmpcStage<T, NX, NU, NG>& f,
                                           T dt, bool break_if_llt_fails,
                                           FmpcCarry<T, NX>& c, T k[NU],
                                           T K[NU][NX]) {
  // (s, nu) condensation (FmpcSolver.hpp:572-579): C^T diag(nu/s) C etc.
  T Qxx[NX][NX], Quu[NU][NU], Qxu[NX][NU], Lx_t[NX], Lu_t[NU];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int b = 0; b < NX; ++b) {
      T m = f.C[0][a] * (f.nu_s[0] * f.C[0][b]);
#pragma unroll
      for (int g = 1; g < NG; ++g) m = m + f.C[g][a] * (f.nu_s[g] * f.C[g][b]);
      Qxx[a][b] = dt * f.Lxx[a][b] + m;
    }
#pragma unroll
    for (int b = 0; b < NU; ++b) {
      T m = f.C[0][a] * (f.nu_s[0] * f.D[0][b]);
#pragma unroll
      for (int g = 1; g < NG; ++g) m = m + f.C[g][a] * (f.nu_s[g] * f.D[g][b]);
      Qxu[a][b] = dt * f.Lxu[a][b] + m;
    }
    T t = f.C[0][a] * f.tilde[0];
#pragma unroll
    for (int g = 1; g < NG; ++g) t = t + f.C[g][a] * f.tilde[g];
    Lx_t[a] = f.Lxb[a] + t;
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int b = 0; b < NU; ++b) {
      T m = f.D[0][a] * (f.nu_s[0] * f.D[0][b]);
#pragma unroll
      for (int g = 1; g < NG; ++g) m = m + f.D[g][a] * (f.nu_s[g] * f.D[g][b]);
      Quu[a][b] = dt * f.Luu[a][b] + m;
    }
    T t = f.D[0][a] * f.tilde[0];
#pragma unroll
    for (int g = 1; g < NG; ++g) t = t + f.D[g][a] * f.tilde[g];
    Lu_t[a] = f.Lub[a] + t;
  }

  // F = Qxx + A^T P A, H = Qxu + A^T P B, G = Quu + B^T P B
  // (FmpcSolver.hpp:581-583)
  T PA[NX][NX], PB[NX][NU], Pxb[NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int b = 0; b < NX; ++b) {
      T s = c.P[a][0] * f.A[0][b];
#pragma unroll
      for (int l = 1; l < NX; ++l) s = s + c.P[a][l] * f.A[l][b];
      PA[a][b] = s;
    }
#pragma unroll
    for (int b = 0; b < NU; ++b) {
      T s = c.P[a][0] * f.Bm[0][b];
#pragma unroll
      for (int l = 1; l < NX; ++l) s = s + c.P[a][l] * f.Bm[l][b];
      PB[a][b] = s;
    }
    T s = c.P[a][0] * f.xb[0];
#pragma unroll
    for (int l = 1; l < NX; ++l) s = s + c.P[a][l] * f.xb[l];
    Pxb[a] = s;
  }
  T F[NX][NX], H[NX][NU], G[NU][NU], HT[NU][NX], rhs[NU];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int b = 0; b < NX; ++b) {
      T s = f.A[0][a] * PA[0][b];
#pragma unroll
      for (int l = 1; l < NX; ++l) s = s + f.A[l][a] * PA[l][b];
      F[a][b] = Qxx[a][b] + s;
    }
#pragma unroll
    for (int b = 0; b < NU; ++b) {
      T s = f.A[0][a] * PB[0][b];
#pragma unroll
      for (int l = 1; l < NX; ++l) s = s + f.A[l][a] * PB[l][b];
      H[a][b] = Qxu[a][b] + s;
      HT[b][a] = H[a][b];
    }
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int b = 0; b < NU; ++b) {
      T s = f.Bm[0][a] * PB[0][b];
#pragma unroll
      for (int l = 1; l < NX; ++l) s = s + f.Bm[l][a] * PB[l][b];
      G[a][b] = Quu[a][b] + s;
    }
    // rhs = B^T (P x_bar - s) + Lu_t
    T s = f.Bm[0][a] * (Pxb[0] - c.s[0]);
#pragma unroll
    for (int l = 1; l < NX; ++l) s = s + f.Bm[l][a] * (Pxb[l] - c.s[l]);
    rhs[a] = s + Lu_t[a];
  }

  // LLT(G), and the LU fallback (FmpcSolver.hpp:594-618)
  T L[NU][NU], rhs_m[NU][1], k_m[NU][1];
#pragma unroll
  for (int a = 0; a < NU; ++a) rhs_m[a][0] = rhs[a];
  const bool pd = cholesky<T, NU>(G, L);
  neg_chol_solve<T, NU, 1>(L, rhs_m, k_m);
  neg_chol_solve<T, NU, NX>(L, HT, K);
#pragma unroll
  for (int a = 0; a < NU; ++a) k[a] = k_m[a][0];
  if (break_if_llt_fails) {
    c.ok = c.ok && pd;
  } else if (!pd) {
    // only the lanes whose LLT failed run the inverse; the result is the
    // same per lane as the plain version's select
    T Ginv[NU][NU];
    gauss_jordan_inverse<T, NU>(G, Ginv);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T s = Ginv[a][0] * rhs[0];
#pragma unroll
      for (int l = 1; l < NU; ++l) s = s + Ginv[a][l] * rhs[l];
      k[a] = -s;
#pragma unroll
      for (int b = 0; b < NX; ++b) {
        T m = Ginv[a][0] * HT[0][b];
#pragma unroll
        for (int l = 1; l < NU; ++l) m = m + Ginv[a][l] * HT[l][b];
        K[a][b] = -m;
      }
    }
  }

  // s = A^T (s - P x_bar) - Lx_t - H k,  P = F - K^T (G K), symmetrized
  // (FmpcSolver.hpp:633-637)
  T s_new[NX], GK[NU][NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    T t1 = f.A[0][a] * (c.s[0] - Pxb[0]);
#pragma unroll
    for (int l = 1; l < NX; ++l) t1 = t1 + f.A[l][a] * (c.s[l] - Pxb[l]);
    T t2 = H[a][0] * k[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) t2 = t2 + H[a][l] * k[l];
    s_new[a] = t1 - Lx_t[a] - t2;
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int b = 0; b < NX; ++b) {
      T s = G[a][0] * K[0][b];
#pragma unroll
      for (int l = 1; l < NU; ++l) s = s + G[a][l] * K[l][b];
      GK[a][b] = s;
    }
  }
  T Pn[NX][NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int b = 0; b < NX; ++b) {
      T s = K[0][a] * GK[0][b];
#pragma unroll
      for (int l = 1; l < NU; ++l) s = s + K[l][a] * GK[l][b];
      Pn[a][b] = F[a][b] - s;
    }
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    c.s[a] = s_new[a];
#pragma unroll
    for (int b = 0; b < NX; ++b) c.P[a][b] = T(0.5) * (Pn[a][b] + Pn[b][a]);
  }
}

}  // namespace nmpc
