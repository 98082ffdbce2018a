// The DDP Riccati stages as device functions, shared by the backward
// kernels: ddp_backward.cu (sweep-fed, TPU K1), ddp_backward_boxed.cuh
// (sweep-fed boxed, TPU K4) and the generated remat backward
// (ddp_backward_remat.cuh, TPU K5, unboxed and boxed), as the TPU kernels
// share nmpc_tpu/kernels/ddp_backward_pallas.py::_riccati_stage and
// _riccati_stage_boxed.  The math and the order of each sum follow
// _riccati_stage.  Templated on the scalar type and on (NX, NU).

#pragma once

#include "boxqp.cuh"
#include "linalg.cuh"

namespace nmpc {

// One stage's derivative fields, row-major as the batch-minor arrays.
template <typename T, int NX, int NU>
struct Stage {
  T Fx[NX][NX];
  T Fu[NX][NU];
  T Lx[NX];
  T Lu[NU];
  T Lxx[NX][NX];
  T Luu[NU][NU];
  T Lxu[NX][NU];
};

// The (Vx, Vxx, dV, ok) value-function carry of one lane.
template <typename T, int NX>
struct Carry {
  T Vx[NX];
  T Vxx[NX][NX];
  T dV0, dV1;
  bool ok;
};

// The Q-function expansion of one stage (the first half of the TPU
// kernel's _riccati_stage): Qu, Qx, Qux, Quu, Qxx from the fields and the
// carry, and the regularized blocks Qux_reg, Quu_F (reg_type 1: Quu +
// lam I; reg_type 2: Vxx + lam I in Qux_reg / Quu_F).
template <typename T, int NX, int NU>
__device__ __forceinline__ void q_expansion(
    const Stage<T, NX, NU>& cur, T lam, int reg_type,
    const Carry<T, NX>& carry, T Qu[NU], T Qx[NX], T Qux[NU][NX],
    T Quu[NU][NU], T Qxx[NX][NX], T Qux_reg[NU][NX], T Quu_F[NU][NU]) {
  const T(&Vx)[NX] = carry.Vx;
  const T(&Vxx)[NX][NX] = carry.Vxx;
  // Q-function expansion.
  T FuT_Vxx[NU][NX], FxT_Vxx[NX][NX];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    T s = cur.Fu[0][a] * Vx[0];
#pragma unroll
    for (int l = 1; l < NX; ++l) s = s + cur.Fu[l][a] * Vx[l];
    Qu[a] = cur.Lu[a] + s;
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T t = cur.Fu[0][a] * Vxx[0][c];
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + cur.Fu[l][a] * Vxx[l][c];
      FuT_Vxx[a][c] = t;
    }
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    T s = cur.Fx[0][a] * Vx[0];
#pragma unroll
    for (int l = 1; l < NX; ++l) s = s + cur.Fx[l][a] * Vx[l];
    Qx[a] = cur.Lx[a] + s;
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T t = cur.Fx[0][a] * Vxx[0][c];
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + cur.Fx[l][a] * Vxx[l][c];
      FxT_Vxx[a][c] = t;
    }
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T t = FuT_Vxx[a][0] * cur.Fx[0][c];
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + FuT_Vxx[a][l] * cur.Fx[l][c];
      Qux[a][c] = cur.Lxu[c][a] + t;
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      T t = FuT_Vxx[a][0] * cur.Fu[0][c];
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + FuT_Vxx[a][l] * cur.Fu[l][c];
      Quu[a][c] = cur.Luu[a][c] + t;
    }
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T t = FxT_Vxx[a][0] * cur.Fx[0][c];
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + FxT_Vxx[a][l] * cur.Fx[l][c];
      Qxx[a][c] = cur.Lxx[a][c] + t;
    }
  }

  // Regularization: reg_type 2 puts lam on Vxx, reg_type 1 on Quu.
  if (reg_type == 2) {
    T FuT_Vr[NU][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        T t = cur.Fu[0][a] * (Vxx[0][c] + (c == 0 ? lam : T(0)));
#pragma unroll
        for (int l = 1; l < NX; ++l)
          t = t + cur.Fu[l][a] * (Vxx[l][c] + (c == l ? lam : T(0)));
        FuT_Vr[a][c] = t;
      }
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        T t = FuT_Vr[a][0] * cur.Fx[0][c];
#pragma unroll
        for (int l = 1; l < NX; ++l) t = t + FuT_Vr[a][l] * cur.Fx[l][c];
        Qux_reg[a][c] = cur.Lxu[c][a] + t;
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T t = FuT_Vr[a][0] * cur.Fu[0][c];
#pragma unroll
        for (int l = 1; l < NX; ++l) t = t + FuT_Vr[a][l] * cur.Fu[l][c];
        Quu_F[a][c] = cur.Luu[a][c] + t;
      }
    }
  } else {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int c = 0; c < NX; ++c) Qux_reg[a][c] = Qux[a][c];
#pragma unroll
      for (int c = 0; c < NU; ++c)
        Quu_F[a][c] = Quu[a][c] + ((reg_type == 1 && a == c) ? lam : T(0));
    }
  }
}

// The value-function carry from the unregularized Q terms and the stage's
// gains k, K: dV, Vx and the symmetrized Vxx.
template <typename T, int NX, int NU>
__device__ __forceinline__ void value_update(
    const T Qu[NU], const T Qx[NX], const T Qux[NU][NX],
    const T Quu[NU][NU], const T Qxx[NX][NX], const T k[NU],
    const T K[NU][NX], Carry<T, NX>& carry) {
  T(&Vx)[NX] = carry.Vx;
  T(&Vxx)[NX][NX] = carry.Vxx;
  T Quu_k[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    T s = Quu[a][0] * k[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) s = s + Quu[a][l] * k[l];
    Quu_k[a] = s;
  }
  {
    T s0 = k[0] * Qu[0];
    T s1 = k[0] * Quu_k[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) {
      s0 = s0 + k[a] * Qu[a];
      s1 = s1 + k[a] * Quu_k[a];
    }
    carry.dV0 = carry.dV0 + s0;
    carry.dV1 = carry.dV1 + T(0.5) * s1;
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    T t1 = K[0][a] * Quu_k[0];
    T t2 = K[0][a] * Qu[0];
    T t3 = Qux[0][a] * k[0];
#pragma unroll
    for (int l = 1; l < NU; ++l) {
      t1 = t1 + K[l][a] * Quu_k[l];
      t2 = t2 + K[l][a] * Qu[l];
      t3 = t3 + Qux[l][a] * k[l];
    }
    Vx[a] = Qx[a] + t1 + t2 + t3;
  }
  // K^T (Quu K), associated as the plain version's _mm(KT, _mm(Quu, K))
  T QuuK[NU][NX], T2[NX][NX], Vn[NX][NX];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T t = Quu[a][0] * K[0][c];
#pragma unroll
      for (int l = 1; l < NU; ++l) t = t + Quu[a][l] * K[l][c];
      QuuK[a][c] = t;
    }
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T t = K[0][a] * Qux[0][c];
#pragma unroll
      for (int l = 1; l < NU; ++l) t = t + K[l][a] * Qux[l][c];
      T2[a][c] = t;
    }
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T t1 = K[0][a] * QuuK[0][c];
#pragma unroll
      for (int l = 1; l < NU; ++l) t1 = t1 + K[l][a] * QuuK[l][c];
      Vn[a][c] = Qxx[a][c] + t1 + T2[a][c] + T2[c][a];
    }
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) Vxx[a][c] = T(0.5) * (Vn[a][c] + Vn[c][a]);
  }
}

// One backward Riccati stage, the TPU kernel's _riccati_stage: the
// Q-function expansion, the gains k = -Quu_F^-1 Qu and K = -Quu_F^-1
// Qux_reg from the unrolled Cholesky, and the carry update with the
// unregularized Q terms and a symmetrized Vxx.
template <typename T, int NX, int NU>
__device__ __forceinline__ void riccati_stage(const Stage<T, NX, NU>& cur,
                                              T lam, int reg_type,
                                              Carry<T, NX>& carry, T k[NU],
                                              T K[NU][NX]) {
  T Qu[NU], Qx[NX], Qux[NU][NX], Quu[NU][NU], Qxx[NX][NX];
  T Qux_reg[NU][NX], Quu_F[NU][NU];
  q_expansion<T, NX, NU>(cur, lam, reg_type, carry, Qu, Qx, Qux, Quu, Qxx,
                         Qux_reg, Quu_F);
  // Gains from the Cholesky factor of Quu_F.
  T L[NU][NU];
  carry.ok = cholesky<T, NU>(Quu_F, L) && carry.ok;
  T Qu_col[NU][1], k_col[NU][1];
#pragma unroll
  for (int a = 0; a < NU; ++a) Qu_col[a][0] = Qu[a];
  neg_chol_solve<T, NU, 1>(L, Qu_col, k_col);
  neg_chol_solve<T, NU, NX>(L, Qux_reg, K);
#pragma unroll
  for (int a = 0; a < NU; ++a) k[a] = k_col[a][0];
  value_update<T, NX, NU>(Qu, Qx, Qux, Quu, Qxx, k, K, carry);
}

// One stage's box: the absolute bounds and the current input they are
// taken relative to.
template <typename T, int NU>
struct Bounds {
  T lower[NU];
  T upper[NU];
  T u[NU];
};

// One boxed backward stage, the TPU kernel's _riccati_stage_boxed
// (DDPSolver.hpp:450-497): the Q expansion of riccati_stage; k from the
// BoxQP on (Quu_F, Qu) over [lower - u, upper - u], warm-started from the
// later stage's k (k_next, updated to this stage's k); the K rows
// -free (Quu_F free block)^-1 (free Qux_reg) through the QP's last
// factorization, zero on clamped inputs; the value update with the
// unregularized Q terms.  Run by the G threads of the lane's group
// (boxqp.cuh::LaneGroup) on the same arguments, so each computes the same
// carry; `steps` is the block's fill_step_table schedule.
template <typename T, int NX, int NU, int G>
__device__ __forceinline__ void riccati_stage_boxed(
    const Stage<T, NX, NU>& cur, const Bounds<T, NU>& box, T lam,
    int reg_type, const BoxQPParams& qp, const T* steps,
    Carry<T, NX>& carry, T k_next[NU], T k[NU], T K[NU][NX]) {
  T Qu[NU], Qx[NX], Qux[NU][NX], Quu[NU][NU], Qxx[NX][NX];
  T Qux_reg[NU][NX], Quu_F[NU][NU];
  q_expansion<T, NX, NU>(cur, lam, reg_type, carry, Qu, Qx, Qux, Quu, Qxx,
                         Qux_reg, Quu_F);
  T lo[NU], hi[NU], free[NU], L[NU][NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    lo[a] = box.lower[a] - box.u[a];
    hi[a] = box.upper[a] - box.u[a];
  }
  carry.ok = boxqp<T, NU, G>(Quu_F, Qu, lo, hi, k_next, qp, steps, k, free,
                             L) &&
             carry.ok;
  T rhs[NU][NX], sol[NU][NX];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) rhs[a][c] = free[a] * Qux_reg[a][c];
  }
  neg_chol_solve<T, NU, NX>(L, rhs, sol);
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    k_next[a] = k[a];
#pragma unroll
    for (int c = 0; c < NX; ++c) K[a][c] = free[a] * sol[a][c];
  }
  value_update<T, NX, NU>(Qu, Qx, Qux, Quu, Qxx, k, K, carry);
}

}  // namespace nmpc
