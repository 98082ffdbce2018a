// The DDP Riccati stages as device functions, shared by the backward
// kernels: the sweep-fed ones (ddp_backward.cuh, TPU K1; ddp_backward_
// chunked.cuh, K2; ddp_backward_packed.cuh, K3) and the generated remat
// backward (ddp_backward_remat.cuh, TPU K5, unboxed) run
// riccati_stage_group on a group of threads per lane;
// ddp_backward_boxed.cuh (K4) and the boxed remat backward run
// riccati_stage_boxed, as the TPU kernels share nmpc_tpu/kernels/
// ddp_backward_pallas.py::_riccati_stage and _riccati_stage_boxed.  The
// math and the order of each sum follow _riccati_stage.  Templated on the
// scalar type and on (NX, NU).

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

// Values per stage of the packed layout, and the offset of each field:
// Fx, Fu, Lx, Lu, Lxx, Luu, Lxu, each row-major (ddp_backward_pallas.py::
// _field_offsets; F = 46 at (4, 1), 16 at (2, 1)), each offset rounded up
// to a multiple of Q values (F rounded too).  Q = 1 is the packed order
// itself (PackedLayout): K2's chunks, K3's buffer and K5's generated
// fields hold a stage in it.  K1's TMA boxes land a field only at an
// aligned shared-memory address, so its buffers take a Q > 1
// (row_group.cuh::StageRingLayout).
template <int NX, int NU, int Q = 1>
struct StageLayout {
  static constexpr int up(int v) { return (v + Q - 1) / Q * Q; }
  static constexpr int Fx = 0;
  static constexpr int Fu = up(Fx + NX * NX);
  static constexpr int Lx = up(Fu + NX * NU);
  static constexpr int Lu = up(Lx + NX);
  static constexpr int Lxx = up(Lu + NU);
  static constexpr int Luu = up(Lxx + NX * NX);
  static constexpr int Lxu = up(Luu + NU * NU);
  static constexpr int F = up(Lxu + NX * NU);
};
template <int NX, int NU>
using PackedLayout = StageLayout<NX, NU>;

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

// v[a] for a row index a known only at run time (a < N), by selects: an
// array indexed at run time would leave the registers for local memory.
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&v)[N], int a) {
  T out = v[0];
#pragma unroll
  for (int e = 1; e < N; ++e) out = (a == e) ? v[e] : out;
  return out;
}

// One backward Riccati stage, the TPU kernel's _riccati_stage (the
// Q-function expansion, the gains k = -Quu_F^-1 Qu and K = -Quu_F^-1
// Qux_reg from the unrolled Cholesky, the carry update with the
// unregularized Q terms and a symmetrized Vxx), run by the G threads of
// one lane's group (LaneGroup<G>: G a power of two, aligned in the warp),
// each holding the whole carry.  The stage's fields are read from `p`,
// value e of Layout (PackedLayout, or a StageLayout with padded offsets)
// at p[e * stride] (a lane's column of a slab in shared memory: K1's TMA
// stages, K2's cp.async chunks, K3's TMA chunks, K5's generated fields).
// Thread r owns the indices a = r, r + G,
// ... < NX: row a of FxT Vxx, Qxx and Vn = Qxx + K^T Quu K + T2 + T2^T,
// entry a of Qx and Vx, column a of Qux, Qux_reg and K.  Every thread runs
// the NU-sized rest alike: Qu, FuT Vxx, Quu, the regularized Quu_F, the
// Cholesky and k, dV and Quu K, so every branch and carry.ok agree across
// the group.  The group exchanges K and Qux once the gains are known, and
// Vn and Vx at the end, by shuffles over the whole warp; every thread then
// forms the symmetrized Vxx.  Each value is computed by one thread with
// the operations and the order of each sum of q_expansion and
// value_update (the plain backward_stacked's order; a column of K by
// neg_chol_solve on that column alone, as neg_chol_solve solves its
// columns independently); only which thread computes it depends on G, so
// every G gives G = 1's bits (under the same contraction flags; the units
// build with -fmad=false).  An owned index is never part of a
// condition: indices past NX (G > NX, or NX not a multiple of G) repeat
// index NX - 1 and are never exchanged.  Every thread of the warp must
// call it at the same point.  Returns k and K in every thread of the
// group.
template <typename T, int NX, int NU, int G,
          typename Layout = PackedLayout<NX, NU>>
__device__ __forceinline__ void riccati_stage_group(const T* __restrict__ p,
                                                    int stride, T lam,
                                                    int reg_type,
                                                    Carry<T, NX>& carry,
                                                    T k[NU], T K[NU][NX]) {
  using P = Layout;
  constexpr int J = (NX + G - 1) / G;   // indices per thread
  const int r = LaneGroup<G>::rank();
  int own[J];
#pragma unroll
  for (int j = 0; j < J; ++j) own[j] = min(j * G + r, NX - 1);
  T Fx[NX][NX], Fu[NX][NU], Lu[NU], Luu[NU][NU];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) Fx[a][c] = p[(P::Fx + a * NX + c) * stride];
#pragma unroll
    for (int c = 0; c < NU; ++c) Fu[a][c] = p[(P::Fu + a * NU + c) * stride];
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    Lu[a] = p[(P::Lu + a) * stride];
#pragma unroll
    for (int c = 0; c < NU; ++c) Luu[a][c] = p[(P::Luu + a * NU + c) * stride];
  }
  const T(&Vx)[NX] = carry.Vx;
  const T(&Vxx)[NX][NX] = carry.Vxx;

  // The Q expansion (q_expansion's sums): Qu, FuT Vxx, Quu and Quu_F alike
  // in every thread; Qx, Qux and Qux_reg on the own columns, FxT Vxx and
  // Qxx on the own rows.
  T Qu[NU], Quu[NU][NU], Quu_F[NU][NU], FuT_Vxx[NU][NX], FuT_Vr[NU][NX];
  T Qx[J], Qux[J][NU], Qux_reg[J][NU], Qxx[J][NX];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    T s = Fu[0][a] * Vx[0];
#pragma unroll
    for (int l = 1; l < NX; ++l) s = s + Fu[l][a] * Vx[l];
    Qu[a] = Lu[a] + s;
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T t = Fu[0][a] * Vxx[0][c];
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + Fu[l][a] * Vxx[l][c];
      FuT_Vxx[a][c] = t;
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      T t = FuT_Vxx[a][0] * Fu[0][c];
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + FuT_Vxx[a][l] * Fu[l][c];
      Quu[a][c] = Luu[a][c] + t;
    }
  }
  if (reg_type == 2) {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        T t = Fu[0][a] * (Vxx[0][c] + (c == 0 ? lam : T(0)));
#pragma unroll
        for (int l = 1; l < NX; ++l)
          t = t + Fu[l][a] * (Vxx[l][c] + (c == l ? lam : T(0)));
        FuT_Vr[a][c] = t;
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T t = FuT_Vr[a][0] * Fu[0][c];
#pragma unroll
        for (int l = 1; l < NX; ++l) t = t + FuT_Vr[a][l] * Fu[l][c];
        Quu_F[a][c] = Luu[a][c] + t;
      }
    }
  } else {
#pragma unroll
    for (int a = 0; a < NU; ++a) {
#pragma unroll
      for (int c = 0; c < NU; ++c)
        Quu_F[a][c] = Quu[a][c] + ((reg_type == 1 && a == c) ? lam : T(0));
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int a = own[j];
    T Fxa[NX], FxT_Vxx[NX];
#pragma unroll
    for (int l = 0; l < NX; ++l) Fxa[l] = pick(Fx[l], a);
    {
      T s = Fxa[0] * Vx[0];
#pragma unroll
      for (int l = 1; l < NX; ++l) s = s + Fxa[l] * Vx[l];
      Qx[j] = p[(P::Lx + a) * stride] + s;
    }
#pragma unroll
    for (int m = 0; m < NU; ++m) {
      const T Lxu = p[(P::Lxu + a * NU + m) * stride];
      T t = FuT_Vxx[m][0] * Fxa[0];
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + FuT_Vxx[m][l] * Fxa[l];
      Qux[j][m] = Lxu + t;
      if (reg_type == 2) {
        T t2 = FuT_Vr[m][0] * Fxa[0];
#pragma unroll
        for (int l = 1; l < NX; ++l) t2 = t2 + FuT_Vr[m][l] * Fxa[l];
        Qux_reg[j][m] = Lxu + t2;
      } else {
        Qux_reg[j][m] = Qux[j][m];
      }
    }
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T t = Fxa[0] * Vxx[0][c];
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + Fxa[l] * Vxx[l][c];
      FxT_Vxx[c] = t;
    }
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T t = FxT_Vxx[0] * Fx[0][c];
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + FxT_Vxx[l] * Fx[l][c];
      Qxx[j][c] = p[(P::Lxx + a * NX + c) * stride] + t;
    }
  }

  // The gains: k alike in every thread, the own columns
  // of K, then K and Qux exchanged.
  T L[NU][NU];
  carry.ok = cholesky<T, NU>(Quu_F, L) && carry.ok;
  {
    T Qu_col[NU][1], k_col[NU][1];
#pragma unroll
    for (int a = 0; a < NU; ++a) Qu_col[a][0] = Qu[a];
    neg_chol_solve<T, NU, 1>(L, Qu_col, k_col);
#pragma unroll
    for (int a = 0; a < NU; ++a) k[a] = k_col[a][0];
  }
  T Kown[J][NU];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    T rhs[NU][1], col[NU][1];
#pragma unroll
    for (int m = 0; m < NU; ++m) rhs[m][0] = Qux_reg[j][m];
    neg_chol_solve<T, NU, 1>(L, rhs, col);
#pragma unroll
    for (int m = 0; m < NU; ++m) Kown[j][m] = col[m][0];
  }
  T Quxf[NU][NX];
#pragma unroll
  for (int c = 0; c < NX; ++c) {
#pragma unroll
    for (int m = 0; m < NU; ++m) {
      if constexpr (G == 1) {
        K[m][c] = Kown[c][m];
        Quxf[m][c] = Qux[c][m];
      } else {
        K[m][c] = LaneGroup<G>::bcast(Kown[c / G][m], c % G);
        Quxf[m][c] = LaneGroup<G>::bcast(Qux[c / G][m], c % G);
      }
    }
  }

  // The value update (value_update's sums): dV and Quu K alike in every
  // thread, Vx and Vn on the own indices, then Vx and Vn exchanged and
  // Vxx formed.
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
  T QuuK[NU][NX];
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
  T Vx_own[J], Vn_own[J][NX];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const T(&Ka)[NU] = Kown[j];
    const T(&Quxa)[NU] = Qux[j];
    {
      T t1 = Ka[0] * Quu_k[0];
      T t2 = Ka[0] * Qu[0];
      T t3 = Quxa[0] * k[0];
#pragma unroll
      for (int l = 1; l < NU; ++l) {
        t1 = t1 + Ka[l] * Quu_k[l];
        t2 = t2 + Ka[l] * Qu[l];
        t3 = t3 + Quxa[l] * k[l];
      }
      Vx_own[j] = Qx[j] + t1 + t2 + t3;
    }
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T t1 = Ka[0] * QuuK[0][c];
      T t2 = Ka[0] * Quxf[0][c];     // T2[a][c]
      T t3 = K[0][c] * Quxa[0];      // T2[c][a]
#pragma unroll
      for (int l = 1; l < NU; ++l) {
        t1 = t1 + Ka[l] * QuuK[l][c];
        t2 = t2 + Ka[l] * Quxf[l][c];
        t3 = t3 + K[l][c] * Quxa[l];
      }
      Vn_own[j][c] = Qxx[j][c] + t1 + t2 + t3;
    }
  }
  T Vn[NX][NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    if constexpr (G == 1) {
      carry.Vx[a] = Vx_own[a];
    } else {
      carry.Vx[a] = LaneGroup<G>::bcast(Vx_own[a / G], a % G);
    }
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      if constexpr (G == 1) {
        Vn[a][c] = Vn_own[a][c];
      } else {
        Vn[a][c] = LaneGroup<G>::bcast(Vn_own[a / G][c], a % G);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c)
      carry.Vxx[a][c] = T(0.5) * (Vn[a][c] + Vn[c][a]);
  }
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
// (DDPSolver.hpp:450-497): the Q expansion (q_expansion); k from the
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
