// The DDP Riccati stage at the wide shapes, where a lane's input-sized
// work passes a thread's registers: (NX, NU) past the narrow sizes
// (row_group.cuh::kWideStage, nx > 8 or nu > 4), the centroidal model's
// (9, 16).  K1, K2 and K3 run it there (ddp_backward{,_chunked,_packed}_
// wide.cuh); everywhere else the backward kernels run riccati_stage.cuh::
// riccati_stage_group.
//
// The same stage as riccati_stage_group (the TPU kernel's _riccati_stage,
// nmpc_tpu/kernels/ddp_backward_pallas.py:112, with _chol_t :49 and
// _chol_solve_t :71), split differently.  riccati_stage_group splits only
// the NX-sized rows over a lane's group and every thread repeats the
// NU-sized half (Qu, Fu^T Vxx, Quu, Quu_F, the NU x NU Cholesky, k, Quu K):
// at (9, 16) that is ~10^4 operations a stage whose 16 x 16 and 16 x 9
// arrays pass the 255-register file many times over, so the threads spill
// them to local memory (ptxas: 17,610 / 27,468 bytes of spill stores /
// loads at fp32).  Here:
//   * the lane's G threads split every product by rows: the Q expansion
//     runs NU + NX row tasks (an input row m: Qu, Fu^T Vxx, Fu^T (Vxx +
//     lam I), Quu, Quu_F, Qux and Qux_reg; a state row a: Qx, Fx^T Vxx,
//     Qxx), task q by rank q % G, in one instruction stream (both kinds
//     are a column of Fu or Fx times Vxx, then times Fx's and Fu's
//     columns); rank r owns the Cholesky's rows r, r + G, ... and
//     Vx's; the right-hand sides of the solves (k and the NX columns of
//     K) go by column, Quu K, Vn and the symmetrized Vxx by entry;
//   * a thread holds one row of each NU-sized product in registers (the
//     row of Quu_F it factors, its row of L); everything another thread
//     reads goes to the lane's scratch in the block's dynamic shared
//     memory (WideScratch: the carry Vx, Vxx, then Qu, Qx, Qxx, Qux, Quu,
//     L, the right-hand sides and solutions, Quu k, Quu K, Vn), exchanged
//     at __syncwarp (a lane's group lies within one warp); the stage's
//     fields are read where they landed (the ring's slab), never copied
//     to registers whole;
//   * the Cholesky runs by rows, one __syncwarp a column, and every
//     thread forms every pivot, L[j][j] and its inverse itself (the same
//     operations on the same values), so that no thread waits on another
//     thread's square root; the forward substitution of each right-hand
//     side runs beside it, y[j] as soon as row j of L is known;
//   * each right-hand side is solved whole by one thread, in
//     linalg.cuh::neg_chol_solve's order: the backward sum takes x[k] for
//     k = i + 1 ... NU - 1 ascending while x becomes known from NU - 1
//     down, so a split over rows would reorder it.
// Every value is computed by one thread with the operations and the order
// of each sum of riccati_stage_group at G = 1 (the plain backward_stacked's
// order); only which thread computes it depends on G, so every G gives
// G = 1's bits (the units build with -fmad=false), carry.ok and the NaN
// lanes included: a pivot that is not > 0 and finite fails the lane.
// The card runs it at kRowGroup = 32 threads a lane: one lane a warp,
// ranks 16-24 taking the Q expansion's state rows beside the input rows,
// and every rank entries of the value update (PERF.md, Findings: 16 and
// 8 are slower).
//
// Scalar type T, (NX, NU), G threads a lane (a power of two up to 32),
// the stage's field Layout (a StageLayout; value e of the lane at p[e *
// L], L the block's lanes: a constant, so that every field's address is
// the slab's plus an immediate).

#pragma once

#include "boxqp.cuh"
#include "linalg.cuh"
#include "riccati_stage.cuh"

namespace nmpc {

// A lane's scratch in shared memory, offsets in values.  Row strides XS
// (right-hand sides / solutions, [NU][XS]: column 0 is Qu / k, column 1 +
// a is Qux_reg / K of column a) and US (Quu, [NU][US]) are odd, so that
// the owners of consecutive rows write to distinct banks; L is kept by
// columns (Lt[k * NU + i] = L[i][k]) for the same reason.
template <int NX, int NU>
struct WideScratch {
  static constexpr int XS = (NX + 1) | 1;
  static constexpr int US = NU | 1;
  static constexpr int Vx = 0;                  // the carry: Vx [NX]
  static constexpr int Vxx = Vx + NX;           // Vxx [NX][NX]
  static constexpr int Qu = Vxx + NX * NX;      // [NU]
  static constexpr int Quk = Qu + NU;           // Quu k [NU]
  static constexpr int Qx = Quk + NU;           // [NX]
  static constexpr int Qxx = Qx + NX;           // [NX][NX]
  static constexpr int Qux = Qxx + NX * NX;     // [NU][NX] (unregularized)
  static constexpr int Quu = Qux + NU * NX;     // [NU][US]
  static constexpr int QuuK = Quu + NU * US;    // [NU][NX]
  static constexpr int X = QuuK + NU * NX;      // [NU][XS]
  static constexpr int Lt = X + NU * XS;        // [NU][NU] by columns
  static constexpr int Fd = Lt + NU * NU;       // Quu_F's diagonal [NU]
  static constexpr int Vn = Fd + NU;            // [NX][NX]
  static constexpr int size = Vn + NX * NX;
};

// The Q expansion of a wide stage (q_expansion's sums) on the lane's G
// threads: Qu, Qx, Qxx, Qux and Quu to the lane's scratch `s`, Qu also to
// s[X]'s column 0 and Qux_reg to its columns 1 + a (the right-hand sides
// of the unboxed stage's solves), and each thread's rows of Quu_F to AF
// (row q = j G + r in AF[j]).  Reads the carry (Vx, Vxx) from `s` and the
// stage's fields where they landed (`p`, value e at p[e L]).
template <typename T, int NX, int NU, int G, int L, typename Layout>
__device__ __forceinline__ void wide_q_expansion(
    const T* __restrict__ p, T lam, int reg_type, T* s,
    T (&AF)[(NU + NX + G - 1) / G][NU]) {
  using P = Layout;
  using S = WideScratch<NX, NU>;
  const int r = LaneGroup<G>::rank();
  const T* Vx = s + S::Vx;
  const T* Vxx = s + S::Vxx;
  auto field = [p](int e) { return p[e * L]; };

  // The Q expansion (q_expansion's sums), one row task q of the NU + NX
  // at a time: q < NU an input row m = q (Qu, Fu^T Vxx, Quu, Qux; Quu_F
  // and Qux_reg, reg_type 2 from Fu^T (Vxx + lam I)), else a state row
  // a = q - NU (Qx, Fx^T Vxx, Qxx).  Both are one shape: a column v of Fu
  // or Fx, v . Vx, FV = v^T Vxx, then FV's products with Fx's columns and
  // (an input row's) with Fu's, each plus its field; so a slot of G
  // threads that holds both kinds (G = 32: ranks 0-15 input rows, 16-24
  // state rows) runs one instruction stream, a state row's Fu products
  // discarded.  Quu_F's row stays in registers (AF) for the Cholesky.
  constexpr int JT = (NU + NX + G - 1) / G;   // row tasks a thread
#pragma unroll
  for (int j = 0; j < JT; ++j) {
    const int q = j * G + r;
    // whether task q is an input row: known at compile time unless the
    // slot holds both kinds
    const bool in = (j + 1) * G <= NU ? true : (j * G >= NU ? false : q < NU);
    if (!in && j * G >= NU + NX) continue;
    const bool state = !in && q < NU + NX;
    const int m = in ? q : 0;
    const int a = in ? 0 : min(q - NU, NX - 1);
    const int col = in ? P::Fu + m : P::Fx + a;     // v[l] at col + l step
    const int step = in ? NU : NX;
    T v[NX];
#pragma unroll
    for (int l = 0; l < NX; ++l) v[l] = field(col + l * step);
    {
      T t = v[0] * Vx[0];
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + v[l] * Vx[l];
      const T qv = field(in ? P::Lu + m : P::Lx + a) + t;
      if (in) {
        s[S::Qu + m] = qv;
        s[S::X + m * S::XS] = qv;
      } else if (state) {
        s[S::Qx + a] = qv;
      }
    }
    T FV[NX];
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T t = v[0] * Vxx[c];
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + v[l] * Vxx[l * NX + c];
      FV[c] = t;
    }
    // Qux[m][c] = Lxu[c][m] + ..., or Qxx[a][c] = Lxx[a][c] + ...
    const int lx = in ? P::Lxu + m : P::Lxx + a * NX;
    const int lstep = in ? NU : 1;
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      T t = FV[0] * field(P::Fx + c);
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + FV[l] * field(P::Fx + l * NX + c);
      const T qx = field(lx + c * lstep) + t;
      if (in) {
        s[S::Qux + m * NX + c] = qx;
        s[S::X + m * S::XS + 1 + c] = qx;
      } else if (state) {
        s[S::Qxx + a * NX + c] = qx;
      }
    }
    if (j * G >= NU) continue;   // no input row in the slot
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      T t = FV[0] * field(P::Fu + c);
#pragma unroll
      for (int l = 1; l < NX; ++l) t = t + FV[l] * field(P::Fu + l * NU + c);
      const T quu = field(P::Luu + m * NU + c) + t;
      if (in) s[S::Quu + m * S::US + c] = quu;
      AF[j][c] = quu + ((reg_type == 1 && m == c) ? lam : T(0));
    }
    if (reg_type == 2) {
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        T t = v[0] * (Vxx[c] + (c == 0 ? lam : T(0)));
#pragma unroll
        for (int l = 1; l < NX; ++l)
          t = t + v[l] * (Vxx[l * NX + c] + (c == l ? lam : T(0)));
        FV[c] = t;
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T t = FV[0] * field(P::Fu + c);
#pragma unroll
        for (int l = 1; l < NX; ++l)
          t = t + FV[l] * field(P::Fu + l * NU + c);
        AF[j][c] = field(P::Luu + m * NU + c) + t;
      }
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        T t = FV[0] * field(P::Fx + c);
#pragma unroll
        for (int l = 1; l < NX; ++l)
          t = t + FV[l] * field(P::Fx + l * NX + c);
        if (in) s[S::X + m * S::XS + 1 + c] = field(P::Lxu + c * NU + m) + t;
      }
    }
  }
}

// The Cholesky of an NU x NU matrix by rows on the lane's G threads, with
// the forward substitution of M right-hand sides (rhs[i RS + c]) folded
// in.  This thread holds rows i = j G + r < NU of the matrix in AF[j] (J
// >= ceil(NU / G) slots, the ones past that untouched); they become its
// rows of L below the diagonal, each entry also written by columns to Lt
// (Lt[k NU + i] = L[i][k]).  Fd receives the matrix's diagonal.  Every
// thread forms every pivot and holds L's diagonal in Ld; rank r solves
// right-hand sides r, r + G, ... (ranks past M repeat the last), y
// holding their forward solutions.  Returns whether every pivot was > 0
// and finite (linalg.cuh::cholesky's LLT rule).  On return every entry
// of Lt is visible to every thread of the group.
template <typename T, int NU, int G, int M, int RS, int J>
__device__ __forceinline__ bool wide_cholesky(T (&AF)[J][NU], T* Fd, T* Lt,
                                              const T* rhs,
                                              T (&y)[(M + G - 1) / G][NU],
                                              T (&Ld)[NU]) {
  constexpr int JU = (NU + G - 1) / G;        // input rows a thread owns
  constexpr int JC = (M + G - 1) / G;         // right-hand sides a thread
  static_assert(J >= JU, "AF holds the thread's rows");
  const int r = LaneGroup<G>::rank();
  // The Cholesky of Quu_F (linalg.cuh::cholesky's sums) by rows, with
  // the forward substitution of every right-hand side (k's and K's
  // columns: neg_chol_solve's y) folded in.  AF's row becomes the
  // thread's row of L, each entry also written to Lt.  Every thread forms
  // every pivot d = Quu_F[j][j] - L[j][k]^2 (k ascending) from Fd and row
  // j of L, and L[j][j] and its inverse, the same in each, so no thread
  // waits on another's square root.  For column j, before one barrier
  // each thread sums the pivot, its rows i > j (A[i][j] - L[i][k] L[j][k])
  // and its right-hand sides (B[j] - L[j][k] y[k]) over k < j - 1 (known
  // since the last barrier; Fd[0] and B[0], written by other threads in
  // the Q expansion, after the first); after it each adds the last term
  // and finishes the pivot, L[i][j] and y[j].  Every sum keeps its
  // one-thread order.
#pragma unroll
  for (int jr = 0; jr < JU; ++jr) {
    const int i = jr * G + r;
    if (JU * G == NU || i < NU) {
      T d = AF[jr][0];
#pragma unroll
      for (int c = 1; c < NU; ++c) d = (i == c) ? AF[jr][c] : d;
      Fd[i] = d;
    }
  }
  bool good = true;
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    T d = T(0), t[JU], u[JC];
    if (j > 0) {
      d = Fd[j];
#pragma unroll
      for (int k = 0; k + 1 < j; ++k) d = d - Lt[k * NU + j] * Lt[k * NU + j];
    }
#pragma unroll
    for (int jr = 0; jr < JU; ++jr) {
      const int i = jr * G + r;
      if (jr * G + G - 1 > j && i > j && i < NU) {
        t[jr] = AF[jr][j];
#pragma unroll
        for (int k = 0; k + 1 < j; ++k)
          t[jr] = t[jr] - AF[jr][k] * Lt[k * NU + j];
      }
    }
#pragma unroll
    for (int jc = 0; jc < JC; ++jc) {
      const int c = min(jc * G + r, M - 1);
      if (j > 0) {
        u[jc] = rhs[j * RS + c];
#pragma unroll
        for (int k = 0; k + 1 < j; ++k)
          u[jc] = u[jc] - Lt[k * NU + j] * y[jc][k];
      }
    }
    __syncwarp();
    const T last = j > 0 ? Lt[(j - 1) * NU + j] : T(0);   // L[j][j - 1]
    d = j > 0 ? d - last * last : Fd[0];
    good = good && (d > T(0)) && finite(d);
    Ld[j] = sqrt(d > T(0) ? d : T(1));
    const T inv = T(1) / Ld[j];
#pragma unroll
    for (int jr = 0; jr < JU; ++jr) {
      const int i = jr * G + r;
      if (jr * G + G - 1 > j && i > j && i < NU) {
        if (j > 0) t[jr] = t[jr] - AF[jr][j - 1] * last;
        AF[jr][j] = t[jr] * inv;
        Lt[j * NU + i] = AF[jr][j];
      }
    }
#pragma unroll
    for (int jc = 0; jc < JC; ++jc) {
      const int c = min(jc * G + r, M - 1);
      u[jc] = j > 0 ? u[jc] - last * y[jc][j - 1] : rhs[c];
      y[jc][j] = u[jc] / Ld[j];
    }
  }
  return good;
}

// The value update of a wide stage (value_update's sums) from the lane's
// scratch `s` (Qu, Qx, Qxx, Qux, Quu and the gains in s[X]: k in column
// 0, K[m][a] at s[X + m XS + 1 + a]): the next carry's Vx and Vxx to `s`,
// and dV0, dV1 updated in every thread.  Every thread of the warp calls
// it after a barrier that follows the last write to s[X].
template <typename T, int NX, int NU, int G>
__device__ __forceinline__ void wide_value_update(T* s, T& dV0, T& dV1) {
  using S = WideScratch<NX, NU>;
  constexpr int JU = (NU + G - 1) / G;        // input rows a thread owns
  constexpr int JX = (NX + G - 1) / G;        // state rows a thread owns
  const int r = LaneGroup<G>::rank();
  // The value update (value_update's sums): Quu k by input row, Quu K by
  // entry; then dV in every thread, Vx by state row and Vn by entry; then
  // the symmetrized Vxx by entry.
  const T* X = s + S::X;
#pragma unroll
  for (int j = 0; j < JU; ++j) {
    const int m = j * G + r;
    if (JU * G == NU || m < NU) {
      const T* quu = s + S::Quu + m * S::US;
      T t = quu[0] * X[0];
#pragma unroll
      for (int l = 1; l < NU; ++l) t = t + quu[l] * X[l * S::XS];
      s[S::Quk + m] = t;
    }
  }
  constexpr int EK = (NU * NX + G - 1) / G;   // entries of Quu K a thread
#pragma unroll
  for (int j = 0; j < EK; ++j) {
    const int e = j * G + r;
    if (EK * G == NU * NX || e < NU * NX) {
      const int a = e / NX, c = e % NX;
      const T* quu = s + S::Quu + a * S::US;
      T t = quu[0] * X[1 + c];
#pragma unroll
      for (int l = 1; l < NU; ++l) t = t + quu[l] * X[l * S::XS + 1 + c];
      s[S::QuuK + e] = t;
    }
  }
  __syncwarp();
  {
    const T* Qu = s + S::Qu;
    const T* Quk = s + S::Quk;
    T s0 = X[0] * Qu[0];
    T s1 = X[0] * Quk[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) {
      s0 = s0 + X[a * S::XS] * Qu[a];
      s1 = s1 + X[a * S::XS] * Quk[a];
    }
    dV0 = dV0 + s0;
    dV1 = dV1 + T(0.5) * s1;
  }
#pragma unroll
  for (int j = 0; j < JX; ++j) {
    const int a = j * G + r;
    if (JX * G == NX || a < NX) {
      const T* Ka = X + 1 + a;                 // K[l][a] at Ka[l * XS]
      const T* Quxa = s + S::Qux + a;          // Qux[l][a] at Quxa[l * NX]
      T t1 = Ka[0] * s[S::Quk];
      T t2 = Ka[0] * s[S::Qu];
      T t3 = Quxa[0] * X[0];
#pragma unroll
      for (int l = 1; l < NU; ++l) {
        t1 = t1 + Ka[l * S::XS] * s[S::Quk + l];
        t2 = t2 + Ka[l * S::XS] * s[S::Qu + l];
        t3 = t3 + Quxa[l * NX] * X[l * S::XS];
      }
      s[S::Vx + a] = s[S::Qx + a] + t1 + t2 + t3;
    }
  }
  constexpr int EN = (NX * NX + G - 1) / G;   // entries of Vn a thread
#pragma unroll
  for (int j = 0; j < EN; ++j) {
    const int e = j * G + r;
    if (EN * G == NX * NX || e < NX * NX) {
      const int a = e / NX, c = e % NX;
      const T* Ka = X + 1 + a;
      const T* Kc = X + 1 + c;
      const T* QuuKc = s + S::QuuK + c;      // QuuK[l][c] at [l * NX]
      const T* Quxc = s + S::Qux + c;        // Qux[l][c]
      const T* Quxa = s + S::Qux + a;        // Qux[l][a]
      T t1 = Ka[0] * QuuKc[0];
      T t2 = Ka[0] * Quxc[0];                // T2[a][c]
      T t3 = Kc[0] * Quxa[0];                // T2[c][a]
#pragma unroll
      for (int l = 1; l < NU; ++l) {
        t1 = t1 + Ka[l * S::XS] * QuuKc[l * NX];
        t2 = t2 + Ka[l * S::XS] * Quxc[l * NX];
        t3 = t3 + Kc[l * S::XS] * Quxa[l * NX];
      }
      s[S::Vn + e] = s[S::Qxx + e] + t1 + t2 + t3;
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < EN; ++j) {
    const int e = j * G + r;
    if (EN * G == NX * NX || e < NX * NX) {
      const int a = e / NX, c = e % NX;
      s[S::Vxx + e] = T(0.5) * (s[S::Vn + e] + s[S::Vn + c * NX + a]);
    }
  }
  __syncwarp();
}

// One backward Riccati stage of one lane on its G threads (every thread
// of the warp calls it at the same point).  `s` is the lane's WideScratch,
// holding the carry (Vx, Vxx) on entry and the next one on return; dV0,
// dV1 and ok are each thread's copy of the rest of the carry (equal
// across the group).  On return the stage's k and K sit in s[X] (k in
// column 0, K[m][a] at s[X + m XS + 1 + a]) until the next stage's first
// barrier.
template <typename T, int NX, int NU, int G, int L, typename Layout>
__device__ __forceinline__ void riccati_stage_wide(const T* __restrict__ p,
                                                   T lam, int reg_type, T* s,
                                                   T& dV0, T& dV1,
                                                   bool& ok) {
  using S = WideScratch<NX, NU>;
  constexpr int M = NX + 1;                   // right-hand sides
  constexpr int JC = (M + G - 1) / G;         // right-hand sides a thread
  const int r = LaneGroup<G>::rank();
  T AF[(NU + NX + G - 1) / G][NU];
  wide_q_expansion<T, NX, NU, G, L, Layout>(p, lam, reg_type, s, AF);
  T Ld[NU];      // L's diagonal
  T y[JC][NU];   // each own right-hand side's y, then its x
  T* Lt = s + S::Lt;
  ok = wide_cholesky<T, NU, G, M, S::XS>(AF, s + S::Fd, Lt, s + S::X, y,
                                        Ld) &&
       ok;

  // The backward substitution of each own right-hand side (neg_chol_solve's
  // x, over y), -x over the right-hand side in s[X].
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
      for (int i = 0; i < NU; ++i) s[S::X + i * S::XS + c] = -y[jc][i];
    }
  }
  __syncwarp();
  wide_value_update<T, NX, NU, G>(s, dV0, dV1);
}

}  // namespace nmpc
