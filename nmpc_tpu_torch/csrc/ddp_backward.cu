// Fused DDP Riccati backward pass for Hopper (sm_90a).
//
// Replaces the TPU kernel nmpc_tpu/kernels/ddp_backward_pallas.py::
// backward_pallas (stage-DMA mode: _backward_pallas_call, kernel
// _make_kernel, stage body _riccati_stage with _chol_t/_chol_solve_t).
// Its plain twin is nmpc_tpu_torch/kernels/ddp_backward.py::
// backward_stacked; the math and the order of each sum follow
// _riccati_stage.
//
// What bounds it on the card: device memory.  Per stage and lane it reads
// the seven derivative fields (46 values at nx=4, nu=1) and writes k and
// K (5 values), against roughly 10 flops per value read: far below the
// H100's flop/byte ridge.  One thread per lane at B=4096 is only 4096
// threads, too few loads in flight to reach full bandwidth, so the kernel
// runs latency-limited below the roofline.
//
// What the design does about it:
//   * one thread per lane, the (Vx, Vxx, dV, ok) carry in registers, and
//     the N-stage recursion as a loop inside the thread (the TPU kernel's
//     sequential fori_loop); nothing but k and K goes back to memory;
//   * the batch-minor [N, dims..., B] layout makes every field load
//     coalesced across a warp;
//   * stage i-1's fields are loaded into registers before stage i is
//     computed (the TPU kernel's double-buffered stage DMA), so the loads
//     of the next stage are in flight during this stage's arithmetic;
//   * 32-thread blocks spread the few lanes over as many SMs as possible.
// No shared memory is used.  Templated on the scalar type (float, double)
// and on (NX, NU); the instantiated pairs are listed in
// ddp_backward_launch below.  The stage body (riccati_stage, cholesky,
// neg_chol_solve) is written as device functions so that the later remat
// and FMPC kernels can share it, as their TPU kernels share
// _riccati_stage / _chol_t / _chol_solve_t.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 32;

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

template <typename T, int NX, int NU>
struct Fields {
  const T* __restrict__ Fx;
  const T* __restrict__ Fu;
  const T* __restrict__ Lx;
  const T* __restrict__ Lu;
  const T* __restrict__ Lxx;
  const T* __restrict__ Luu;
  const T* __restrict__ Lxu;
};

// Element (i, a, c, b) of a batch-minor [N, n, m, B] field.
__device__ __forceinline__ size_t at3(int i, int a, int c, int n, int m,
                                      int b, int B) {
  return ((static_cast<size_t>(i) * n + a) * m + c) * B + b;
}

__device__ __forceinline__ size_t at2(int i, int a, int n, int b, int B) {
  return (static_cast<size_t>(i) * n + a) * B + b;
}

template <typename T, int NX, int NU>
__device__ __forceinline__ void load_stage(Stage<T, NX, NU>& s,
                                           const Fields<T, NX, NU>& f,
                                           int i, int b, int B) {
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      s.Fx[a][c] = f.Fx[at3(i, a, c, NX, NX, b, B)];
      s.Lxx[a][c] = f.Lxx[at3(i, a, c, NX, NX, b, B)];
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      s.Fu[a][c] = f.Fu[at3(i, a, c, NX, NU, b, B)];
      s.Lxu[a][c] = f.Lxu[at3(i, a, c, NX, NU, b, B)];
    }
    s.Lx[a] = f.Lx[at2(i, a, NX, b, B)];
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    s.Lu[a] = f.Lu[at2(i, a, NU, b, B)];
#pragma unroll
    for (int c = 0; c < NU; ++c) s.Luu[a][c] = f.Luu[at3(i, a, c, NU, NU, b, B)];
  }
}

template <typename T>
__device__ __forceinline__ bool finite(T v) {
  return isfinite(v);
}

// Unrolled Cholesky with Eigen's LLT failure rule: a pivot that is not
// > 0 and finite fails the lane; sqrt(d > 0 ? d : 1) keeps the rest of
// the lane's arithmetic defined (the lane's result is discarded).
template <typename T, int N>
__device__ __forceinline__ bool cholesky(const T A[N][N], T L[N][N]) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T d = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - L[j][k] * L[j][k];
    ok = ok && (d > T(0)) && finite(d);
    const T ljj = sqrt(d > T(0) ? d : T(1));
    L[j][j] = ljj;
    const T inv = T(1) / ljj;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      T s = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = s * inv;
    }
  }
  return ok;
}

// X = -(L L^T)^{-1} Bm for an [N][M] right-hand side.
template <typename T, int N, int M>
__device__ __forceinline__ void neg_chol_solve(const T L[N][N],
                                               const T Bm[N][M], T X[N][M]) {
  T y[N][M];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = 0; c < M; ++c) {
      T s = Bm[i][c];
#pragma unroll
      for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k][c];
      y[i][c] = s / L[i][i];
    }
  }
  T x[N][M];
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
#pragma unroll
    for (int c = 0; c < M; ++c) {
      T s = y[i][c];
#pragma unroll
      for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k][c];
      x[i][c] = s / L[i][i];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = 0; c < M; ++c) X[i][c] = -x[i][c];
  }
}

// The (Vx, Vxx, dV, ok) value-function carry of one lane.
template <typename T, int NX>
struct Carry {
  T Vx[NX];
  T Vxx[NX][NX];
  T dV0, dV1;
  bool ok;
};

// One backward Riccati stage, the TPU kernel's _riccati_stage: the
// Q-function expansion, regularization (reg_type 1: Quu + lam I;
// reg_type 2: Vxx + lam I in Qux_reg / Quu_F), the gains k = -Quu_F^-1 Qu
// and K = -Quu_F^-1 Qux_reg from the unrolled Cholesky, and the carry
// update with the unregularized Q terms and a symmetrized Vxx.
template <typename T, int NX, int NU>
__device__ __forceinline__ void riccati_stage(const Stage<T, NX, NU>& cur,
                                              T lam, int reg_type,
                                              Carry<T, NX>& carry, T k[NU],
                                              T K[NU][NX]) {
  T(&Vx)[NX] = carry.Vx;
  T(&Vxx)[NX][NX] = carry.Vxx;
  // Q-function expansion.
  T Qu[NU], Qx[NX], Qux[NU][NX], Quu[NU][NU], Qxx[NX][NX];
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
  T Qux_reg[NU][NX], Quu_F[NU][NU];
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

  // Gains from the Cholesky factor of Quu_F.
  T L[NU][NU];
  carry.ok = cholesky<T, NU>(Quu_F, L) && carry.ok;
  T Qu_col[NU][1], k_col[NU][1];
#pragma unroll
  for (int a = 0; a < NU; ++a) Qu_col[a][0] = Qu[a];
  neg_chol_solve<T, NU, 1>(L, Qu_col, k_col);
  neg_chol_solve<T, NU, NX>(L, Qux_reg, K);

  // Value-function update with the unregularized Q terms.
  T Quu_k[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    T s = Quu[a][0] * k_col[0][0];
#pragma unroll
    for (int l = 1; l < NU; ++l) s = s + Quu[a][l] * k_col[l][0];
    Quu_k[a] = s;
  }
  {
    T s0 = k_col[0][0] * Qu[0];
    T s1 = k_col[0][0] * Quu_k[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) {
      s0 = s0 + k_col[a][0] * Qu[a];
      s1 = s1 + k_col[a][0] * Quu_k[a];
    }
    carry.dV0 = carry.dV0 + s0;
    carry.dV1 = carry.dV1 + T(0.5) * s1;
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    T t1 = K[0][a] * Quu_k[0];
    T t2 = K[0][a] * Qu[0];
    T t3 = Qux[0][a] * k_col[0][0];
#pragma unroll
    for (int l = 1; l < NU; ++l) {
      t1 = t1 + K[l][a] * Quu_k[l];
      t2 = t2 + K[l][a] * Qu[l];
      t3 = t3 + Qux[l][a] * k_col[l][0];
    }
    Vx[a] = Qx[a] + t1 + t2 + t3;
  }
  T KTQuu[NX][NU], T2[NX][NX], Vn[NX][NX];
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      T t = K[0][a] * Quu[0][c];
#pragma unroll
      for (int l = 1; l < NU; ++l) t = t + K[l][a] * Quu[l][c];
      KTQuu[a][c] = t;
    }
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
      T t1 = KTQuu[a][0] * K[0][c];
#pragma unroll
      for (int l = 1; l < NU; ++l) t1 = t1 + KTQuu[a][l] * K[l][c];
      Vn[a][c] = Qxx[a][c] + t1 + T2[a][c] + T2[c][a];
    }
  }
#pragma unroll
  for (int a = 0; a < NX; ++a) {
#pragma unroll
    for (int c = 0; c < NX; ++c) Vxx[a][c] = T(0.5) * (Vn[a][c] + Vn[c][a]);
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) k[a] = k_col[a][0];
}

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kThreads)
ddp_backward_kernel(Fields<T, NX, NU> f, const T* __restrict__ VxT,
                    const T* __restrict__ VxxT, const T* __restrict__ lam_in,
                    T* __restrict__ ks, T* __restrict__ Ks,
                    T* __restrict__ dV, unsigned char* __restrict__ ok_out,
                    int N, int B, int reg_type) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  Carry<T, NX> carry;
#pragma unroll
  for (int a = 0; a < NX; ++a) {
    carry.Vx[a] = VxT[static_cast<size_t>(a) * B + b];
#pragma unroll
    for (int e = 0; e < NX; ++e)
      carry.Vxx[a][e] = VxxT[(static_cast<size_t>(a) * NX + e) * B + b];
  }
  carry.dV0 = T(0);
  carry.dV1 = T(0);
  carry.ok = true;
  const T lam = lam_in[b];

  Stage<T, NX, NU> cur, nxt;
  load_stage(cur, f, N - 1, b, B);
  for (int i = N - 1; i >= 0; --i) {
    if (i > 0) load_stage(nxt, f, i - 1, b, B);
    T k[NU], K[NU][NX];
    riccati_stage<T, NX, NU>(cur, lam, reg_type, carry, k, K);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      ks[at2(i, a, NU, b, B)] = k[a];
#pragma unroll
      for (int e = 0; e < NX; ++e) Ks[at3(i, a, e, NU, NX, b, B)] = K[a][e];
    }
    cur = nxt;
  }
  dV[b] = carry.dV0;
  dV[static_cast<size_t>(B) + b] = carry.dV1;
  ok_out[b] = carry.ok ? 1 : 0;
}

template <typename T, int NX, int NU>
int launch(int N, int B, int reg_type, const void* Fx, const void* Fu,
           const void* Lx, const void* Lu, const void* Lxx, const void* Luu,
           const void* Lxu, const void* VxT, const void* VxxT,
           const void* lam, void* ks, void* Ks, void* dV, void* ok,
           cudaStream_t stream) {
  Fields<T, NX, NU> f{
      static_cast<const T*>(Fx),  static_cast<const T*>(Fu),
      static_cast<const T*>(Lx),  static_cast<const T*>(Lu),
      static_cast<const T*>(Lxx), static_cast<const T*>(Luu),
      static_cast<const T*>(Lxu)};
  const int blocks = (B + kThreads - 1) / kThreads;
  ddp_backward_kernel<T, NX, NU><<<blocks, kThreads, 0, stream>>>(
      f, static_cast<const T*>(VxT), static_cast<const T*>(VxxT),
      static_cast<const T*>(lam), static_cast<T*>(ks), static_cast<T*>(Ks),
      static_cast<T*>(dV), static_cast<unsigned char*>(ok), N, B, reg_type);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the backward pass on `stream`; returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a (dtype, nx, nu) that is not
// instantiated here.  dtype_code: 0 float, 1 double.  All arrays are
// contiguous batch-minor device arrays; ok is one byte per lane.
extern "C" int ddp_backward_launch(int dtype_code, int nx, int nu,
                                   int reg_type, int N, int B,
                                   const void* Fx, const void* Fu,
                                   const void* Lx, const void* Lu,
                                   const void* Lxx, const void* Luu,
                                   const void* Lxu, const void* VxT,
                                   const void* VxxT, const void* lam,
                                   void* ks, void* Ks, void* dV, void* ok,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nx == 4 && nu == 1) {
    if (dtype_code == 0)
      return launch<float, 4, 1>(N, B, reg_type, Fx, Fu, Lx, Lu, Lxx, Luu,
                                 Lxu, VxT, VxxT, lam, ks, Ks, dV, ok, s);
    if (dtype_code == 1)
      return launch<double, 4, 1>(N, B, reg_type, Fx, Fu, Lx, Lu, Lxx, Luu,
                                  Lxu, VxT, VxxT, lam, ks, Ks, dV, ok, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
