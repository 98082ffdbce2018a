// Unrolled small-matrix linear algebra on one thread's registers: the
// device counterpart of nmpc_tpu_torch/kernels/linalg.py (TPU:
// nmpc_tpu/kernels/ddp_backward_pallas.py::_chol_t, _chol_solve_t), shared
// by the Riccati stages (riccati_stage.cuh) and the BoxQP (boxqp.cuh).

#pragma once

namespace nmpc {

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

// Inverse by Gauss-Jordan elimination with partial pivoting, the LU
// fallback of the FMPC backward (fmpc_stage.cuh).  Same rules and order as
// kernels/linalg.py::_inv_bl and the TPU's _inv_t
// (nmpc_tpu/kernels/fmpc_backward_pallas.py:48-77): a row swaps when its
// entry in the pivot column is strictly larger in magnitude; a zero pivot
// becomes 1e-30.
template <typename T, int N>
__device__ __forceinline__ void gauss_jordan_inverse(const T A[N][N],
                                                     T inv[N][N]) {
  T a[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a[i][j] = A[i][j];
      inv[i][j] = i == j ? T(1) : T(0);
    }
  }
#pragma unroll
  for (int col = 0; col < N; ++col) {
#pragma unroll
    for (int r = col + 1; r < N; ++r) {
      if (fabs(a[r][col]) > fabs(a[col][col])) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const T ta = a[col][j];
          a[col][j] = a[r][j];
          a[r][j] = ta;
          const T ti = inv[col][j];
          inv[col][j] = inv[r][j];
          inv[r][j] = ti;
        }
      }
    }
    const T piv = a[col][col];
    const T ipiv = T(1) / (piv == T(0) ? T(1e-30) : piv);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a[col][j] = a[col][j] * ipiv;
      inv[col][j] = inv[col][j] * ipiv;
    }
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (r == col) continue;
      const T f = a[r][col];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        a[r][j] = a[r][j] - f * a[col][j];
        inv[r][j] = inv[r][j] - f * inv[col][j];
      }
    }
  }
}

}  // namespace nmpc
