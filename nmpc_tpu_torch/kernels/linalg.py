"""Batched small-matrix linear algebra, unrolled over the small dimension.

Port of ``nmpc_tpu/kernels/linalg.py``.  The solvers factorize tiny
(nu x nu) SPD matrices for many problems at once; these routines unroll the
factorization and the substitutions over the static small dimension, so
every operation is an elementwise torch op batched over all leading axes.

Semantics match the reference's Eigen usage:
  * ``cholesky_small`` fails (ok=False) iff a pivot is <= 0 or non-finite,
    Eigen LLT's NumericalIssue (``DDPSolver.hpp:500-508``);
  * ``lu_solve_small`` is Gaussian elimination with partial pivoting, the
    FullPivLU fallback role (``FmpcSolver.hpp:614-617``);
  * ``_inv_bl`` is the batch-minor Gauss-Jordan inverse the batched FMPC
    backward takes in that role (``nmpc_tpu/solvers/parallel_riccati.py::
    _inv_bl``), the plain form of ``csrc/linalg.cuh::gauss_jordan_inverse``.
"""

from __future__ import annotations

import torch


def cholesky_small(A):
    """Lower Cholesky of SPD ``A[..., n, n]`` with static small n.

    Returns (L, ok), ok the all-pivots-positive flag over the leading axes.
    Failed lanes get safe factors (a non-positive pivot is replaced by 1)
    so that no NaN reaches neighbouring computations."""
    n = A.shape[-1]
    ok = torch.ones(A.shape[:-2], dtype=torch.bool, device=A.device)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[..., j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        ok = ok & (d > 0) & torch.isfinite(d)
        Ljj = torch.sqrt(torch.where(d > 0, d, torch.ones_like(d)))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    zero = torch.zeros_like(A[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)],
                        dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2), ok


def cho_solve_small(L, B):
    """Solve (L L^T) X = B with ``L`` from :func:`cholesky_small`;
    ``B[..., n]`` or ``B[..., n, m]``."""
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B[..., None]
    n = L.shape[-1]
    y = [None] * n
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * y[k]
        y[i] = s / L[..., i, i, None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i, None] * x[k]
        x[i] = s / L[..., i, i, None]
    X = torch.stack(x, dim=-2)
    return X[..., 0] if vec else X


def solve_psd_small(A, B):
    """(X, ok): solve SPD ``A X = B`` through :func:`cholesky_small`."""
    L, ok = cholesky_small(A)
    return cho_solve_small(L, B), ok


def lu_solve_small(A, B):
    """Solve general ``A X = B`` by unrolled Gaussian elimination with
    partial pivoting; ``B[..., n]`` or ``B[..., n, m]``."""
    vec = B.ndim == A.ndim - 1
    if vec:
        B = B[..., None]
    n = A.shape[-1]
    arows = [A[..., i, :] for i in range(n)]
    brows = [B[..., i, :] for i in range(n)]
    for col in range(n):
        for r in range(col + 1, n):
            sw = (torch.abs(arows[r][..., col])
                  > torch.abs(arows[col][..., col]))[..., None]
            arows[col], arows[r] = (torch.where(sw, arows[r], arows[col]),
                                    torch.where(sw, arows[col], arows[r]))
            brows[col], brows[r] = (torch.where(sw, brows[r], brows[col]),
                                    torch.where(sw, brows[col], brows[r]))
        piv = arows[col][..., col]
        piv = torch.where(piv == 0, torch.full_like(piv, 1e-30), piv)
        inv = (1.0 / piv)[..., None]
        for r in range(col + 1, n):
            f = arows[r][..., col, None] * inv
            arows[r] = arows[r] - f * arows[col]
            brows[r] = brows[r] - f * brows[col]
    x = [None] * n
    for i in reversed(range(n)):
        s = brows[i]
        for k in range(i + 1, n):
            s = s - arows[i][..., k, None] * x[k]
        x[i] = s / arows[i][..., i, None]
    X = torch.stack(x, dim=-2)
    return X[..., 0] if vec else X


def _inv_bl(A):
    """Inverse of ``A[n, n, E]`` (batch-minor) by unrolled Gauss-Jordan
    elimination with partial pivoting: a row swaps when its entry in the
    pivot column is strictly larger in magnitude, and a zero pivot is
    replaced by 1e-30.  Every op is elementwise over the trailing axis."""
    n = A.shape[0]
    a = [[A[i, j] for j in range(n)] for i in range(n)]
    zeros, ones = torch.zeros_like(A[0, 0]), torch.ones_like(A[0, 0])
    inv = [[ones if i == j else zeros for j in range(n)] for i in range(n)]
    for col in range(n):
        for r in range(col + 1, n):
            swap = torch.abs(a[r][col]) > torch.abs(a[col][col])
            for j in range(n):
                a[col][j], a[r][j] = (torch.where(swap, a[r][j], a[col][j]),
                                      torch.where(swap, a[col][j], a[r][j]))
                inv[col][j], inv[r][j] = (
                    torch.where(swap, inv[r][j], inv[col][j]),
                    torch.where(swap, inv[col][j], inv[r][j]))
        piv = a[col][col]
        ipiv = 1.0 / torch.where(piv == 0, torch.full_like(piv, 1e-30), piv)
        for j in range(n):
            a[col][j] = a[col][j] * ipiv
            inv[col][j] = inv[col][j] * ipiv
        for r in range(n):
            if r == col:
                continue
            f = a[r][col]
            for j in range(n):
                a[r][j] = a[r][j] - f * a[col][j]
                inv[r][j] = inv[r][j] - f * inv[col][j]
    return torch.stack([torch.stack(row, dim=0) for row in inv], dim=0)
