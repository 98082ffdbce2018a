"""Batch-minor ("stacked") DDP backward pass in torch ops.

Port of ``nmpc_tpu/kernels/ddp_backward.py::backward_stacked``: every
stage quantity is stored ``[..., small_dims..., B]`` and the small-matrix
contractions are written out as broadcast-multiply-reduce over the batch.
It is the plain twin of the fused CUDA kernel
(``kernels/ddp_backward_fused.py``): the CPU path, and the reference the
kernel is held against on the card.  Math follows the reference
``DDPSolver.hpp:343-534``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nmpc_tpu_torch.core.types import DDPConfig


class StackedDerivs(NamedTuple):
    """Stage derivatives, batch-minor: leading axis N, trailing axis B."""

    Fx: torch.Tensor   # [N, nx, nx, B]
    Fu: torch.Tensor   # [N, nx, nu, B]
    Lx: torch.Tensor   # [N, nx, B]
    Lu: torch.Tensor   # [N, nu, B]
    Lxx: torch.Tensor  # [N, nx, nx, B]
    Luu: torch.Tensor  # [N, nu, nu, B]
    Lxu: torch.Tensor  # [N, nx, nu, B]


class StackedSecond(NamedTuple):
    """Second-order dynamics tensors for full DDP, batch-minor (the
    reference declares these terms but leaves them unimplemented,
    ``DDPSolver.hpp:391-414``)."""

    Fxx: torch.Tensor  # [N, nx, nx, nx, B]
    Fuu: torch.Tensor  # [N, nx, nu, nu, B]
    Fxu: torch.Tensor  # [N, nx, nx, nu, B]


def _vx_dot_f2(Vx, F2):
    """Vx [nx, B] . F2 [nx, a, b, B] -> [a, b, B]."""
    return torch.sum(Vx[:, None, None, :] * F2, dim=0)


def _mm(A, B):
    """[i, k, B] @ [k, j, B] -> [i, j, B]."""
    return torch.sum(A[:, :, None, :] * B[None, :, :, :], dim=1)


def _mT(A):
    return A.transpose(0, 1)


def _mv(A, v):
    """[i, k, B] @ [k, B] -> [i, B]."""
    return torch.sum(A * v[None, :, :], dim=1)


def _chol_bl(A):
    """Unrolled Cholesky of [n, n, B] with Eigen's LLT failure rule (a
    pivot that is not > 0 and finite fails the lane); returns (L as nested
    lists of [B] rows, ok [B])."""
    n = A.shape[0]
    ok = torch.ones(A.shape[-1], dtype=torch.bool, device=A.device)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        ok = ok & (d > 0) & torch.isfinite(d)
        Ljj = torch.sqrt(torch.where(d > 0, d, torch.ones_like(d)))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    return L, ok


def _chol_solve_bl(L, B):
    """Solve (L L^T) X = B for a [n, m, B] right-hand side."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = B[i]
        for k in range(i):
            s = s - L[i][k][None, :] * y[k]
        y[i] = s / L[i][i][None, :]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][None, :] * x[k]
        x[i] = s / L[i][i][None, :]
    return torch.stack(x, dim=0)


def backward_stacked(config: DDPConfig, D: StackedDerivs, Vx_T, Vxx_T, lam,
                     D2: Optional[StackedSecond] = None):
    """Backward pass, batch-minor.

    Args: Vx_T [nx, B], Vxx_T [nx, nx, B], lam [B] (per-lane
    regularization); D2 adds the full-DDP second-order terms.
    Returns (ks [N, nu, B], Ks [N, nu, nx, B], dV [2, B], ok [B] bool).
    """
    N, nx = D.Fx.shape[0], D.Fx.shape[1]
    nu = D.Fu.shape[2]
    B = Vx_T.shape[-1]
    dtype, device = Vx_T.dtype, Vx_T.device
    eye_nx = torch.eye(nx, dtype=dtype, device=device)[:, :, None]
    eye_nu = torch.eye(nu, dtype=dtype, device=device)[:, :, None]
    lam_b = lam[None, None, :]

    Vx, Vxx = Vx_T, Vxx_T
    dV = torch.zeros((2, B), dtype=dtype, device=device)
    ok = torch.ones((B,), dtype=torch.bool, device=device)
    ks = torch.empty((N, nu, B), dtype=dtype, device=device)
    Ks = torch.empty((N, nu, nx, B), dtype=dtype, device=device)
    for i in reversed(range(N)):
        Fx, Fu, Lx, Lu, Lxx, Luu, Lxu = (a[i] for a in D)
        FuT = _mT(Fu)
        FxT = _mT(Fx)
        Qu = Lu + _mv(FuT, Vx)
        Qx = Lx + _mv(FxT, Vx)
        FuT_Vxx = _mm(FuT, Vxx)
        Qux = _mT(Lxu) + _mm(FuT_Vxx, Fx)
        Quu = Luu + _mm(FuT_Vxx, Fu)
        Qxx = Lxx + _mm(_mm(FxT, Vxx), Fx)
        if D2 is not None:
            VxFxu = _vx_dot_f2(Vx, D2.Fxu[i])   # [nx, nu, B]
            VxFuu = _vx_dot_f2(Vx, D2.Fuu[i])   # [nu, nu, B]
            Qux = Qux + _mT(VxFxu)
            Quu = Quu + VxFuu
            Qxx = Qxx + _vx_dot_f2(Vx, D2.Fxx[i])

        if config.reg_type == 2:
            FuT_Vr = _mm(FuT, Vxx + lam_b * eye_nx)
            Qux_reg = _mT(Lxu) + _mm(FuT_Vr, Fx)
            Quu_F = Luu + _mm(FuT_Vr, Fu)
            if D2 is not None:
                Qux_reg = Qux_reg + _mT(VxFxu)
                Quu_F = Quu_F + VxFuu
        else:
            Qux_reg = Qux
            Quu_F = Quu
        if config.reg_type == 1:
            Quu_F = Quu_F + lam_b * eye_nu

        L, ok_i = _chol_bl(Quu_F)
        k = -_chol_solve_bl(L, Qu[:, None, :])[:, 0, :]        # [nu, B]
        K = -_chol_solve_bl(L, Qux_reg)                        # [nu, nx, B]

        Quu_k = _mv(Quu, k)
        KT = _mT(K)
        dV = dV + torch.stack([torch.sum(k * Qu, dim=0),
                               0.5 * torch.sum(k * Quu_k, dim=0)])
        Vx = Qx + _mv(KT, Quu_k) + _mv(KT, Qu) + _mv(_mT(Qux), k)
        Vxx = (Qxx + _mm(KT, _mm(Quu, K)) + _mm(KT, Qux)
               + _mm(_mT(Qux), K))
        Vxx = 0.5 * (Vxx + _mT(Vxx))
        ok = ok & ok_i
        ks[i] = k
        Ks[i] = K
    return ks, Ks, dV, ok


def stack_derivs(Fx, Fu, Lx, Lu, Lxx, Luu, Lxu) -> StackedDerivs:
    """[B, N, ...] (vmap layout) -> [N, ..., B] (batch-minor layout)."""
    mv = lambda a: torch.movedim(a, 0, -1)
    return StackedDerivs(Fx=mv(Fx), Fu=mv(Fu), Lx=mv(Lx), Lu=mv(Lu),
                         Lxx=mv(Lxx), Luu=mv(Luu), Lxu=mv(Lxu))
