"""Matrix-free GMRES with Givens-rotation triangularization, in torch ops.

Port of ``nmpc_tpu/solvers/gmres.py`` (reference ``nmpc_cgmres::Gmres``,
``Gmres.h:42-192``; Kelley 1995, Alg. 3.5.1): Arnoldi with modified
Gram-Schmidt, conditional reorthogonalization (``Gmres.h:117-130``),
Givens triangularization of each Hessenberg column (``Gmres.h:136-168``)
or a least-squares solve of the growing Hessenberg (Alg. 3.4.2,
``Gmres.h:170-176``), the residual tracked as |g[k]|, and the early exit at
rho <= eps ||b||.

The workspace keeps the JAX package's fixed shapes ([k_max+1, n] basis,
[k_max+1, k_max] Hessenberg, unused entries zero), so every intermediate
equals the reference's.  The JAX ``while_loop`` becomes a Python loop
whose early-exit test reads one device value a trip through ``host``
(``bool`` unless the caller counts the reads).  The batched solver of the
C/GMRES fleet path is ``solvers/cgmres.py::gmres_bm``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class GmresResult(NamedTuple):
    x: torch.Tensor            # [n] solution
    iters: torch.Tensor        # Arnoldi iterations performed (int32)
    residual: torch.Tensor     # final residual estimate rho
    err_history: torch.Tensor  # [k_max+1] residuals, NaN past the last


def gmres(
    Amul: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    k_max: int,
    eps: float = 1e-10,
    reorth: bool = True,
    make_triangular: bool = True,
    host: Callable = bool,
) -> GmresResult:
    """Solve A x = b given the matrix-free product ``Amul(v) = A @ v``
    (``Gmres::solve``, ``Gmres.h:67-192``), with the reference's
    reorthogonalization trigger ``Avk_norm + 1e-3 * h == Avk_norm``.

    ``make_triangular=True`` is Kelley Alg. 3.5.1 (incremental Givens
    triangularization and a back-substitution over the first k rows);
    ``False`` is Alg. 3.4.2, a QR least-squares solve of the Hessenberg
    each iteration with the true residual, keeping the last pass's y."""
    n = b.shape[0]
    dtype, device = b.dtype, b.device
    k_max = min(k_max, n)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)

    r = b - Amul(x0)
    rho = torch.linalg.norm(r)
    b_norm = torch.linalg.norm(b)

    V = zeros(k_max + 1, n)
    V[0] = torch.where(rho > 0, r / rho, r)
    H = zeros(k_max + 1, k_max)
    g = zeros(k_max + 1)
    g[0] = rho
    cs, sn = zeros(k_max), zeros(k_max)
    errs = torch.full((k_max + 1,), float("nan"), dtype=dtype, device=device)
    errs[0] = rho
    y = zeros(k_max)
    # the unit subdiagonal that pads the inactive Hessenberg columns of the
    # least-squares mode (the padded QR stays nonsingular and equal to the
    # truncated system)
    sub = zeros(k_max + 1, k_max)
    sub[1:] = torch.eye(k_max, dtype=dtype, device=device)
    rows = torch.arange(k_max + 1, device=device)
    cols = torch.arange(k_max, device=device)

    k = 0
    while k < k_max and host(rho > eps * b_norm):
        w = Amul(V[k])
        Avk_norm = torch.linalg.norm(w)
        # modified Gram-Schmidt against basis vectors 0..k (Gmres.h:100-110)
        hcol = zeros(k_max + 1)
        for j in range(k + 1):
            h = w @ V[j]
            w = w - h * V[j]
            hcol[j] = h
        new_norm = torch.linalg.norm(w)
        if reorth:   # conditional reorthogonalization (Gmres.h:117-130)
            need = (Avk_norm + 1e-3 * new_norm) == Avk_norm
            for j in range(k + 1):
                h = torch.where(need, w @ V[j], 0.0)
                w = w - h * V[j]
                hcol[j] = hcol[j] + h
            new_norm = torch.where(need, torch.linalg.norm(w), new_norm)
        hcol[k + 1] = new_norm
        V[k + 1] = torch.where(new_norm > 0, w / new_norm, w)

        if make_triangular:
            # the earlier rotations on the new column (Gmres.h:139-148)
            for j in range(k):
                h0, h1 = hcol[j].clone(), hcol[j + 1].clone()
                hcol[j] = cs[j] * h0 - sn[j] * h1
                hcol[j + 1] = sn[j] * h0 + cs[j] * h1
            # the rotation zeroing the subdiagonal (Gmres.h:150-160)
            nu = torch.sqrt(hcol[k] ** 2 + hcol[k + 1] ** 2)
            ck = torch.where(nu > 0, hcol[k] / nu, 1.0)
            sk = torch.where(nu > 0, -hcol[k + 1] / nu, 0.0)
            hcol[k] = ck * hcol[k] - sk * hcol[k + 1]
            hcol[k + 1] = 0.0
            g0, g1 = g[k].clone(), g[k + 1].clone()
            g[k] = ck * g0 - sk * g1
            g[k + 1] = sk * g0 + ck * g1
            rho = torch.abs(g[k + 1])
            H[:, k] = hcol
            cs[k], sn[k] = ck, sk
        else:
            # the (k+2, k+1) block padded to the workspace: inactive
            # columns take the unit subdiagonal, so their y entries solve
            # rows whose right side is zero, exactly 0
            H[:, k] = hcol
            rowm = rows < k + 2
            colm = cols < k + 1
            Hm = (H * (rowm[:, None] & colm[None, :])
                  + sub * (~colm)[None, :])
            rhs = torch.where(rowm, g, 0.0)
            q, r_ = torch.linalg.qr(Hm)
            y = torch.linalg.solve_triangular(
                r_, (q.T @ rhs)[:, None], upper=True)[:, 0]
            rho = torch.linalg.norm(rhs - Hm @ y)
        errs[k + 1] = rho
        k += 1

    if make_triangular:
        # back-substitution on the k x k upper triangle (Gmres.h:181-184),
        # rows >= k with a unit diagonal and zero right side -> y = 0
        active = cols < k
        Ht = torch.where(active[:, None] & active[None, :], H[:k_max], 0.0)
        Ht = Ht + torch.diag(torch.where(active, 0.0, 1.0).to(dtype))
        rhs = torch.where(active, g[:k_max], 0.0)
        y = torch.linalg.solve_triangular(Ht, rhs[:, None], upper=True)[:, 0]
    x = x0 + V[:k_max].T @ y
    return GmresResult(x=x, iters=torch.tensor(k, dtype=torch.int32,
                                               device=device),
                       residual=rho, err_history=errs)


def gmres_dense(
    A: torch.Tensor,
    b: torch.Tensor,
    x0: torch.Tensor,
    k_max: int,
    eps: float = 1e-10,
    reorth: bool = True,
    make_triangular: bool = True,
) -> GmresResult:
    """The dense-matrix overload (``Gmres.h:42-52``): :func:`gmres` with
    ``Amul(v) = A @ v``."""
    return gmres(lambda v: A @ v, b, x0, k_max, eps=eps, reorth=reorth,
                 make_triangular=make_triangular)
