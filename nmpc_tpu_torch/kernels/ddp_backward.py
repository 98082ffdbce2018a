"""Batch-minor ("stacked") DDP backward pass in torch ops, unboxed and
boxed.

Port of ``nmpc_tpu/kernels/ddp_backward.py``: ``backward_stacked``,
``boxqp_stacked`` and ``backward_stacked_boxed``.  Every stage quantity is
stored ``[..., small_dims..., B]`` and the small-matrix contractions are
written out as broadcast-multiply-reduce over the batch.  They are the
plain versions of the CUDA kernels (``kernels/ddp_backward_fused.py``,
``kernels/ddp_backward_boxed.py``, ``kernels/ddp_backward_remat.py``):
the CPU path, the path of a solve that names ``backward_impl="stacked"``
or that no kernel takes, and the reference each kernel is held against
on the card.  Math follows the reference
``DDPSolver.hpp:343-534`` and ``BoxQP.h:141-347``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from nmpc_tpu_torch.core.types import (BoxQPConfig, BoxQPStatus,
                                        DDPConfig)


class StackedDerivs(NamedTuple):
    """Stage derivatives, batch-minor: leading axis N, trailing axis B."""

    Fx: torch.Tensor   # [N, nx, nx, B]
    Fu: torch.Tensor   # [N, nx, nu, B]
    Lx: torch.Tensor   # [N, nx, B]
    Lu: torch.Tensor   # [N, nu, B]
    Lxx: torch.Tensor  # [N, nx, nx, B]
    Luu: torch.Tensor  # [N, nu, nu, B]
    Lxu: torch.Tensor  # [N, nx, nu, B]


class StackedBounds(NamedTuple):
    """Box bounds of the boxed backward, batch-minor: the absolute bounds
    and the current inputs they are taken relative to."""

    lower: torch.Tensor  # [N, nu, B]
    upper: torch.Tensor  # [N, nu, B]
    u: torch.Tensor      # [N, nu, B]


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


def _q_expansion(config: DDPConfig, d, Vx, Vxx, lam, second=None):
    """One stage's Q-function expansion and its regularized blocks
    (``DDPSolver.hpp:369-448``): returns (Qu, Qx, Qux, Quu, Qxx, Qux_reg,
    Quu_F), with lam [B] on Vxx (reg_type 2) or on Quu (reg_type 1).
    ``second`` is the stage's (Fxx, Fuu, Fxu) for full DDP."""
    Fx, Fu, Lx, Lu, Lxx, Luu, Lxu = d
    nx, nu = Fx.shape[0], Fu.shape[1]
    dtype, device = Vx.dtype, Vx.device
    lam_b = lam[None, None, :]
    FuT = _mT(Fu)
    FxT = _mT(Fx)
    Qu = Lu + _mv(FuT, Vx)
    Qx = Lx + _mv(FxT, Vx)
    FuT_Vxx = _mm(FuT, Vxx)
    Qux = _mT(Lxu) + _mm(FuT_Vxx, Fx)
    Quu = Luu + _mm(FuT_Vxx, Fu)
    Qxx = Lxx + _mm(_mm(FxT, Vxx), Fx)
    if second is not None:
        Fxx, Fuu, Fxu = second
        VxFxu = _vx_dot_f2(Vx, Fxu)   # [nx, nu, B]
        VxFuu = _vx_dot_f2(Vx, Fuu)   # [nu, nu, B]
        Qux = Qux + _mT(VxFxu)
        Quu = Quu + VxFuu
        Qxx = Qxx + _vx_dot_f2(Vx, Fxx)

    if config.reg_type == 2:
        eye_nx = torch.eye(nx, dtype=dtype, device=device)[:, :, None]
        FuT_Vr = _mm(FuT, Vxx + lam_b * eye_nx)
        Qux_reg = _mT(Lxu) + _mm(FuT_Vr, Fx)
        Quu_F = Luu + _mm(FuT_Vr, Fu)
        if second is not None:
            Qux_reg = Qux_reg + _mT(VxFxu)
            Quu_F = Quu_F + VxFuu
    else:
        Qux_reg = Qux
        Quu_F = Quu
    if config.reg_type == 1:
        eye_nu = torch.eye(nu, dtype=dtype, device=device)[:, :, None]
        Quu_F = Quu_F + lam_b * eye_nu
    return Qu, Qx, Qux, Quu, Qxx, Qux_reg, Quu_F


def _value_update(Qu, Qx, Qux, Quu, Qxx, k, K, dV):
    """The value-function carry from the unregularized Q terms and the
    stage's gains: (Vx, Vxx symmetrized, dV)."""
    Quu_k = _mv(Quu, k)
    KT = _mT(K)
    dV = dV + torch.stack([torch.sum(k * Qu, dim=0),
                           0.5 * torch.sum(k * Quu_k, dim=0)])
    Vx = Qx + _mv(KT, Quu_k) + _mv(KT, Qu) + _mv(_mT(Qux), k)
    Vxx = (Qxx + _mm(KT, _mm(Quu, K)) + _mm(KT, Qux)
           + _mm(_mT(Qux), K))
    return Vx, 0.5 * (Vxx + _mT(Vxx)), dV


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

    Vx, Vxx = Vx_T, Vxx_T
    dV = torch.zeros((2, B), dtype=dtype, device=device)
    ok = torch.ones((B,), dtype=torch.bool, device=device)
    ks = torch.empty((N, nu, B), dtype=dtype, device=device)
    Ks = torch.empty((N, nu, nx, B), dtype=dtype, device=device)
    for i in reversed(range(N)):
        Qu, Qx, Qux, Quu, Qxx, Qux_reg, Quu_F = _q_expansion(
            config, [a[i] for a in D], Vx, Vxx, lam,
            None if D2 is None else [a[i] for a in D2])
        L, ok_i = _chol_bl(Quu_F)
        k = -_chol_solve_bl(L, Qu[:, None, :])[:, 0, :]        # [nu, B]
        K = -_chol_solve_bl(L, Qux_reg)                        # [nu, nx, B]
        Vx, Vxx, dV = _value_update(Qu, Qx, Qux, Quu, Qxx, k, K, dV)
        ok = ok & ok_i
        ks[i] = k
        Ks[i] = K
    return ks, Ks, dV, ok


def _obj_bl(x, H, g):
    return torch.sum(x * g, dim=0) + 0.5 * torch.sum(x * _mv(H, x), dim=0)


def _clip(v, lo, hi):
    """Clamp to [lo, hi] by selects: a clipped value is the bound's bits,
    which the clamped-set test compares with ``==``."""
    return torch.minimum(torch.maximum(v, lo), hi)


def _step_schedule(config: BoxQPConfig, n: int, dtype, device):
    """The first ``n`` Armijo steps 1, f, f^2, ... formed by repeated
    multiplication at ``dtype``, as the reference's sequential loop forms
    them (``BoxQP.h:293-309``)."""
    s = torch.ones((), dtype=dtype, device=device)
    steps = [s]
    for _ in range(n - 1):
        s = s * config.step_factor
        steps.append(s)
    return torch.stack(steps)


def boxqp_stacked(H, g, lower, upper, x0, config: BoxQPConfig, host=bool,
                  stats=None):
    """Batch-minor projected-Newton BoxQP (reference ``BoxQP.h:141-347``).

    H [n, n, B], the rest [n, B].  Every lane runs the semantics of
    ``solvers/boxqp.py::boxqp_solve``; lanes that finish are frozen.  The
    QP iterations and the tail of the Armijo schedule are masked Python
    loops, each trip reading one device flag through ``host`` (the
    solver's counted read); the first ``ls_block`` Armijo candidates are
    evaluated at once.  A lane that exhausts the schedule (a step below
    ``min_step``, or the end of a truncated ``max_ls_iter`` schedule)
    takes its last-visited candidate and exits MAX_LS_ITER; MAX_ITER and
    MAX_LS_ITER count as success.

    ``stats``, a dict if given, receives per lane the QP iterations
    (``"qp_iters"``), the most Armijo candidates one iteration visited
    (``"ls_candidates"``), the candidates visited in all (``"ls_evals"``)
    and the free set returned (``"free"``, [n, B]).
    Returns (x, ok [B], free [n, B] 0/1, cholL [n, n, B], iterations)."""
    n, B = g.shape
    dtype, device = g.dtype, g.device
    eye = torch.eye(n, dtype=dtype, device=device)[:, :, None]
    n_ls = config.max_ls_iter + 1
    K1 = min(config.ls_block, n_ls)
    steps_h = _step_schedule(config, K1, dtype, device)        # [K1]
    below_h = steps_h < config.min_step                        # [K1]

    x = _clip(x0, lower, upper)
    obj = _obj_bl(x, H, g)
    old_obj = obj
    status = torch.zeros((B,), dtype=torch.int32, device=device)
    free = torch.ones((n, B), dtype=dtype, device=device)
    chol = eye.expand(n, n, B).clone()
    qp_iters = torch.zeros((B,), dtype=torch.int32, device=device)
    ls_visits = torch.zeros((B,), dtype=torch.int32, device=device)
    ls_evals = torch.zeros((B,), dtype=torch.int32, device=device)
    it = 0
    while it < config.max_iter and host(torch.any(status == 0)):
        active = status == 0
        it += 1
        improve_done = (it > 1) & (
            (old_obj - obj) < config.rel_improve_thre * torch.abs(old_obj))
        old_obj = torch.where(active, obj, old_obj)

        grad = g + _mv(H, x)
        clamped = (((x == lower) & (grad > 0))
                   | ((x == upper) & (grad < 0)))
        fm, cm = (~clamped).to(dtype), clamped.to(dtype)
        all_clamped = torch.all(clamped, dim=0)
        Lrows, chol_ok = _chol_bl(fm[:, None, :] * H * fm[None, :, :]
                                  + eye * cm[None, :, :])
        zero = torch.zeros((B,), dtype=dtype, device=device)
        cholL = torch.stack([torch.stack(
            [Lrows[i][j] if j <= i else zero for j in range(n)])
            for i in range(n)])
        small_grad = torch.sum(fm * grad * grad, dim=0) < config.grad_thre**2
        rhs = fm * (g + _mv(H, cm * x))
        d = fm * (-_chol_solve_bl(Lrows, rhs[:, None, :])[:, 0, :] - fm * x)
        sdg = torch.sum(d * grad, dim=0)
        bad_dir = sdg > 1e-10
        pre_exit = (improve_done | all_clamped | ~chol_ok | small_grad
                    | bad_dir)

        # Armijo head: the first K1 candidates at once, first stop per lane
        xc = _clip(x[None] + steps_h[:, None, None] * d[None], lower[None],
                   upper[None])                                # [K1, n, B]
        Hxc = torch.sum(H[None] * xc[:, None, :, :], dim=2)    # [K1, n, B]
        objc = (torch.sum(xc * g[None], dim=1)
                + 0.5 * torch.sum(xc * Hxc, dim=1))            # [K1, B]
        accept = ((objc - old_obj[None]) / (steps_h[:, None] * sdg[None])
                  >= config.armijo_param)
        stop = accept | below_h[:, None]
        any_stop = torch.any(stop, dim=0)
        # no stop in the head: the last-visited candidate, which is the
        # exhaustion result when the head is the whole schedule and is
        # overwritten by the tail otherwise
        k_star = torch.where(any_stop,
                             torch.argmax(stop.to(torch.uint8), dim=0),
                             torch.full_like(qp_iters, K1 - 1,
                                             dtype=torch.long))
        x_cand = torch.take_along_dim(xc, k_star[None, None, :], dim=0)[0]
        obj_cand = torch.take_along_dim(objc, k_star[None, :], dim=0)[0]
        # a below-min_step stop is exhaustion whatever Armijo says
        # (BoxQP.h:304-308)
        ls_exhausted = below_h[k_star]
        if K1 == n_ls:
            ls_exhausted = ls_exhausted | ~any_stop
        visited = (k_star + 1).to(torch.int32)

        # the sequential tail for lanes with no stop in the head
        need_tail = active & ~pre_exit & ~any_stop
        if K1 < n_ls:
            step = steps_h[-1].expand(B).clone()
            exh = torch.zeros((B,), dtype=torch.bool, device=device)
            done = ~need_tail
            k = K1
            while k < n_ls and host(torch.any(~done)):
                step = torch.where(done, step, step * config.step_factor)
                xc1 = _clip(x + step[None] * d, lower, upper)
                obj1 = _obj_bl(xc1, H, g)
                acc1 = (obj1 - old_obj) / (step * sdg) >= config.armijo_param
                bel1 = step < config.min_step
                upd = ~done
                x_cand = torch.where(upd[None], xc1, x_cand)
                obj_cand = torch.where(upd, obj1, obj_cand)
                visited = visited + upd.to(torch.int32)
                stop1 = (acc1 | bel1) & upd
                exh = exh | (stop1 & bel1)
                done = done | stop1
                k += 1
            # a lane still not done ran out of the schedule
            ls_exhausted = ls_exhausted | exh | (need_tail & ~done)

        for cond, code in ((improve_done, BoxQPStatus.SMALL_IMPROVEMENT),
                           (all_clamped, BoxQPStatus.ALL_CLAMPED),
                           (~chol_ok, BoxQPStatus.HESSIAN_NOT_PD),
                           (small_grad, BoxQPStatus.SMALL_GRADIENT),
                           (bad_dir, BoxQPStatus.POSITIVE_DIR_DERIV),
                           (ls_exhausted, BoxQPStatus.MAX_LS_ITER)):
            status = torch.where(active & (status == 0) & cond,
                                 int(code), status)
        if it >= config.max_iter:
            status = torch.where(active & (status == 0),
                                 int(BoxQPStatus.MAX_ITER), status)

        take = active & ~pre_exit
        x = torch.where(take[None], x_cand, x)
        obj = torch.where(take, obj_cand, obj)
        keep_prev = ~active | improve_done
        free = torch.where(keep_prev[None], free, fm)
        chol = torch.where(keep_prev[None, None], chol, cholL)
        qp_iters = qp_iters + active.to(torch.int32)
        ls_visits = torch.where(take, torch.maximum(ls_visits, visited),
                                ls_visits)
        ls_evals = ls_evals + torch.where(take, visited, 0)
    if stats is not None:
        stats.update(qp_iters=qp_iters, ls_candidates=ls_visits,
                     ls_evals=ls_evals, free=free)
    return x, status >= 0, free, chol, it


def backward_stacked_boxed(config: DDPConfig, D: StackedDerivs,
                           bounds: StackedBounds, Vx_T, Vxx_T, lam,
                           D2: Optional[StackedSecond] = None, host=bool,
                           stats=None):
    """Boxed backward pass, batch-minor (``DDPSolver.hpp:450-497``): the
    feedforward from :func:`boxqp_stacked` on Quu_F and Qu with the bounds
    taken relative to the current input, warm-started from the next
    stage's feedforward (0 at the last stage); the feedback rows
    ``-free * (Quu_F free block)^-1 (free * Qux_reg)`` from the QP's last
    factorization, zero on clamped inputs; the value update with the
    unregularized Q terms.  D2 adds the full-DDP terms.

    ``host`` reads the QP loops' device flags.  ``stats``, a dict if
    given, receives ``"qp_iters"``, ``"ls_candidates"`` and ``"ls_evals"``
    [N, B] and ``"free"`` [N, nu, B] (see :func:`boxqp_stacked`).
    Returns (ks [N, nu, B], Ks [N, nu, nx, B], dV [2, B], ok [B] bool)."""
    N, nx = D.Fx.shape[0], D.Fx.shape[1]
    nu = D.Fu.shape[2]
    B = Vx_T.shape[-1]
    dtype, device = Vx_T.dtype, Vx_T.device

    Vx, Vxx = Vx_T, Vxx_T
    dV = torch.zeros((2, B), dtype=dtype, device=device)
    ok = torch.ones((B,), dtype=torch.bool, device=device)
    k_next = torch.zeros((nu, B), dtype=dtype, device=device)
    ks = torch.empty((N, nu, B), dtype=dtype, device=device)
    Ks = torch.empty((N, nu, nx, B), dtype=dtype, device=device)
    per_stage = {"qp_iters": [], "ls_candidates": [], "ls_evals": [],
                 "free": []}
    for i in reversed(range(N)):
        Qu, Qx, Qux, Quu, Qxx, Qux_reg, Quu_F = _q_expansion(
            config, [a[i] for a in D], Vx, Vxx, lam,
            None if D2 is None else [a[i] for a in D2])
        lo, hi, u_i = (a[i] for a in bounds)
        qp_stats = {} if stats is not None else None
        k, ok_i, free, cholL, _ = boxqp_stacked(
            Quu_F, Qu, lo - u_i, hi - u_i, k_next, config.boxqp, host,
            qp_stats)
        Lrows = [[cholL[a, b] for b in range(nu)] for a in range(nu)]
        K = -free[:, None, :] * _chol_solve_bl(Lrows,
                                               free[:, None, :] * Qux_reg)
        Vx, Vxx, dV = _value_update(Qu, Qx, Qux, Quu, Qxx, k, K, dV)
        ok = ok & ok_i
        ks[i] = k
        Ks[i] = K
        k_next = k
        if stats is not None:
            for key in per_stage:
                per_stage[key].insert(0, qp_stats[key])
    if stats is not None:
        stats.update({key: torch.stack(v) for key, v in per_stage.items()})
    return ks, Ks, dV, ok


def stack_derivs(Fx, Fu, Lx, Lu, Lxx, Luu, Lxu) -> StackedDerivs:
    """[B, N, ...] (vmap layout) -> [N, ..., B] (batch-minor layout)."""
    mv = lambda a: torch.movedim(a, 0, -1)
    return StackedDerivs(Fx=mv(Fx), Fu=mv(Fu), Lx=mv(Lx), Lu=mv(Lu),
                         Lxx=mv(Lxx), Luu=mv(Luu), Lxu=mv(Lxu))
