"""Projected-Newton QP with box constraints, one problem at a time.

Port of ``nmpc_tpu/solvers/boxqp.py`` (reference ``nmpc_ddp::BoxQP``,
``BoxQP.h:126-347``; Tassa, Mansard, Todorov, "Control-limited
differential dynamic programming", ICRA 2014): clamped-set detection by
exact bound equality (``BoxQP.h:187-206``), a Newton step on the free block
(``BoxQP.h:216-279``), Armijo backtracking with clamp projection
(``BoxQP.h:293-309``) and the reference's return codes (``BoxQP.h:375-383``).

As in the JAX package, the free block is solved through the masked
fixed-shape system ``(F H F + C) y = rhs`` (F = diag(free), C =
diag(clamped)), whose free block is ``H_free`` and whose clamped block is
the identity.  The loops are Python loops that read the problem's values;
the batched, masked version the DDP backward runs is
``kernels/ddp_backward.py::boxqp_stacked``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nmpc_tpu_torch.core.types import BoxQPConfig, BoxQPStatus
from nmpc_tpu_torch.kernels.linalg import cho_solve_small, cholesky_small


class BoxQPResult(NamedTuple):
    x: torch.Tensor          # solution [n]
    status: int              # BoxQPStatus (negative = failure)
    free_mask: torch.Tensor  # bool [n], free set of the last factorization
    chol: torch.Tensor       # [n, n] lower Cholesky of (F H F + C)
    iters: int
    obj: torch.Tensor        # final objective value


def _objective(x, H, g):
    return x @ g + 0.5 * x @ (H @ x)


def boxqp_solve(H, g, lower, upper, x0,
                config: BoxQPConfig = BoxQPConfig()) -> BoxQPResult:
    """Minimize 0.5 x'Hx + g'x  s.t. lower <= x <= upper, from ``x0``.

    Matches ``BoxQP::solve`` (``BoxQP.h:141-347``) step for step, with the
    JAX package's exhaustion rule: a line search that reaches ``min_step``
    (or runs out of a truncated ``max_ls_iter`` schedule) terminates with
    the last, tiniest candidate accepted and status MAX_LS_ITER."""
    n = g.shape[0]
    dtype = g.dtype
    x = torch.minimum(torch.maximum(x0, lower), upper)
    obj = _objective(x, H, g)
    old_obj = obj
    free_mask = torch.ones((n,), dtype=torch.bool, device=g.device)
    chol = torch.eye(n, dtype=dtype, device=g.device)
    status = BoxQPStatus.NOT_FINISHED
    it = 0
    while status == BoxQPStatus.NOT_FINISHED:
        it += 1
        # relative-improvement exit (BoxQP.h:176-181), checked first: the
        # free set and the factor keep the previous iteration's values
        improve_done = it > 1 and bool(
            (old_obj - obj) < config.rel_improve_thre * torch.abs(old_obj))
        old_obj = obj
        grad = g + H @ x
        # exact equality is intended: x was projected (BoxQP.h:187-191)
        clamped = ((x == lower) & (grad > 0)) | ((x == upper) & (grad < 0))
        free = ~clamped
        fm, cm = free.to(dtype), clamped.to(dtype)
        chol_new, chol_ok = cholesky_small(fm[:, None] * H * fm[None, :]
                                           + torch.diag(cm))
        small_grad = bool(torch.sum(fm * grad * grad) < config.grad_thre**2)
        # Newton direction on the free subspace (BoxQP.h:256-279)
        rhs = fm * (g + H @ (cm * x))
        d = fm * (-cho_solve_small(chol_new, rhs) - fm * x)
        sdg = d @ grad
        bad_dir = bool(sdg > 1e-10)   # BoxQP.h:283-291
        pre_exit = (improve_done or bool(torch.all(clamped))
                    or not bool(chol_ok) or small_grad or bad_dir)

        ls_exhausted = False
        if not pre_exit:
            # Armijo backtracking with projection (BoxQP.h:293-309)
            step = torch.ones((), dtype=dtype, device=g.device)
            x_cand = torch.minimum(torch.maximum(x + step * d, lower), upper)
            obj_cand = _objective(x_cand, H, g)
            hit_min, k = False, 0
            while (bool((obj_cand - old_obj) / (step * sdg)
                        < config.armijo_param)
                   and not hit_min and k < config.max_ls_iter):
                step = step * config.step_factor
                x_cand = torch.minimum(torch.maximum(x + step * d, lower),
                                       upper)
                obj_cand = _objective(x_cand, H, g)
                hit_min = bool(step < config.min_step)
                k += 1
            ls_exhausted = hit_min or bool(
                (obj_cand - old_obj) / (step * sdg) < config.armijo_param)

        # the reference's check order (BoxQP.h:176-336)
        for cond, code in (
                (improve_done, BoxQPStatus.SMALL_IMPROVEMENT),
                (bool(torch.all(clamped)), BoxQPStatus.ALL_CLAMPED),
                (not bool(chol_ok), BoxQPStatus.HESSIAN_NOT_PD),
                (small_grad, BoxQPStatus.SMALL_GRADIENT),
                (bad_dir, BoxQPStatus.POSITIVE_DIR_DERIV),
                (ls_exhausted, BoxQPStatus.MAX_LS_ITER),
                (it >= config.max_iter, BoxQPStatus.MAX_ITER)):
            if cond:
                status = code
                break
        if not pre_exit:
            # MAX_ITER still takes the candidate (BoxQP.h:327-336)
            x, obj = x_cand, obj_cand
        if not improve_done:
            free_mask, chol = free, chol_new
    return BoxQPResult(x=x, status=int(status), free_mask=free_mask,
                       chol=chol, iters=it, obj=obj)
