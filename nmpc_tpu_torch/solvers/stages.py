"""Batch-minor stage building blocks of the batched DDP solve.

Port of the per-stage helpers of ``nmpc_tpu/solvers/ddp.py``: the problem's
callables batched over the trailing lane axis with ``torch.func.vmap``,
the stage derivatives (with the input mask and, for a boxed solve, the
bounds) and their sweep over the horizon, and the two line-search
rollouts.  They are the solver's plain path and the plain
versions the CUDA kernels are held against: ``_derivative_sweep_lanes``
with ``backward_stacked`` for the remat backward
(``kernels/ddp_backward_remat.py``), ``_forward_selected_lanes`` and
``_forward_costs_lanes`` for the fused rollouts
(``kernels/ddp_forward_remat.py``).  They live apart from the solver so
that the kernel modules reach them without importing it.
"""

from __future__ import annotations

import torch
from torch import func
from torch.utils._pytree import tree_map

from nmpc_tpu_torch.core.problem import Problem
from nmpc_tpu_torch.core.types import DDPConfig


def _lanes(f, n_array_args: int):
    """vmap ``f(t, *arrays)`` over the trailing batch axis of the arrays;
    every output gets a trailing batch axis.

    The batch axis is moved last after the ``vmap``, not by
    ``out_dims=-1``: for an output that does not depend on the batch (an
    analytic derivative that is constant) ``out_dims=-1`` returns a
    tensor of garbage shape (torch 2.13)."""
    batched = func.vmap(f, in_dims=(None,) + (-1,) * n_array_args,
                        out_dims=0)

    def run(*args):
        return tree_map(lambda a: torch.movedim(a, 0, -1), batched(*args))
    return run


def _step_lanes(problem):
    """Batched (next state, running cost) of one stage: one vmapped call
    per stage instead of two."""
    return _lanes(lambda t, x, u: (problem.dynamics(t, x, u),
                                   problem.running_cost(t, x, u)), 2)


def _deriv_dtype_of(config: DDPConfig, dtype):
    if config.deriv_dtype == "same":
        return dtype
    return getattr(torch, config.deriv_dtype)


def _stage_times(problem, t0, N):
    return t0 + problem.dt * torch.arange(N, dtype=t0.dtype, device=t0.device)


def _stage_bounds(problem: Problem, t, u, mask=None):
    """The boxed backward's (lower, upper, u) of one stage
    (``nmpc_tpu/solvers/ddp.py:173-186``): the problem's limits at the
    solve's device and dtype, (-1, 1) on masked-out inputs, +-inf without
    limits."""
    dtype, device = u.dtype, u.device
    nu = problem.input_dim
    if problem.input_limits is None:
        inf = torch.full((nu,), float("inf"), dtype=dtype, device=device)
        return -inf, inf, u
    lower, upper = (torch.as_tensor(a, dtype=dtype, device=device)
                    for a in problem.input_limits(t))
    if mask is not None:
        active = mask > 0
        lower = torch.where(active, lower, -torch.ones_like(lower))
        upper = torch.where(active, upper, torch.ones_like(upper))
    return lower, upper, u


def _stage_derivs(problem: Problem, config: DDPConfig, t, x, u):
    """One stage's derivatives at the solve dtype: (Fx, Fu, Lx, Lu, Lxx,
    Luu, Lxu), then (Fxx, Fuu, Fxu) for full DDP, then the bounds (lower,
    upper, u) of :func:`_stage_bounds` for a boxed solve.  The callbacks
    run at ``deriv_dtype``; results are cast back at the boundary so wide
    model constants do not promote the solve."""
    dtype = x.dtype
    ddt = _deriv_dtype_of(config, dtype)
    td, xd, ud = t.to(ddt), x.to(ddt), u.to(ddt)
    Fx, Fu = (a.to(dtype) for a in problem.linearize_dynamics(td, xd, ud))
    Lx, Lu, Lxx, Luu, Lxu = (
        a.to(dtype) for a in problem.quadraticize_running_cost(td, xd, ud))
    second = ()
    if config.use_state_eq_second_derivative:
        second = tuple(a.to(dtype)
                       for a in problem.second_order_dynamics(td, xd, ud))
    mask = None
    if problem.input_mask is not None:
        # Masked-dimension embedding: zero the inactive columns and put a
        # unit diagonal on the inactive Luu block, so inactive inputs get
        # k = 0 and zero K rows (reference DDPSolver.hpp:513-517).
        mask = problem.input_mask(t).to(dtype)
        Fu = Fu * mask[None, :]
        Lu = Lu * mask
        Luu = Luu * (mask[:, None] * mask[None, :]) + torch.diag_embed(1.0 - mask)
        Lxu = Lxu * mask[None, :]
        if second:
            Fxx, Fuu, Fxu = second
            second = (Fxx, Fuu * (mask[None, :, None] * mask[None, None, :]),
                      Fxu * mask[None, None, :])
    bounds = ()
    if config.with_input_constraint:
        bounds = _stage_bounds(problem, t, u, mask)
    return (Fx, Fu, Lx, Lu, Lxx, Luu, Lxu) + second + bounds


def _terminal_quad_lanes(problem, config, t0, xs):
    """Terminal cost expansion: (Vx_T [nx, B], Vxx_T [nx, nx, B])."""
    N = config.horizon_steps
    dtype = xs.dtype
    ddt = _deriv_dtype_of(config, dtype)
    quad = _lanes(problem.quadraticize_terminal_cost, 1)
    Vx_T, Vxx_T = quad((t0 + N * problem.dt).to(ddt), xs[-1].to(ddt))
    return Vx_T.to(dtype), Vxx_T.to(dtype)


def _stage_derivs_sweep(problem, config, t0, xs, us):
    """Stage derivatives of the whole horizon, batch-minor and contiguous
    (every field [N, dims..., B]).

    One ``vmap`` over N of the per-lane batching (batch axis last) gives
    the batch-minor layout; ``contiguous()`` then copies it into the dense
    layout the CUDA kernel reads."""
    ts = _stage_times(problem, t0, config.horizon_steps)
    per_lane = _lanes(
        lambda t, x, u: _stage_derivs(problem, config, t, x, u), 2)
    D = func.vmap(per_lane, in_dims=(0, 0, 0), out_dims=0)(ts, xs[:-1], us)
    return tuple(a.contiguous() for a in D)


def _derivative_sweep_lanes(problem, config, t0, xs, us):
    """:func:`_stage_derivs_sweep` plus the terminal expansion."""
    D = _stage_derivs_sweep(problem, config, t0, xs, us)
    Vx_T, Vxx_T = _terminal_quad_lanes(problem, config, t0, xs)
    return D, Vx_T.contiguous(), Vxx_T.contiguous()


def _forward_costs_lanes(problem, config, t0, xs, us, ks, Ks, alphas,
                         cdtype):
    """Cost-only line-search rollout of every alpha at once
    (``DDPSolver.hpp:242-265,537-560``).  The state carry is laid out
    [nx, A, B] so that the alpha and batch axes merge into one vmapped axis
    without a copy.  Returns per-alpha total costs [A, B]."""
    N = config.horizon_steps
    dtype = xs.dtype
    nx, B = xs.shape[1], xs.shape[2]
    A = alphas.shape[0]
    ts = _stage_times(problem, t0, N)
    step = _step_lanes(problem)
    a_bc = alphas[None, :, None]                          # [1, A, 1]
    x = xs[0][:, None, :].expand(nx, A, B)
    ctot = torch.zeros((A, B), dtype=cdtype, device=xs.device)
    for i in range(N):
        dx = x - xs[i][:, None, :]                        # [nx, A, B]
        u = (us[i][:, None, :] + a_bc * ks[i][:, None, :]
             + torch.sum(Ks[i][:, :, None, :] * dx[None], dim=1))
        xn, c = step(ts[i], x.reshape(nx, A * B), u.reshape(-1, A * B))
        x = xn.to(dtype).reshape(nx, A, B)
        ctot = ctot + c.to(cdtype).reshape(A, B)
    term = _lanes(problem.terminal_cost, 1)
    c_term = term(t0 + N * problem.dt, x.reshape(nx, A * B)).to(cdtype)
    return ctot + c_term.reshape(A, B)


def _forward_selected_lanes(problem, config, t0, xs, us, ks, Ks, alpha,
                            cdtype):
    """Rollout at each lane's selected alpha [B]: (xs [N+1,nx,B],
    us [N,nu,B], costs [N+1,B], cost_sum [B] in cdtype).  ``cost_sum`` is
    accumulated in horizon order exactly like the per-alpha sums of
    :func:`_forward_costs_lanes`, so the alpha[0] accept decision is the
    same in every ``ls_mode``."""
    N = config.horizon_steps
    dtype = xs.dtype
    ts = _stage_times(problem, t0, N)
    step = _step_lanes(problem)
    x = xs[0]
    ctot = torch.zeros(xs.shape[-1:], dtype=cdtype, device=xs.device)
    xs_new, us_new, cs = [x], [], []
    for i in range(N):
        u = (us[i] + alpha[None] * ks[i]
             + torch.sum(Ks[i] * (x - xs[i])[None], dim=1))
        xn, c_raw = step(ts[i], x, u)
        x = xn.to(dtype)
        ctot = ctot + c_raw.to(cdtype)
        xs_new.append(x)
        us_new.append(u)
        cs.append(c_raw.to(dtype))
    c_term = _lanes(problem.terminal_cost, 1)(t0 + N * problem.dt, x)
    cs.append(c_term.to(dtype))
    return (torch.stack(xs_new), torch.stack(us_new), torch.stack(cs),
            ctot + c_term.to(cdtype))
