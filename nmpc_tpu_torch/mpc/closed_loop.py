"""Batched closed-loop MPC simulation: B controllers tick together.

Port of ``make_closed_loop_batch`` in ``nmpc_tpu/mpc/closed_loop.py``.
Each tick is one warm-started batched solve, then u[0] is applied to the
plant and the input trajectory is shifted by one stage for the next
tick's warm start.  The JAX version compiles the tick loop into one
``lax.scan``; here it is a Python loop over ticks on device tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch import func


class ClosedLoopLog(NamedTuple):
    ts: torch.Tensor       # [S]
    xs: torch.Tensor       # [B, S, nx] state before each step
    us: torch.Tensor       # [B, S, nu] input applied
    iters: torch.Tensor    # [B, S] solver iterations
    status: torch.Tensor   # [B, S] solver status


def _tick_solver(solver):
    """The solver used inside the tick loop: warm-started ticks are 1-3
    iteration solves, where ``ls_mode="auto"``'s predictor is overhead, so
    a solver left on "auto" is rebuilt with the always-sweep path.  An
    explicit ``ls_mode`` is respected."""
    if solver.config.ls_mode == "auto":
        return type(solver)(solver.problem,
                            dataclasses.replace(solver.config,
                                                ls_mode="sweep"))
    return solver


def make_closed_loop_batch(solver, n_steps: int,
                           sim_dynamics: Optional[Callable] = None):
    """Build ``sim(t0, x0s [B, nx], us0s [B, N, nu]) -> ClosedLoopLog``.

    ``sim_dynamics(t, x, u)`` is the plant; it defaults to the problem's
    dynamics (one horizon dt per MPC step)."""
    solver = _tick_solver(solver)
    problem = solver.problem
    dt = problem.dt
    plant = func.vmap(sim_dynamics or problem.dynamics, in_dims=(None, 0, 0))

    def shift(t_next, uss):
        last = uss[:, -1]
        if problem.input_mask is not None:
            t_term_new = t_next + uss.shape[1] * dt
            m_new = problem.input_mask(t_term_new)
            m_old = problem.input_mask(t_term_new - dt)
            same = torch.all(m_new == m_old)
            last = torch.where(same, last * m_new[None, :].to(last.dtype),
                               torch.zeros_like(last))
        return torch.cat([uss[:, 1:], last[:, None]], dim=1)

    def sim(t0, x0s, us0s) -> ClosedLoopLog:
        t = torch.as_tensor(t0, dtype=x0s.dtype, device=x0s.device)
        xs, uss = x0s, us0s
        log = {k: [] for k in ("ts", "xs", "us", "iters", "status")}
        for _ in range(n_steps):
            res = solver.solve_batch(t, xs, uss)
            u0 = res.us[:, 0]
            xs_next = plant(t, xs, u0)
            uss_next = shift(t + dt, res.us)
            for k, v in zip(log, (t, xs, u0, res.iters, res.status)):
                log[k].append(v)
            t, xs, uss = t + dt, xs_next, uss_next
        batch = lambda k: torch.stack(log[k], dim=1)
        return ClosedLoopLog(ts=torch.stack(log["ts"]), xs=batch("xs"),
                             us=batch("us"), iters=batch("iters"),
                             status=batch("status"))

    return sim
