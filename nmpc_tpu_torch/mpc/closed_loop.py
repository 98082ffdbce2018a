"""Closed-loop MPC simulation: one controller, or B controllers that tick
together.

Port of ``make_closed_loop`` and ``make_closed_loop_batch`` in
``nmpc_tpu/mpc/closed_loop.py``.  Each tick is one warm-started solve,
then u[0] is applied to the plant and the input trajectory is shifted by
one stage for the next tick's warm start.  The JAX versions compile the
tick loop into one ``lax.scan``; here it is a Python loop over ticks on
device tensors, the time a tensor of the state's dtype as in the scan's
carry.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch import func


class ClosedLoopLog(NamedTuple):
    """Per-tick log; the batched loop's fields lead with the batch axis."""

    ts: torch.Tensor       # [S]
    xs: torch.Tensor       # [(B,) S, nx] state before each step
    us: torch.Tensor       # [(B,) S, nu] input applied
    iters: torch.Tensor    # [(B,) S] solver iterations
    status: torch.Tensor   # [(B,) S] solver status


def _tick_solver(solver):
    """The solver used inside the tick loop: warm-started ticks are 1-3
    iteration solves, where ``ls_mode="auto"``'s predictor is overhead, so
    a solver left on "auto" is rebuilt with the always-sweep path.  An
    explicit ``ls_mode`` is respected."""
    if solver.config.ls_mode == "auto":
        tick = copy.copy(solver)
        tick.config = dataclasses.replace(solver.config, ls_mode="sweep")
        return tick
    return solver


def _shift(problem, t_next, us):
    """The warm-start shift of a [..., N, nu] input trajectory at the
    tick time ``t_next`` (a tensor): the new terminal input is the old
    one, masked by the new terminal mask, or zero where the mask changes
    there (``TestDDPVerticalMotion.cpp:316-324``)."""
    last = us[..., -1, :]
    if problem.input_mask is not None:
        t_term_new = t_next + us.shape[-2] * problem.dt
        m_new = problem.input_mask(t_term_new)
        m_old = problem.input_mask(t_term_new - problem.dt)
        same = torch.all(m_new == m_old)
        last = torch.where(same, last * m_new.to(last.dtype),
                           torch.zeros_like(last))
    return torch.cat([us[..., 1:, :], last[..., None, :]], dim=-2)


def make_closed_loop(solver, n_steps: int,
                     sim_dynamics: Optional[Callable] = None):
    """Build ``sim(t0, x0 [nx], us0 [N, nu]) -> ClosedLoopLog`` for one
    controller: each of ``n_steps`` ticks one ``solver.solve``.

    ``sim_dynamics(t, x, u)`` is the plant; it defaults to the problem's
    dynamics (one horizon dt per MPC step).  A DDP solver left on
    ``ls_mode="auto"`` runs the sweep path (``_tick_solver``).  The JAX
    signature's ``mpc_interval``, which its loop never reads, is left
    out."""
    solver = _tick_solver(solver)
    problem = solver.problem
    dt = problem.dt
    plant = sim_dynamics or problem.dynamics

    def sim(t0, x0, us0) -> ClosedLoopLog:
        t = torch.as_tensor(t0, dtype=x0.dtype, device=x0.device)
        x, us = x0, us0
        log = {k: [] for k in ClosedLoopLog._fields}
        for _ in range(n_steps):
            res = solver.solve(t, x, us)
            u = res.us[0]
            x_next = plant(t, x, u)
            us_next = _shift(problem, t + dt, res.us)
            for k, v in zip(log, (t, x, u, res.iters, res.status)):
                log[k].append(v)
            t, x, us = t + dt, x_next, us_next
        return ClosedLoopLog(*(torch.stack(log[k]) for k in log))

    return sim


def make_closed_loop_batch(solver, n_steps: int,
                           sim_dynamics: Optional[Callable] = None):
    """Build ``sim(t0, x0s [B, nx], us0s [B, N, nu]) -> ClosedLoopLog``.

    ``sim_dynamics(t, x, u)`` is the plant; it defaults to the problem's
    dynamics (one horizon dt per MPC step)."""
    solver = _tick_solver(solver)
    problem = solver.problem
    dt = problem.dt
    plant = func.vmap(sim_dynamics or problem.dynamics, in_dims=(None, 0, 0))

    def sim(t0, x0s, us0s) -> ClosedLoopLog:
        t = torch.as_tensor(t0, dtype=x0s.dtype, device=x0s.device)
        xs, uss = x0s, us0s
        log = {k: [] for k in ("ts", "xs", "us", "iters", "status")}
        for _ in range(n_steps):
            res = solver.solve_batch(t, xs, uss)
            u0 = res.us[:, 0]
            xs_next = plant(t, xs, u0)
            uss_next = _shift(problem, t + dt, res.us)
            for k, v in zip(log, (t, xs, u0, res.iters, res.status)):
                log[k].append(v)
            t, xs, uss = t + dt, xs_next, uss_next
        batch = lambda k: torch.stack(log[k], dim=1)
        return ClosedLoopLog(ts=torch.stack(log["ts"]), xs=batch("xs"),
                             us=batch("us"), iters=batch("iters"),
                             status=batch("status"))

    return sim
