"""Receding-horizon MPC driver: one controller, solved on the host's
schedule.

Port of ``nmpc_tpu/mpc/driver.py``.  The reference's MPC "entry point" is a
hand-written loop in every test: solve -> apply u[0] -> plant step ->
shift warm start (``TestDDPBipedal.cpp:243-267``), with variants for
asynchronous MPC/sim rates (``TestDDPCartPole.cpp:321-347``) and
inter-solve affine feedback (``TestFmpcCartPole.cpp:351-356``).

* :func:`run_mpc` -- the loop, with disturbances, callbacks, an MPC rate
  below the simulation rate and input clamping like
  ``TestDDPCartPole.cpp:394``.
* :func:`shift_warm_start` -- the shift-by-one warm start with the
  reference's terminal-dimension handling
  (``TestDDPVerticalMotion.cpp:313-325``).

Times are Python floats, as in the JAX driver; a problem's callables get
them as float64 tensors on the state's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from nmpc_tpu_torch.core.problem import Problem


def _time(t, like):
    """Time ``t`` (a float) as a float64 tensor on ``like``'s device."""
    return torch.as_tensor(t, dtype=torch.float64, device=like.device)


def shift_warm_start(problem: Problem, t_next: float, us):
    """us <- [us[1:], us[-1]], with the new terminal entry zeroed when the
    active-input mask changes at the new terminal time (the reference resets
    to zeros when ``inputDim`` changes, ``TestDDPVerticalMotion.cpp:316-324``)
    and masked by the new terminal mask otherwise."""
    last = us[-1]
    if problem.input_mask is not None:
        t_term_new = t_next + us.shape[0] * problem.dt
        t_term_old = t_term_new - problem.dt
        m_new = problem.input_mask_at(_time(t_term_new, us))
        m_old = problem.input_mask_at(_time(t_term_old, us))
        same = torch.all(m_new == m_old)
        last = torch.where(same, last * m_new.to(last.dtype),
                           torch.zeros_like(last))
    return torch.cat([us[1:], last[None]])


@dataclasses.dataclass
class MpcLog:
    """Closed-loop trajectory log (one row per sim step)."""

    ts: np.ndarray
    xs: np.ndarray
    us: np.ndarray
    solve_iters: np.ndarray
    solve_status: np.ndarray
    solve_wall_ms: np.ndarray


def run_mpc(
    solver,
    x0,
    t0: float = 0.0,
    end_t: float = 10.0,
    sim_dt: Optional[float] = None,
    mpc_interval: int = 1,
    sim_dynamics: Optional[Callable] = None,
    disturbance_func: Optional[Callable] = None,
    input_clamp: Optional[Callable] = None,
    us_init=None,
    callback: Optional[Callable] = None,
) -> MpcLog:
    """Generic receding-horizon loop of a ``DDPSolver``: ``solver.solve``
    from the current state every ``mpc_interval``-th sim step, u[0]
    applied, the plant advanced by ``sim_dt``.

    sim_dt defaults to the problem dt; ``mpc_interval`` k re-solves every k-th
    sim step (the reference's mpc_dt = 2 x sim_dt cart-pole setup,
    ``TestDDPCartPole.cpp:302-303``).  ``sim_dynamics(t, x, u, dt)`` lets the
    plant integrate at a different rate/model than the horizon model
    (``TestFmpcCartPole.cpp:356``); it defaults to the problem's dynamics at
    a float64 time tensor.  ``disturbance_func(t) -> du`` adds input
    disturbance like the reference's interactive disturbance services
    (``TestDDPCartPole.cpp:405-412``).  ``input_clamp(t, u)`` bounds the
    applied input; ``callback(t, x, u_applied, result)`` sees every step.
    ``solve_wall_ms`` is each solve's host time, the device synchronized
    after it (0 on steps without a solve).
    """
    problem = solver.problem
    N = solver.config.horizon_steps
    dt = problem.dt
    sim_dt = dt if sim_dt is None else sim_dt

    if sim_dynamics is None:
        sim_dynamics = lambda t, x, u, h: problem.dynamics(
            _time(t, x), x, u).to(x.dtype)

    t = float(t0)
    x = torch.as_tensor(x0)
    us = (torch.zeros((N, problem.input_dim), dtype=x.dtype, device=x.device)
          if us_init is None else torch.as_tensor(us_init))
    u = torch.zeros((problem.input_dim,), dtype=x.dtype, device=x.device)

    ts, xs_log, us_log, iters_log, status_log, wall_log = [], [], [], [], [], []
    step = 0
    while t < end_t:
        if step % mpc_interval == 0:
            start = time.perf_counter()
            res = solver.solve(t, x, us)
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
            wall_ms = 1e3 * (time.perf_counter() - start)
            u = res.us[0]
            if input_clamp is not None:
                u = input_clamp(t, u)
            us = shift_warm_start(problem, t + dt, res.us)
            last_iters, last_status = int(res.iters), int(res.status)
        else:
            wall_ms = 0.0

        u_applied = u
        if disturbance_func is not None:
            u_applied = u + disturbance_func(t)

        ts.append(t)
        xs_log.append(x.cpu().numpy())
        us_log.append(u_applied.cpu().numpy())
        iters_log.append(last_iters)
        status_log.append(last_status)
        wall_log.append(wall_ms)
        if callback is not None:
            callback(t, x, u_applied, res)

        x = sim_dynamics(t, x, u_applied, sim_dt)
        t += sim_dt
        step += 1

    return MpcLog(
        ts=np.asarray(ts),
        xs=np.stack(xs_log),
        us=np.stack(us_log),
        solve_iters=np.asarray(iters_log),
        solve_status=np.asarray(status_log),
        solve_wall_ms=np.asarray(wall_log),
    )
