"""Profiled solve mode: real per-phase durations for the trace dumps.

Port of ``nmpc_tpu/utils/profiled.py``.  The reference times every phase
with ``std::chrono`` inside the solver loop (``DDPSolver::
ComputationDuration``, ``DDPSolver.h:219-247``; TraceData duration
columns, ``DDPSolver.h:179-216``; FMPC ``FmpcSolver.h:254-288``).  The
JAX package re-runs the iteration as a host loop over separately jitted
stages to time them.  The port's solves are host loops already, so a
profiled solve is the solver's own ``solve`` with a
``utils/timing.py::PhaseTimer`` bracketing each iteration's phases (CUDA
events on the card, ``perf_counter`` on the CPU): its result is the
untimed solve's, bit for bit.  A warm-up solve first builds and loads the
kernels, so that the times are steady-state ones.  Arrays the caller
did not place (numpy arrays, lists) go to ``device``, the card unless the
caller asks for the CPU; tensors stay where they are.

The reference's backward sub-split (Q / reg / gain, ``DDPSolver.h:
239-247``) has no place inside the backward kernels;
:func:`estimate_backward_split` times the three torch computations (the
Q expansion, regularization + Cholesky, the gain solves) at the solve's
shapes instead: where the backward's work lies, by shape.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from nmpc_tpu_torch.utils.timing import (ComputationDuration, PhaseTimer,
                                         _sync)

DDP_PHASES = ("derivative", "backward", "forward")
FMPC_PHASES = ("coeff", "backward", "forward", "update")


def _placed(a, device):
    """``a`` itself if it is a tensor, else a tensor of it on ``device``."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a), device=device)


def profiled_solve_ddp(solver, t0, x0, us_init, warmup: bool = True,
                       device="cuda"):
    """One DDP solve with per-iteration phase timing.

    Returns ``(DDPResult, durations, ComputationDuration)`` where
    ``durations`` maps ``{"derivative", "backward", "forward"}`` to
    per-trace-row millisecond arrays (row 0 = 0, like the reference's
    first TraceData row) ready for ``dump_ddp_trace(durations=...)``.
    """
    x0, us_init = _placed(x0, device), _placed(us_init, device)
    if warmup:
        solver.solve(t0, x0, us_init)
    timer = PhaseTimer(x0.device)
    _sync(x0.device)
    start = time.perf_counter()
    res = solver.solve(t0, x0, us_init, timer=timer)
    _sync(x0.device)
    solve_ms = 1e3 * (time.perf_counter() - start)
    n_trace = solver.config.max_iter + 1
    dur = timer.durations(n_trace, ("setup",) + DDP_PHASES)
    setup = dur.pop("setup")
    cd = ComputationDuration(
        solve=solve_ms, setup=float(setup[0]),
        opt=float(sum(dur[k].sum() for k in DDP_PHASES)),
        **{k: float(dur[k].sum()) for k in DDP_PHASES})
    return res, dur, cd


def estimate_backward_split(solver, t0, x0, us, reps: int = 8,
                            device="cuda"):
    """Shape-representative (Q, reg, gain) millisecond split of one
    backward pass (the reference's ``DDPSolver.h:239-247`` sub-timers).

    Times three torch computations over all N stages at the solve's
    shapes, each the best of ``reps`` synchronized runs: the Q expansion
    (the GEMM chain), regularization + ``cholesky_small``, and the gain
    solves (``cho_solve_small``).  The recursion's coupling (V flowing
    between stages) is not timed, so read it as where the backward's work
    lies.
    """
    from nmpc_tpu_torch.kernels.linalg import cho_solve_small, cholesky_small
    from nmpc_tpu_torch.solvers import ddp as D
    from nmpc_tpu_torch.solvers.stages import _derivative_sweep_lanes

    problem, config = solver.problem, solver.config
    x0, us = _placed(x0, device), _placed(us, device)
    dtype, device = x0.dtype, x0.device
    t0 = torch.as_tensor(t0, dtype=dtype, device=device)
    us_l = us[:, :, None].contiguous()                       # [N, nu, 1]
    xs, _ = D._rollout_lanes(problem, config, t0, x0[:, None], us_l)
    Dst, Vx, Vxx = _derivative_sweep_lanes(problem, config, t0, xs, us_l)
    Fx, Fu, Lx, Lu, Lxx, Luu, Lxu = (torch.movedim(a, -1, 1)
                                     for a in Dst[:7])   # [N, B, ...]
    Vx, Vxx = Vx[..., 0], Vxx[..., 0]
    lam = config.initial_lambda

    def q_sweep():
        FuT, FxT = Fu.transpose(-1, -2), Fx.transpose(-1, -2)
        Qu = Lu + FuT @ Vx
        Qx = Lx + FxT @ Vx
        Qux = Lxu.transpose(-1, -2) + FuT @ Vxx @ Fx
        Quu = Luu + FuT @ Vxx @ Fu
        Qxx = Lxx + FxT @ Vxx @ Fx
        return Qu, Qx, Qux, Quu, Qxx

    Qu, _, Qux, Quu, _ = q_sweep()
    eye = torch.eye(Quu.shape[-1], dtype=dtype, device=device)

    def reg_sweep():
        return cholesky_small(Quu + lam * eye)

    L, _ = reg_sweep()

    def gain_sweep():
        return -cho_solve_small(L, Qu), -cho_solve_small(L, Qux)

    def best_of(fn):
        fn()
        ts = []
        for _ in range(reps):
            _sync(device)
            start = time.perf_counter()
            fn()
            _sync(device)
            ts.append(1e3 * (time.perf_counter() - start))
        return min(ts)

    return {"Q": best_of(q_sweep), "reg": best_of(reg_sweep),
            "gain": best_of(gain_sweep)}


def profiled_solve_fmpc(solver, t0, x0, variable, barrier_eps=1e-4,
                        warmup: bool = True, device="cuda"):
    """One FMPC solve with per-iteration phase timing (coeff / backward /
    forward / update, the reference's ``FmpcSolver.h:254-288`` split).

    Returns ``(FmpcResult, durations)`` with per-trace-row millisecond
    arrays for ``dump_fmpc_trace(durations=...)``.
    """
    x0 = _placed(x0, device)
    variable = dataclasses.replace(variable, **{
        f.name: _placed(getattr(variable, f.name), device)
        for f in dataclasses.fields(variable)})
    if warmup:
        solver.solve(t0, x0, variable, barrier_eps)
    timer = PhaseTimer(x0.device)
    res = solver.solve(t0, x0, variable, barrier_eps, timer=timer)
    return res, timer.durations(solver.config.max_iter + 1, FMPC_PHASES)
