"""Centroidal jump MPC: the reference's multi-phase scenario.

Port of ``examples/centroidal_jump.py``, itself the reference's
``TestDDPCentroidalMotion.cpp:238-331`` (SolveMpc): stance at x=0 until
1.4 s, flight 1.4-1.6 s (every input masked), landing stance at x=0.5
after; the CoM reference steps from (0,0,1) to (0.5,0,1) at 1.5 s.  The
first solve runs with the default iteration budget (max_iter 500), every
later warm-started solve is capped at max_iter 3, and a result file in the
reference's column layout (plus the first solve's trace table) is written
for its plotting workflow.  Run:

    python -m nmpc_tpu_torch.examples.centroidal_jump [--end-t 3.0]
        [--profile] [--out FILE] [--device cpu]

``--profile`` times each MPC step's solve phases with
``utils/profiled.py`` (the phase timer inside the solver: CUDA events on
the card) and fills the duration columns the reference measures with
std::chrono (``DDPSolver.h:219-247``); Q/reg/gain come from
``estimate_backward_split``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from nmpc_tpu_torch import DDPConfig, DDPSolver
from nmpc_tpu_torch.models.centroidal import (example_ref_pos_func,
                                              example_stance_func,
                                              make_centroidal_problem)
from nmpc_tpu_torch.mpc.driver import shift_warm_start
from nmpc_tpu_torch.utils.profiled import (estimate_backward_split,
                                           profiled_solve_ddp)
from nmpc_tpu_torch.utils.trace import dump_ddp_trace

COLUMNS = (
    "time pos_x pos_y pos_z linear_momentum_x linear_momentum_y "
    "linear_momentum_z angular_momentum_x angular_momentum_y "
    "angular_momentum_z force_x force_y force_z ref_pos_x ref_pos_y "
    "ref_pos_z iter duration_setup duration_opt duration_derivative "
    "duration_backward duration_forward duration_Q_est duration_reg_est "
    "duration_gain_est"
)


def _tmp(name):
    return os.path.join(tempfile.gettempdir(), name)


def run(end_t: float = 3.0, dt: float = 0.03, horizon_duration: float = 3.0,
        out_path: str = None, trace_path: str = None, profile: bool = False,
        device="cuda", max_steps: int = None):
    """Run the jump scenario (fp64); returns (rows, per-step planned-pos
    errors, final state).  ``max_steps`` stops after that many MPC steps.

    Each row is the reference's dump line; the per-step assertion
    ``(planned_pos - ref_pos).norm() < 1.0``
    (``TestDDPCentroidalMotion.cpp:318``) is left to the caller.
    """
    out_path = out_path or _tmp("TestDDPCentroidalMotionResult.txt")
    trace_path = trace_path or _tmp("TestDDPCentroidalMotionTraceData.txt")
    horizon_steps = int(horizon_duration / dt)
    problem = make_centroidal_problem(dt)
    ref_pos = example_ref_pos_func()
    _, ridges_f, mask_f = example_stance_func()
    f64 = dict(dtype=torch.float64, device=device)

    # reference pattern: first solve uncapped, then max_iter = 3
    # (TestDDPCentroidalMotion.cpp:312-316)
    solver_init = DDPSolver(problem, DDPConfig(horizon_steps=horizon_steps,
                                               max_iter=500))
    solver_mpc = DDPSolver(problem, DDPConfig(horizon_steps=horizon_steps,
                                              max_iter=3))

    split = None
    t = 0.0
    x = torch.cat([torch.tensor([0.0, 0.0, 1.0], **f64), torch.zeros(6, **f64)])
    us = torch.zeros((horizon_steps, problem.input_dim), **f64)

    rows, pos_errs = [], []
    first = True
    while t < end_t and (max_steps is None or len(rows) < max_steps):
        solver = solver_init if first else solver_mpc
        if profile:
            res, dur, cd = profiled_solve_ddp(solver, t, x, us,
                                              warmup=first)
            if split is None:
                split = estimate_backward_split(solver, t, x, us)
            durs = (cd.setup, cd.opt, cd.derivative, cd.backward, cd.forward,
                    split["Q"], split["reg"], split["gain"])
        else:
            start = time.perf_counter()
            res = solver.solve(t, x, us)
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
            solve_ms = 1e3 * (time.perf_counter() - start)
            durs = (0.0, solve_ms, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

        if first:
            first = False
            dump_ddp_trace(res, trace_path,
                           durations=dur if profile else None)

        t_ = torch.tensor(t, **f64)
        planned_pos = res.xs[0][:3].cpu().numpy()
        ref = ref_pos(t_).cpu().numpy()
        pos_errs.append(float(np.linalg.norm(planned_pos - ref)))

        u0 = res.us[0] * mask_f(t_).to(res.us.dtype)
        force = (ridges_f(t_).T @ u0).cpu().numpy()           # [3]
        rows.append((t, *x.cpu().numpy(), *force, *ref, int(res.iters),
                     *durs))

        # plant step with the planned input + shift warm start
        x = problem.dynamics(t_, x, res.us[0])
        us = shift_warm_start(problem, t + dt, res.us)
        t += dt

    with open(out_path, "w") as f:
        f.write(COLUMNS + "\n")
        # Provenance marker (np.loadtxt and gnuplot skip '#' lines): the
        # *_est columns are shape-representative estimates from
        # utils/profiled.estimate_backward_split, not in-loop measurements.
        f.write("# duration_{Q,reg,gain}_est: shape-representative estimates"
                " (utils/profiled.estimate_backward_split); other durations"
                " are measured stage times\n")
        for row in rows:
            f.write(" ".join(f"{float(v):.10g}" if not isinstance(v, int)
                             else str(v) for v in row) + "\n")
    return rows, pos_errs, x.cpu().numpy()


def main(end_t=3.0, horizon_duration=3.0, max_steps=None, profile=False,
         out_path=None, trace_path=None, device="cuda"):
    """:func:`run`, then the JAX example's summary lines; returns what
    :func:`run` returns."""
    out_path = out_path or _tmp("TestDDPCentroidalMotionResult.txt")
    rows, pos_errs, xf = run(end_t=end_t, horizon_duration=horizon_duration,
                             out_path=out_path, trace_path=trace_path,
                             profile=profile, device=device,
                             max_steps=max_steps)
    ref = example_ref_pos_func()(torch.tensor(end_t,
                                              dtype=torch.float64)).numpy()
    print(f"steps={len(rows)} max_step_pos_err={max(pos_errs):.3f} "
          f"final_pos_err={np.linalg.norm(xf[:3] - ref):.4f}")
    print(f"result written to {out_path}")
    return rows, pos_errs, xf


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--end-t", type=float, default=3.0)
    ap.add_argument("--horizon-duration", type=float, default=3.0)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return dict(end_t=a.end_t, horizon_duration=a.horizon_duration,
                max_steps=a.max_steps, profile=a.profile, out_path=a.out,
                trace_path=a.trace, device=a.device)


if __name__ == "__main__":
    main(**_args())
