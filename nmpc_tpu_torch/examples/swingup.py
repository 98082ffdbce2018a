"""Example: cart-pole swing-up with DDP, a single solve and closed-loop MPC.

Port of ``examples/swingup.py``.  Run:

    python -m nmpc_tpu_torch.examples.swingup [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

import torch

from nmpc_tpu_torch import DDPConfig, DDPSolver, DDPStatus
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.mpc.driver import run_mpc
from nmpc_tpu_torch.utils.trace import dump_ddp_trace


def main(device="cuda", dtype=torch.float32, horizon_steps=100, max_iter=50,
         mpc_horizon_steps=200, mpc_max_iter=3, end_t=5.0, trace_path=None):
    """The single solve from the hanging pose and ``end_t`` seconds of
    closed-loop MPC; prints the JAX example's lines and returns (single
    result, MPC log)."""
    problem = make_cartpole_problem(dt=0.01, input_limits=(-15.0, 15.0))
    config = DDPConfig(horizon_steps=horizon_steps, max_iter=max_iter,
                       with_input_constraint=True)
    solver = DDPSolver(problem, config)

    # one solve from the hanging pose
    x0 = torch.tensor([0.0, math.pi, 0.0, 0.0], dtype=dtype, device=device)
    res = solver.solve(0.0, x0, torch.zeros((horizon_steps, 1), dtype=dtype,
                                            device=device))
    print(f"single solve: {DDPStatus(int(res.status)).name} in "
          f"{int(res.iters)} iterations, cost {float(res.costs.sum()):.3f}, "
          f"|u|max {float(res.us.abs().max()):.2f} N")
    trace_path = trace_path or os.path.join(tempfile.gettempdir(),
                                            "swingup_trace.txt")
    dump_ddp_trace(res, trace_path)
    print(f"trace table: {trace_path}")

    # closed-loop MPC (reference pattern: solve, apply u0, shift warm start)
    mpc_solver = DDPSolver(problem, DDPConfig(
        horizon_steps=mpc_horizon_steps, max_iter=mpc_max_iter,
        with_input_constraint=True))
    log = run_mpc(mpc_solver, x0, end_t=end_t)
    xf = log.xs[-1]
    print(f"after {end_t:g} s MPC: theta={xf[1]:+.3f} rad, "
          f"omega={xf[3]:+.3f} rad/s, mean solve "
          f"{log.solve_wall_ms.mean():.1f} ms")
    return res, log


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--horizon-steps", type=int, default=100)
    ap.add_argument("--max-iter", type=int, default=50)
    ap.add_argument("--mpc-horizon-steps", type=int, default=200)
    ap.add_argument("--mpc-max-iter", type=int, default=3)
    ap.add_argument("--end-t", type=float, default=5.0)
    ap.add_argument("--trace", default=None, help="trace table path")
    a = ap.parse_args(argv)
    return dict(device=a.device, dtype=getattr(torch, a.dtype),
                horizon_steps=a.horizon_steps, max_iter=a.max_iter,
                mpc_horizon_steps=a.mpc_horizon_steps,
                mpc_max_iter=a.mpc_max_iter, end_t=a.end_t,
                trace_path=a.trace)


if __name__ == "__main__":
    main(**_args())
