"""Example: a fleet of 4096 MPC controllers on one card.

Port of ``examples/fleet.py``.  Every controller runs a receding-horizon
loop on the device (solve -> apply -> shift), batched through the kernels.
Run:

    python -m nmpc_tpu_torch.examples.fleet [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from nmpc_tpu_torch import DDPConfig, DDPSolver
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.mpc.closed_loop import make_closed_loop_batch


def main(device="cuda", batch=4096, n_steps=100, horizon_steps=100,
         max_iter=3):
    """``batch`` cart-pole controllers, ``n_steps`` ticks, fp32; prints the
    JAX example's lines and returns (log, wall seconds).  A one-tick run
    first builds the kernels (the JAX example's compile run)."""
    problem = make_cartpole_problem(dt=0.01)
    solver = DDPSolver(problem, DDPConfig(horizon_steps=horizon_steps,
                                          max_iter=max_iter))
    B = batch

    rng = np.random.default_rng(0)
    x0s = torch.as_tensor((np.tile([0.0, math.pi, 0.0, 0.0], (B, 1))
                           + 0.2 * rng.normal(size=(B, 4))).astype(np.float32),
                          device=device)
    us0 = torch.zeros((B, horizon_steps, 1), dtype=torch.float32,
                      device=device)
    t0 = torch.tensor(0.0, dtype=torch.float32, device=device)

    make_closed_loop_batch(solver, n_steps=1)(t0, x0s, us0)   # build
    sim = make_closed_loop_batch(solver, n_steps=n_steps)
    if x0s.device.type == "cuda":
        torch.cuda.synchronize(x0s.device)
    start = time.perf_counter()
    log = sim(t0, x0s, us0)
    if x0s.device.type == "cuda":
        torch.cuda.synchronize(x0s.device)
    wall = time.perf_counter() - start

    thetas = np.abs(((log.xs[:, -1, 1].cpu().numpy() + np.pi) % (2 * np.pi))
                    - np.pi)
    print(f"{B} controllers x {n_steps} MPC ticks in {wall:.2f} s "
          f"({B * n_steps / wall:,.0f} controller-ticks/s)")
    print(f"upright after {n_steps * problem.dt:g} s: "
          f"{(thetas < 0.5).mean() * 100:.1f}% of fleet")
    return log, wall


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--n-steps", type=int, default=100)
    ap.add_argument("--horizon-steps", type=int, default=100)
    ap.add_argument("--max-iter", type=int, default=3)
    a = ap.parse_args(argv)
    return dict(device=a.device, batch=a.batch, n_steps=a.n_steps,
                horizon_steps=a.horizon_steps, max_iter=a.max_iter)


if __name__ == "__main__":
    main(**_args())
