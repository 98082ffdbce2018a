"""Example: constrained NMPC with the FMPC (interior-point) solver.

Port of ``examples/constrained.py``: the Van der Pol oscillator with state
and input constraints; every MPC step satisfies g <= 0 strictly (interior
point, unlike clamping).  Run:

    python -m nmpc_tpu_torch.examples.constrained [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from nmpc_tpu_torch import FmpcConfig, FmpcSolver, fmpc_variable_reset
from nmpc_tpu_torch.models.oscillator import make_oscillator_problem


def main(device="cuda", dtype=torch.float32, horizon_steps=200, max_iter=5,
         n_steps=400):
    """``n_steps`` MPC steps of 0.01 s; prints the JAX example's line and
    returns (final x, worst constraint value)."""
    problem = make_oscillator_problem(dt=0.01)
    solver = FmpcSolver(problem, FmpcConfig(horizon_steps=horizon_steps,
                                            max_iter=max_iter))

    var = fmpc_variable_reset(horizon_steps, 2, 1, 3, dtype=dtype,
                              device=device)
    x = torch.tensor([0.0, 1.0], dtype=dtype, device=device)
    t, eps = 0.0, 1e-4
    worst_g = -np.inf
    for _ in range(n_steps):
        res = solver.solve(t, x, var, eps)
        u = res.variable.us[0]
        t_ = torch.tensor(t, dtype=dtype, device=device)
        g = problem.ineq_const(t_, x, u)
        worst_g = max(worst_g, float(g.max()))
        x = problem.dynamics(t_, x, u)
        t += 0.01
        var, eps = res.variable, res.barrier_eps
    xf = x.cpu().numpy()
    print(f"final x = {np.round(xf, 4)}, worst constraint value over "
          f"{n_steps * 0.01:g} s: {worst_g:+.2e} (feasible: {worst_g <= 0})")
    return xf, worst_g


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--horizon-steps", type=int, default=200)
    ap.add_argument("--max-iter", type=int, default=5)
    ap.add_argument("--n-steps", type=int, default=400)
    a = ap.parse_args(argv)
    return dict(device=a.device, dtype=getattr(torch, a.dtype),
                horizon_steps=a.horizon_steps, max_iter=a.max_iter,
                n_steps=a.n_steps)


if __name__ == "__main__":
    main(**_args())
