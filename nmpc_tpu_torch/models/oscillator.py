"""Van der Pol oscillator FMPC problem (2 states, 1 input, 3 inequalities).

Port of ``nmpc_tpu/models/oscillator.py``, the family of the reference's
FMPC oscillator example (``TestFmpcOscillator.cpp:18-135``): state- and
input-constrained stabilization with g = [-x1 - 0.05, -u - 1, u - 0.9] <= 0.
"""

from __future__ import annotations

import torch

from nmpc_tpu_torch.core.problem import Problem


def make_oscillator_problem(dt: float) -> Problem:
    def dynamics(t, x, u):
        xdot0 = (1.0 - x[1] ** 2) * x[0] - x[1] + u[0]
        return x + dt * torch.stack([xdot0, x[0]])

    def running_cost(t, x, u):
        return 0.5 * (torch.sum(x**2) + torch.sum(u**2))

    def terminal_cost(t, x):
        return torch.zeros((), dtype=x.dtype, device=x.device)

    def ineq_const(t, x, u):
        return torch.stack([-x[1] - 0.05, -u[0] - 1.0, u[0] - 0.9])

    return Problem(
        dt=dt,
        state_dim=2,
        input_dim=1,
        dynamics=dynamics,
        running_cost=running_cost,
        terminal_cost=terminal_cost,
        ineq_dim=3,
        ineq_const=ineq_const,
    )
