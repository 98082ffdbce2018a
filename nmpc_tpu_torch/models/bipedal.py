"""Bipedal CoM-ZMP tracking problem (LTV, 2 states, 1 input).

Port of ``nmpc_tpu/models/bipedal.py``, the family of the reference's DDP
bipedal example (``nmpc_ddp/tests/src/TestDDPBipedal.cpp:16-144``): linear
time-varying CoM-ZMP dynamics x = [CoM_pos, CoM_vel], u = [ZMP], with a
time-varying pendulum frequency omega^2(t) and a reference ZMP
trajectory.

The time functions take a tensor ``t`` (a stage time, batched under
``torch.func.vmap`` in the derivative sweep) and keep its dtype; the
footstep index goes through an int cast that only ``t`` reaches, so no
derivative passes through it.  ``kernels/tileval.py`` does not generate
code for the clamp and the integer ops, so on the card the solver serves
this problem on the sweep-fed backward kernels (K1, K2 or K3) and the
plain rollouts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from nmpc_tpu_torch.core.problem import Problem

GRAVITY = 9.80665


@dataclasses.dataclass(frozen=True)
class BipedalCostWeight:
    """(``TestDDPBipedal.cpp:19-27``)."""

    running_vel: float = 1e-14
    running_zmp: float = 1e-1
    terminal_pos: float = 1e2
    terminal_vel: float = 1.0


def make_bipedal_problem(
    dt: float,
    ref_zmp_func: Callable,
    omega2_func: Callable,
    cost_weight: BipedalCostWeight = BipedalCostWeight(),
) -> Problem:
    """Discrete LTV dynamics (``TestDDPBipedal.cpp:127-144``):
    A = [[1 + dt^2 w2 / 2, dt], [dt w2, 1]], B = [-dt^2 w2 / 2, -dt w2]."""
    w = cost_weight

    def dynamics(t, x, u):
        w2 = omega2_func(t)
        a00 = 1.0 + 0.5 * dt * dt * w2
        x0 = a00 * x[0] + dt * x[1] - 0.5 * dt * dt * w2 * u[0]
        x1 = dt * w2 * x[0] + x[1] - dt * w2 * u[0]
        return torch.stack([x0, x1])

    def running_cost(t, x, u):
        return (w.running_vel * 0.5 * x[1] ** 2
                + w.running_zmp * 0.5 * (u[0] - ref_zmp_func(t)) ** 2)

    def terminal_cost(t, x):
        return (w.terminal_pos * 0.5 * (x[0] - ref_zmp_func(t)) ** 2
                + w.terminal_vel * 0.5 * x[1] ** 2)

    return Problem(
        dt=dt,
        state_dim=2,
        input_dim=1,
        dynamics=dynamics,
        running_cost=running_cost,
        terminal_cost=terminal_cost,
    )


def min_jerk(s):
    """Min-jerk interpolation (0,0)->(1,1) (``TestDDPBipedal.cpp:153-163``)."""
    return 6.0 * s**5 - 15.0 * s**4 + 10.0 * s**3


def min_jerk_second_deriv(s):
    return 120.0 * s**3 - 180.0 * s**2 + 60.0 * s


def example_ref_zmp_func(end_t: float, epsilon_t: float = 1e-6):
    """Alternating +-0.15 m footsteps (``TestDDPBipedal.cpp:170-189``)."""

    def f(t):
        t = t + epsilon_t
        mid = torch.floor(t - 1.0).to(torch.int32) % 2 == 0
        step = torch.where(mid, torch.full_like(t, 0.15),
                           torch.full_like(t, -0.15))
        return torch.where((t <= 1.5) | (t >= end_t - 1.5), 0.0, step)

    return f


def example_omega2_func(epsilon_t: float = 1e-6):
    """CoM-height squat profile -> omega^2 (``TestDDPBipedal.cpp:190-219``)."""
    z_high, z_low = 1.0, 0.3

    def f(t):
        t = t + epsilon_t
        down = torch.clamp(t - 7.0, 0.0, 1.0)
        up = torch.clamp(t - 12.0, 0.0, 1.0)
        z = (z_high + (z_low - z_high) * min_jerk(down)
             + (z_high - z_low) * min_jerk(up))
        acc = torch.where(
            (t >= 7.0) & (t < 8.0),
            (z_low - z_high) * min_jerk_second_deriv(down),
            torch.where(
                (t >= 12.0) & (t < 13.0),
                (z_high - z_low) * min_jerk_second_deriv(up),
                0.0,
            ),
        )
        return (acc + GRAVITY) / z

    return f
