"""Cart-pole swing-up problem (port of ``nmpc_tpu/models/cartpole.py``).

State x = [pos, theta, vel, omega]; input u = [force].  theta = pi is the
hanging pose, theta = 0 upright (reference ``TestDDPCartPole.cpp:28-234``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from nmpc_tpu_torch.core.problem import Problem

GRAVITY = 9.80665  # [m/s^2]


@dataclasses.dataclass(frozen=True)
class CartPoleParam:
    """Plant parameters (``TestDDPCartPole.cpp:33-38``)."""

    cart_mass: float = 1.0    # [kg]
    pole_mass: float = 0.5    # [kg]
    pole_length: float = 2.0  # [m]


@dataclasses.dataclass(frozen=True)
class CartPoleCostWeight:
    """Quadratic cost weights (``TestDDPCartPole.cpp:40-52``)."""

    running_x: tuple = (0.1, 1.0, 0.01, 0.1)
    running_u: tuple = (0.001,)
    terminal_x: tuple = (0.1, 1.0, 0.01, 0.1)


def cartpole_xdot(param: CartPoleParam, x, u):
    """Continuous dynamics (``TestDDPCartPole.cpp:68-98``)."""
    theta, vel, omega = x[1], x[2], x[3]
    f = u[0]
    m1, m2, l = param.cart_mass, param.pole_mass, param.pole_length
    s, c = torch.sin(theta), torch.cos(theta)
    denom = m1 + m2 * s**2
    acc = (f - m2 * l * omega**2 * s + m2 * GRAVITY * s * c) / denom
    ang_acc = (f * c - m2 * l * omega**2 * s * c
               + GRAVITY * (m1 + m2) * s) / (l * denom)
    return torch.stack([vel, omega, acc, ang_acc])


def make_cartpole_problem(
    dt: float,
    ref_pos_func: Optional[Callable] = None,
    param: CartPoleParam = CartPoleParam(),
    cost_weight: CartPoleCostWeight = CartPoleCostWeight(),
    input_limits: Optional[tuple] = None,
) -> Problem:
    """Discrete-time cart-pole (forward Euler, like the reference's
    ``stateEq``: x + dt * xdot).  ``input_limits=(lo, hi)`` is carried for
    the boxed solve, which is not ported yet."""
    if ref_pos_func is None:
        ref_pos_func = lambda t: 0.0

    # Weight tensors are made once per (device, dtype): building them from
    # Python lists on every call would copy host -> device each time.
    weights = {}

    def weights_like(x):
        key = (x.device, x.dtype)
        if key not in weights:
            weights[key] = tuple(
                torch.tensor(w, dtype=x.dtype, device=x.device)
                for w in (cost_weight.running_x, cost_weight.running_u,
                          cost_weight.terminal_x))
        return weights[key]

    def dynamics(t, x, u):
        return x + dt * cartpole_xdot(param, x, u)

    def delta_x(t, x):
        z = torch.zeros_like(x[0])
        return x - torch.stack([z + ref_pos_func(t), z, z, z])

    def running_cost(t, x, u):
        wrx, wru, _ = weights_like(x)
        dx = delta_x(t, x)
        return (0.5 * torch.sum(wrx * dx**2)
                + 0.5 * torch.sum(wru.to(u.dtype) * u**2))

    def terminal_cost(t, x):
        _, _, wtx = weights_like(x)
        dx = delta_x(t, x)
        return 0.5 * torch.sum(wtx * dx**2)

    limits_fn = None
    if input_limits is not None:
        lo, hi = input_limits
        limits_fn = lambda t: (torch.full((1,), lo), torch.full((1,), hi))

    return Problem(
        dt=dt,
        state_dim=4,
        input_dim=1,
        dynamics=dynamics,
        running_cost=running_cost,
        terminal_cost=terminal_cost,
        input_limits=limits_fn,
    )
