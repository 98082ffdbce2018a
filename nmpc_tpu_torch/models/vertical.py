"""Vertical-motion problem: time-varying input dimension and box limits.

Port of ``nmpc_tpu/models/vertical.py``, the family of the reference's DDP
vertical-motion example (``TestDDPVerticalMotion.cpp:31-234``): a point
mass moving vertically under gravity, pushed by 0..2 contact forces
depending on time (contact switches), each force bounded to [0, 30] N.

The reference's input dimension varies with time (``inputDim(t)`` is
0/1/2, ``TestDDPVerticalMotion.cpp:58-75``); here the input is padded to 2
with an active mask, as in the JAX package.  Every callable is written in
torch ops that ``kernels/tileval.py`` generates code for: the mask is a
stack of comparisons (``arange(2) < n`` in the JAX model).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from nmpc_tpu_torch.core.problem import Problem

GRAVITY = 9.80665
MASS = 1.0  # [kg] (TestDDPVerticalMotion.cpp:232)
MAX_CONTACTS = 2


@dataclasses.dataclass(frozen=True)
class VerticalCostWeight:
    """(``TestDDPVerticalMotion.cpp:34-46``)."""

    running_x: tuple = (1.0, 1e-3)
    running_u: float = 1e-4
    terminal_x: tuple = (1.0, 1e-3)


def num_contacts(t, epsilon_t: float = 1e-6):
    """Active contact count over time (``TestDDPVerticalMotion.cpp:58-75``):
    2 for 2 < t < 3, 0 for 4.5 < t < 5, else 1."""
    t = t + epsilon_t
    return torch.where((2.0 < t) & (t < 3.0), 2,
                       torch.where((4.5 < t) & (t < 5.0), 0, 1))


def input_mask(t):
    """Contact i is active while i < num_contacts(t)."""
    n = num_contacts(t)
    return torch.stack([n > i for i in range(MAX_CONTACTS)])


def make_vertical_problem(
    dt: float,
    ref_pos_func: Optional[Callable] = None,
    cost_weight: VerticalCostWeight = VerticalCostWeight(),
    force_limits: tuple = (0.0, 30.0),
    with_limits: bool = True,
) -> Problem:
    """x = [pos_z, vel_z]; x' = x + dt [vel, sum(u)/m - g]
    (``TestDDPVerticalMotion.cpp:77-85``)."""
    if ref_pos_func is None:
        # 1 m until t = 8 s, then 0 m (TestDDPVerticalMotion.cpp:246-258)
        ref_pos_func = lambda t: torch.where(t + 1e-6 < 8.0, 1.0, 0.0)

    # weight tensors once per (device, dtype), as in the cart-pole
    weights = {}

    def weights_like(x):
        key = (x.device, x.dtype)
        if key not in weights:
            weights[key] = tuple(
                torch.tensor(w, dtype=x.dtype, device=x.device)
                for w in (cost_weight.running_x, cost_weight.terminal_x))
        return weights[key]

    def delta_x(t, x):
        ref = torch.as_tensor(ref_pos_func(t), dtype=x.dtype,
                              device=x.device)
        return x - torch.stack([ref, torch.zeros_like(ref)])

    def dynamics(t, x, u):
        return x + dt * torch.stack([x[1], torch.sum(u) / MASS - GRAVITY])

    def running_cost(t, x, u):
        wrx, _ = weights_like(x)
        # inactive (masked) inputs are held at zero by the solver, so the
        # padded input term equals the variable-dimension one
        return (0.5 * torch.sum(wrx * delta_x(t, x)**2)
                + 0.5 * cost_weight.running_u * torch.sum(u**2))

    def terminal_cost(t, x):
        _, wtx = weights_like(x)
        return 0.5 * torch.sum(wtx * delta_x(t, x)**2)

    limits_fn = None
    if with_limits:
        lo, hi = force_limits
        limits_fn = lambda t: (torch.full((MAX_CONTACTS,), lo),
                               torch.full((MAX_CONTACTS,), hi))

    return Problem(
        dt=dt,
        state_dim=2,
        input_dim=MAX_CONTACTS,
        dynamics=dynamics,
        running_cost=running_cost,
        terminal_cost=terminal_cost,
        input_mask=input_mask,
        input_limits=limits_fn,
    )
