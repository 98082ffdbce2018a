"""Centroidal motion problem (9 states, up to 16 friction-pyramid forces).

Port of ``nmpc_tpu/models/centroidal.py``, the family of the reference's
DDP centroidal example (``nmpc_ddp/tests/src/TestDDPCentroidalMotion.cpp:
24-204``): the state x = [CoM, linear momentum, angular momentum], the
inputs force magnitudes along friction-pyramid ridges at the contact
vertices; the stance (and with it the input dimension: 16 in stance, 0
in flight) changes over time.

As in the JAX package the input is padded to 16 with an all-on / all-off
mask, and the stance geometry (vertices and ridges, [16, 3] each) and the
mask are functions of a tensor t (``torch.where`` on it), so that they
batch over the stages under ``torch.func.vmap``.  Their constants are
made once per (device, dtype) of the t they are given.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from nmpc_tpu_torch.core.problem import Problem

GRAVITY_VEC = (0.0, 0.0, 9.80665)
MASS = 100.0  # [kg] (TestDDPCentroidalMotion.cpp:203)
NUM_RIDGES = 16


@dataclasses.dataclass(frozen=True)
class CentroidalCostWeight:
    """(``TestDDPCentroidalMotion.cpp:40-50``)."""

    running_pos: float = 1.0
    running_momentum: float = 0.0
    running_angular: float = 1.0
    running_u: float = 1e-6
    terminal_pos: float = 1.0
    terminal_momentum: float = 0.0
    terminal_angular: float = 1.0


def rect_stance(center_x, center_y=0.0, half_x=0.1, half_y=0.1):
    """The 16-column stance of a rectangle's 4 vertices x 4 pyramid ridges
    (``makeStanceDataFromRect``, ``TestDDPCentroidalMotion.cpp:206-237``):
    (vertices [16, 3], ridges [16, 3]), float64."""
    f64 = torch.float64
    vs = torch.tensor([
        [-half_x, -half_y, 0.0],
        [-half_x, half_y, 0.0],
        [half_x, half_y, 0.0],
        [half_x, -half_y, 0.0],
    ], dtype=f64) + torch.tensor([center_x, center_y, 0.0], dtype=f64)
    angles = 2.0 * math.pi * torch.arange(4, dtype=f64) / 4.0
    ridges = torch.stack([0.5 * torch.cos(angles), 0.5 * torch.sin(angles),
                          torch.ones(4, dtype=f64)], dim=-1)
    ridges = ridges / torch.linalg.norm(ridges, dim=-1, keepdim=True)
    return vs.repeat_interleave(4, dim=0), ridges.repeat(4, 1)


def _as_time(t):
    return t if isinstance(t, torch.Tensor) else torch.tensor(
        t, dtype=torch.float64)


def example_stance_func(epsilon_t: float = 1e-6):
    """The reference's stance schedule (``TestDDPCentroidalMotion.cpp:
    246-267``): stance at x = 0 until 1.4 s, flight 1.4-1.6 s, stance at x
    = 0.5 after.  Returns (vertices(t), ridges(t), mask(t)) in t's dtype
    and device."""
    stances = (rect_stance(0.0), rect_stance(0.5))
    made = {}

    def consts(t):
        key = (t.device, t.dtype)
        if key not in made:
            made[key] = tuple(a.to(device=t.device, dtype=t.dtype)
                              for pair in stances for a in pair)
        return made[key]

    def vertices(t):
        t = _as_time(t)
        v0, _, v1, _ = consts(t)
        return torch.where(t + epsilon_t < 1.4, v0, v1)

    def ridges(t):
        t = _as_time(t)
        _, r0, _, r1 = consts(t)
        return torch.where(t + epsilon_t < 1.4, r0, r1)

    def mask(t):
        t = _as_time(t) + epsilon_t
        in_flight = (t >= 1.4) & (t < 1.6)
        return torch.logical_not(in_flight).expand(NUM_RIDGES)

    return vertices, ridges, mask


def example_ref_pos_func(epsilon_t: float = 1e-6):
    """The CoM reference (``TestDDPCentroidalMotion.cpp:268-279``): x = 0
    until 1.5 s, then 0.5; y = 0, z = 1."""

    def f(t):
        t = _as_time(t) + epsilon_t
        zero = torch.zeros_like(t)
        return torch.stack([torch.where(t < 1.5, zero, zero + 0.5), zero,
                            zero + 1.0])

    return f


def make_centroidal_problem(
    dt: float,
    stance_funcs=None,
    ref_pos_func: Optional[Callable] = None,
    cost_weight: CentroidalCostWeight = CentroidalCostWeight(),
    force_limits: Optional[tuple] = None,
) -> Problem:
    """xdot = [p / m, R u - m g, sum_i u_i (v_i - c) x r_i]
    (``TestDDPCentroidalMotion.cpp:70-93``), discretized by forward Euler.

    ``force_limits=(lo, hi)`` bounds every ridge force for a boxed solve
    (``with_input_constraint=True``): the unilateral-contact bound 0 <= u_i
    <= f_max.  The boxed kernels take nu <= 4, so a boxed solve runs the
    plain BoxQP (``solvers/ddp.py::_resolve_backward_impl``), as on the
    TPU; an unboxed one runs the sweep-fed kernel K1 on the card."""
    if stance_funcs is None:
        stance_funcs = example_stance_func()
    vertices_f, ridges_f, mask_f = stance_funcs
    if ref_pos_func is None:
        ref_pos_func = example_ref_pos_func()

    w = cost_weight
    weights = {}

    def consts(x):
        key = (x.device, x.dtype)
        if key not in weights:
            weights[key] = tuple(
                torch.tensor(v, dtype=x.dtype, device=x.device) for v in (
                    (w.running_pos,) * 3 + (w.running_momentum,) * 3
                    + (w.running_angular,) * 3,
                    (w.terminal_pos,) * 3 + (w.terminal_momentum,) * 3
                    + (w.terminal_angular,) * 3,
                    GRAVITY_VEC))
        return weights[key]

    def dynamics(t, x, u):
        _, _, gvec = consts(x)
        um = u * mask_f(t).to(x.dtype)
        V = vertices_f(t).to(x.dtype)      # [16, 3]
        R = ridges_f(t).to(x.dtype)        # [16, 3]
        com, lin = x[:3], x[3:6]
        lin_dot = R.T @ um - MASS * gvec
        ang_dot = torch.sum(um[:, None] * torch.linalg.cross(
            V - com[None, :], R, dim=-1), dim=0)
        return x + dt * torch.cat([lin / MASS, lin_dot, ang_dot])

    def diff(t, x):
        ref = ref_pos_func(t).to(x.dtype)
        return torch.cat([x[:3] - ref, x[3:]])

    def running_cost(t, x, u):
        wx, _, _ = consts(x)
        return (0.5 * torch.sum(wx * diff(t, x)**2)
                + 0.5 * w.running_u * torch.sum(u**2))

    def terminal_cost(t, x):
        _, wtx, _ = consts(x)
        return 0.5 * torch.sum(wtx * diff(t, x)**2)

    limits_fn = None
    if force_limits is not None:
        lo, hi = force_limits
        limits_fn = lambda t: (torch.full((NUM_RIDGES,), lo),
                               torch.full((NUM_RIDGES,), hi))

    return Problem(
        dt=dt,
        state_dim=9,
        input_dim=NUM_RIDGES,
        dynamics=dynamics,
        running_cost=running_cost,
        terminal_cost=terminal_cost,
        input_mask=mask_f,
        input_limits=limits_fn,
    )
