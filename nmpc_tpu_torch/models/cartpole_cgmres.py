"""Cart-pole C/GMRES problem, with an optional force bound via a dummy
input.

Port of ``nmpc_tpu/models/cartpole_cgmres.py``, the family of the
reference's example (``nmpc_cgmres/tests/src/CartPoleProblem.h:11-205``):
the continuous-time cart-pole with a quadratic tracking cost; with
``with_input_bound=True`` the bound |f| <= f_max is the equality f^2 +
f_dummy^2 - f_max^2 = 0 with a multiplier mu, uc = (f, f_dummy, mu)
(``CartPoleProblem.h:177-188``).  Parameters (m1, m2, l, f_max) = (1, 1,
1, 100), weights q = (10, 100, 1, 10), r = (10, 0.01), sf = (100, 300,
1, 10) (``CartPoleProblem.h:44-55``).  The costate and dH/du come from
``torch.func.grad`` of the Hamiltonian; the weight tensors are made once
per (device, dtype).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from nmpc_tpu_torch.core.problem import ContinuousProblem

G = 9.80665
M1, M2, L, F_MAX = 1.0, 1.0, 1.0, 100.0
Q = (10.0, 100.0, 1.0, 10.0)
R = (10.0, 0.01)
SF = (100.0, 300.0, 1.0, 10.0)


def _xdot(t, x, u):
    theta, dx, dtheta = x[1], x[2], x[3]
    f = u[0]
    s, c = torch.sin(theta), torch.cos(theta)
    denom = M1 + M2 * s**2
    return torch.stack([
        dx,
        dtheta,
        (f - M2 * L * dtheta**2 * s + M2 * G * s * c) / denom,
        (f * c - M2 * L * dtheta**2 * s * c + G * (M1 + M2) * s)
        / (L * denom),
    ])


def make_cartpole_cgmres_problem(
    with_input_bound: bool = False,
    ref_func: Optional[Callable] = None,
) -> ContinuousProblem:
    """The cart-pole about ``ref_func(t)`` (a [4] state reference, zero
    by default), with the dummy-input force bound if asked."""
    consts = {}

    def consts_like(x):
        key = (x.device, x.dtype)
        if key not in consts:
            consts[key] = tuple(torch.tensor(v, dtype=x.dtype,
                                             device=x.device)
                                for v in (Q, SF, (0.0,) * 4))
        return consts[key]

    def delta(t, x):
        _, _, zero = consts_like(x)
        if ref_func is None:
            return x - zero
        return x - torch.as_tensor(ref_func(t), dtype=x.dtype,
                                   device=x.device)

    if with_input_bound:
        dim_u, dim_c = 2, 1
        u_initial = (0.0, 1.0, 0.01)

        def running_cost(t, x, uc):
            q, _, _ = consts_like(x)
            return (0.5 * (torch.sum(q * delta(t, x)**2) + R[0] * uc[0] ** 2)
                    - R[1] * uc[1])

        def eq_const(t, x, uc):
            return torch.stack([uc[0] ** 2 + uc[1] ** 2 - F_MAX**2])
    else:
        dim_u, dim_c = 1, 0
        u_initial = (0.0,)

        def running_cost(t, x, uc):
            q, _, _ = consts_like(x)
            return 0.5 * (torch.sum(q * delta(t, x)**2) + R[0] * uc[0] ** 2)

        eq_const = None

    def terminal_cost(t, x):
        _, sf, _ = consts_like(x)
        return 0.5 * torch.sum(sf * delta(t, x)**2)

    return ContinuousProblem(
        dim_x=4,
        dim_u=dim_u,
        dim_c=dim_c,
        state_eq=_xdot,
        running_cost=running_cost,
        terminal_cost=terminal_cost,
        eq_const=eq_const,
        x_initial=(0.0, math.pi, 0.0, 0.0),
        u_initial=u_initial,
    )
