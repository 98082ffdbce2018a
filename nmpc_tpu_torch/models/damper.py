"""Semiactive damper C/GMRES problem (2 states, 2 inputs + 1 multiplier).

Port of ``nmpc_tpu/models/damper.py``, the family of the reference's
example (``nmpc_cgmres/tests/src/SemiactiveDamperProblem.h:10-109``): a
damper whose input bound is encoded with a dummy input u2 and an
equality-constraint multiplier mu, so that the augmented input is uc =
(u1, u2, mu), dim_uc = 3 (``CgmresProblem.h:57-60``).

Dynamics: xdot = [x2, a x1 + b x2 u1], a = b = -1, u_max = 1.
Constraint: (u1 - u_max/2)^2 + u2^2 - (u_max/2)^2 = 0 (u1 in [0, u_max]).
Cost: 0.5 (q1 x1^2 + q2 x2^2 + r1 u1^2) - r2 u2, terminal 0.5 (sf1 x1^2 +
sf2 x2^2).

``analytic=True`` gives the reference's hand-derived costate, dH/du and
dphi/dx; the default derives them by ``torch.func.grad`` of the
Hamiltonian.  Every constant is a Python float, so the callables run on
the device and dtype of the tensors they are given.
"""

from __future__ import annotations

import torch

from nmpc_tpu_torch.core.problem import ContinuousProblem

A_PARAM = -1.0
B_PARAM = -1.0
U_MAX = 1.0
Q1, Q2, R1, R2 = 1.0, 10.0, 1.0, 1e-1
SF1, SF2 = 1.0, 10.0

X_INITIAL = (2.0, 0.0)
U_INITIAL = (0.01, 0.9, 0.03)


def _state_eq(t, x, u):
    return torch.stack([x[1], A_PARAM * x[0] + B_PARAM * x[1] * u[0]])


def _running_cost(t, x, uc):
    return (0.5 * (Q1 * x[0] ** 2 + Q2 * x[1] ** 2 + R1 * uc[0] ** 2)
            - R2 * uc[1])


def _terminal_cost(t, x):
    return 0.5 * (SF1 * x[0] ** 2 + SF2 * x[1] ** 2)


def _eq_const(t, x, uc):
    return torch.stack([(uc[0] - U_MAX / 2.0) ** 2 + uc[1] ** 2
                        - (U_MAX / 2.0) ** 2])


def _costate_eq(t, lmd, x, uc):
    """Hand-derived costate (``SemiactiveDamperProblem.h:51-67``)."""
    return torch.stack([
        -A_PARAM * lmd[1] - Q1 * x[0],
        -B_PARAM * lmd[1] * uc[0] - Q2 * x[1] - lmd[0],
    ])


def _dh_du(t, x, uc, lmd):
    """Hand-derived dH/du (``SemiactiveDamperProblem.h:86-103``)."""
    mu = uc[2]
    return torch.stack([
        R1 * uc[0] + B_PARAM * lmd[1] * x[1] + mu * (2.0 * uc[0] - U_MAX),
        -R2 + 2.0 * mu * uc[1],
        (uc[0] - U_MAX / 2.0) ** 2 + uc[1] ** 2 - (U_MAX / 2.0) ** 2,
    ])


def _dphi_dx(t, x):
    return torch.stack([SF1 * x[0], SF2 * x[1]])


def make_damper_problem(analytic: bool = False) -> ContinuousProblem:
    """``analytic=True`` uses the reference's hand-derived costate, dH/du
    and dphi/dx; the default derives them from the Hamiltonian."""
    return ContinuousProblem(
        dim_x=2,
        dim_u=2,
        dim_c=1,
        state_eq=_state_eq,
        running_cost=_running_cost,
        terminal_cost=_terminal_cost,
        eq_const=_eq_const,
        costate_eq=_costate_eq if analytic else None,
        dh_du=_dh_du if analytic else None,
        dphi_dx=_dphi_dx if analytic else None,
        x_initial=X_INITIAL,
        u_initial=U_INITIAL,
    )
