"""Optimal-control problem abstraction of the PyTorch port.

A problem is a frozen bundle of per-instance callables on tensors
(``x [nx]``, ``u [nu]``, time ``t``), as in ``nmpc_tpu/core/problem.py``.
The solver batches them with ``torch.func.vmap``.  Derivatives default to
``torch.func`` autodiff; analytic overrides replace them field by field.
Time-varying input and inequality dimensions use a static maximum plus an
``input_mask(t)`` / ``ineq_mask(t)``.  :class:`Problem` is the discrete
problem of the DDP and FMPC solvers, :class:`ContinuousProblem` the
continuous one of C/GMRES.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import func


@dataclasses.dataclass(frozen=True)
class Problem:
    """Discrete-time optimal control problem (reference
    ``DDPProblem.h:15``) and its FMPC extension with inequality
    constraints ``g(x, u) <= 0`` (``FmpcProblem.h:94-107``).

    Required callables:
      dynamics(t, x, u) -> x_next
      running_cost(t, x, u) -> scalar
      terminal_cost(t, x) -> scalar
    Optional:
      *_derivs               analytic derivatives; autodiff when None
      input_mask(t) -> bool[input_dim]     active-input mask
      input_limits(t) -> (lower, upper)    box bounds for constrained DDP
      ineq_const(t, x, u) -> g [ineq_dim]  (g <= 0 feasible), for FMPC
      ineq_mask(t) -> bool[ineq_dim]       active-inequality mask
    """

    dt: float
    state_dim: int
    input_dim: int
    dynamics: Callable
    running_cost: Callable
    terminal_cost: Callable
    dynamics_derivs: Optional[Callable] = None         # (t,x,u)->(Fx,Fu)
    dynamics_second_derivs: Optional[Callable] = None  # ->(Fxx,Fuu,Fxu)
    running_cost_derivs: Optional[Callable] = None     # ->(Lx,Lu,Lxx,Luu,Lxu)
    terminal_cost_derivs: Optional[Callable] = None    # (t,x)->(Vx,Vxx)
    input_mask: Optional[Callable] = None              # t->bool[input_dim]
    input_limits: Optional[Callable] = None            # t->(lower,upper)
    ineq_dim: int = 0
    ineq_const: Optional[Callable] = None              # (t,x,u)->g
    ineq_derivs: Optional[Callable] = None             # (t,x,u)->(C,D)
    ineq_mask: Optional[Callable] = None               # t->bool[ineq_dim]

    def linearize_dynamics(self, t, x, u):
        """(Fx, Fu) (reference ``DDPProblem::calcStateEqDeriv``)."""
        if self.dynamics_derivs is not None:
            return self.dynamics_derivs(t, x, u)
        return func.jacfwd(self.dynamics, argnums=(1, 2))(t, x, u)

    def second_order_dynamics(self, t, x, u):
        """(Fxx, Fuu, Fxu), rank-3 tensors [nx, ., .]."""
        if self.dynamics_second_derivs is not None:
            return self.dynamics_second_derivs(t, x, u)
        d = self.dynamics
        Fxx = func.jacfwd(func.jacfwd(d, argnums=1), argnums=1)(t, x, u)
        Fuu = func.jacfwd(func.jacfwd(d, argnums=2), argnums=2)(t, x, u)
        Fxu = func.jacfwd(func.jacfwd(d, argnums=1), argnums=2)(t, x, u)
        return Fxx, Fuu, Fxu

    def quadraticize_running_cost(self, t, x, u):
        """(Lx, Lu, Lxx, Luu, Lxu) (reference
        ``DDPProblem::calcRunningCostDeriv``)."""
        if self.running_cost_derivs is not None:
            return self.running_cost_derivs(t, x, u)
        c = self.running_cost
        Lx, Lu = func.grad(c, argnums=(1, 2))(t, x, u)
        Lxx = func.hessian(c, argnums=1)(t, x, u)
        Luu = func.hessian(c, argnums=2)(t, x, u)
        Lxu = func.jacfwd(func.grad(c, argnums=1), argnums=2)(t, x, u)
        return Lx, Lu, Lxx, Luu, Lxu

    def quadraticize_terminal_cost(self, t, x):
        """(Vx, Vxx) (reference ``DDPProblem::calcTerminalCostDeriv``)."""
        if self.terminal_cost_derivs is not None:
            return self.terminal_cost_derivs(t, x)
        return (func.grad(self.terminal_cost, argnums=1)(t, x),
                func.hessian(self.terminal_cost, argnums=1)(t, x))

    def linearize_ineq(self, t, x, u):
        """(C, D): inequality Jacobians (reference
        ``FmpcProblem::calcIneqConstDeriv``, ``FmpcProblem.h:103``)."""
        if self.ineq_derivs is not None:
            return self.ineq_derivs(t, x, u)
        return func.jacfwd(self.ineq_const, argnums=(1, 2))(t, x, u)

    def input_mask_at(self, t):
        """The active-input mask at ``t`` (all set without a mask)."""
        if self.input_mask is None:
            return torch.ones((self.input_dim,), dtype=torch.bool,
                              device=_device_of(t))
        return self.input_mask(t)

    def ineq_mask_at(self, t):
        """The active-inequality mask at ``t`` (all set without a mask)."""
        if self.ineq_mask is None:
            return torch.ones((self.ineq_dim,), dtype=torch.bool,
                              device=_device_of(t))
        return self.ineq_mask(t)


def _device_of(t):
    return t.device if isinstance(t, torch.Tensor) else None


@dataclasses.dataclass(frozen=True)
class ContinuousProblem:
    """Continuous-time optimal control problem via Pontryagin, for the
    C/GMRES solver (reference ``CgmresProblem.h:27-48``).  ``uc`` is the
    input augmented with dummy inputs and equality-constraint multipliers
    (``dim_uc = dim_u + dim_c``, ``CgmresProblem.h:57-60``).

    Required: ``state_eq(t, x, u[:dim_u]) -> dx/dt``.  Either supply the
    analytic ``costate_eq`` / ``dphi_dx`` / ``dh_du`` (the reference's
    virtuals) or ``running_cost`` / ``terminal_cost`` (and ``eq_const``
    for the multiplier block), from which ``torch.func.grad`` of the
    Hamiltonian H = L + lambda . f (+ mu . C) derives them.  Analytic
    overrides win.
    """

    dim_x: int
    dim_u: int
    dim_c: int
    state_eq: Callable                        # (t, x, u) -> xdot
    costate_eq: Optional[Callable] = None     # (t, lmd, x, uc) -> dlmd/dt
    dphi_dx: Optional[Callable] = None        # (t, x) -> [dim_x]
    dh_du: Optional[Callable] = None          # (t, x, uc, lmd) -> [dim_uc]
    running_cost: Optional[Callable] = None   # (t, x, uc) -> scalar
    terminal_cost: Optional[Callable] = None  # (t, x) -> scalar
    eq_const: Optional[Callable] = None       # (t, x, uc) -> [dim_c] (== 0)
    x_initial: Optional[tuple] = None         # [dim_x], any array-like
    u_initial: Optional[tuple] = None         # [dim_uc], any array-like

    @property
    def dim_uc(self) -> int:
        return self.dim_u + self.dim_c

    def hamiltonian(self, t, x, uc, lmd):
        """H = L(t, x, uc) + lambda . f(t, x, u) [+ mu . C(t, x, uc)]: the
        multiplier block of ``uc`` enters through ``eq_const``, as in the
        reference's dummy-input encoding
        (``SemiactiveDamperProblem.h:86-103``)."""
        u = uc[: self.dim_u]
        h = self.running_cost(t, x, uc) + lmd @ self.state_eq(t, x, u)
        if self.dim_c > 0 and self.eq_const is not None:
            h = h + uc[self.dim_u:] @ self.eq_const(t, x, uc)
        return h

    def costate_eq_at(self, t, lmd, x, uc):
        """dlambda/dt = -dH/dx (``CgmresProblem.h:33``)."""
        if self.costate_eq is not None:
            return self.costate_eq(t, lmd, x, uc)
        return -func.grad(self.hamiltonian, argnums=1)(t, x, uc, lmd)

    def dphi_dx_at(self, t, x):
        """The terminal cost's gradient."""
        if self.dphi_dx is not None:
            return self.dphi_dx(t, x)
        return func.grad(self.terminal_cost, argnums=1)(t, x)

    def dh_du_at(self, t, x, uc, lmd):
        """dH/du over the augmented input (``CgmresProblem.h:44``); on the
        multiplier block it is the equality constraint's residual."""
        if self.dh_du is not None:
            return self.dh_du(t, x, uc, lmd)
        return func.grad(self.hamiltonian, argnums=2)(t, x, uc, lmd)
