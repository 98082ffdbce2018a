"""Optimal-control problem abstraction of the PyTorch port.

A problem is a frozen bundle of per-instance callables on tensors
(``x [nx]``, ``u [nu]``, time ``t``), as in ``nmpc_tpu/core/problem.py``.
The solver batches them with ``torch.func.vmap``.  Derivatives default to
``torch.func`` autodiff; analytic overrides replace them field by field.
Time-varying input dimensions use a static maximum plus an
``input_mask(t)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from torch import func


@dataclasses.dataclass(frozen=True)
class Problem:
    """Discrete-time optimal control problem (reference
    ``DDPProblem.h:15``).

    Required callables:
      dynamics(t, x, u) -> x_next
      running_cost(t, x, u) -> scalar
      terminal_cost(t, x) -> scalar
    Optional:
      *_derivs               analytic derivatives; autodiff when None
      input_mask(t) -> bool[input_dim]     active-input mask
      input_limits(t) -> (lower, upper)    box bounds for constrained DDP
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
