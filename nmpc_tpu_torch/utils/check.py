"""Derivative cross-check of a problem against central differences.

The port's counterpart of ``nmpc_tpu/utils/check.py``.  The reference
checks every problem's hand-written derivatives against central finite
differences (``TestDDPCartPole.cpp:609-649``, ``TestFmpcOscillator.cpp:
203-266``); here the derivative functions of a :class:`Problem` (its
analytic overrides, or ``torch.func`` autodiff) are held against central
differences of its own callables, in float64 on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def _central_jac(f, z, eps):
    """[len(f(z)), len(z)] central-difference Jacobian of numpy ``f``."""
    z = np.asarray(z, float)
    f0 = np.atleast_1d(np.asarray(f(z), float))
    J = np.zeros((f0.size, z.size))
    for j in range(z.size):
        d = np.zeros_like(z)
        d[j] = eps
        J[:, j] = (np.asarray(f(z + d), float)
                   - np.asarray(f(z - d), float)) / (2 * eps)
    return J


def check_problem_derivatives(problem, t, x, u, eps=1e-6, tol=1e-5):
    """Hold a Problem's derivative functions (Fx, Fu, Lx, Lu, Vx and, with
    inequalities, C, D) to central differences at (t, x, u).  Returns a
    dict of max abs errors; raises AssertionError above ``tol``."""
    as_t = lambda a: torch.as_tensor(np.asarray(a, float),
                                     dtype=torch.float64)
    num = lambda a: np.atleast_1d(a.detach().numpy())
    t = as_t(t)
    x = np.asarray(x, float)
    u = np.asarray(u, float)
    tx, tu = as_t(x), as_t(u)
    errs = {}

    def err(name, analytic, numeric):
        errs[name] = float(np.abs(num(analytic) - numeric).max())

    Fx, Fu = problem.linearize_dynamics(t, tx, tu)
    err("Fx", Fx, _central_jac(
        lambda z: num(problem.dynamics(t, as_t(z), tu)), x, eps))
    err("Fu", Fu, _central_jac(
        lambda z: num(problem.dynamics(t, tx, as_t(z))), u, eps))

    Lx, Lu, *_ = problem.quadraticize_running_cost(t, tx, tu)
    err("Lx", Lx, _central_jac(
        lambda z: num(problem.running_cost(t, as_t(z), tu)), x, eps)[0])
    err("Lu", Lu, _central_jac(
        lambda z: num(problem.running_cost(t, tx, as_t(z))), u, eps)[0])

    Vx, _ = problem.quadraticize_terminal_cost(t, tx)
    err("Vx", Vx, _central_jac(
        lambda z: num(problem.terminal_cost(t, as_t(z))), x, eps)[0])

    if problem.ineq_const is not None:
        C, D = problem.linearize_ineq(t, tx, tu)
        err("C", C, _central_jac(
            lambda z: num(problem.ineq_const(t, as_t(z), tu)), x, eps))
        err("D", D, _central_jac(
            lambda z: num(problem.ineq_const(t, tx, as_t(z))), u, eps))

    bad = {k: v for k, v in errs.items() if v > tol}
    assert not bad, f"derivative check failed: {bad}"
    return errs
