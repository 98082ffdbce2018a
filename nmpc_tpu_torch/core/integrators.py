"""Fixed-step ODE integrators (Euler, RK4).

Port of ``nmpc_tpu/core/integrators.py`` (reference
``nmpc_cgmres/include/nmpc_cgmres/OdeSolver.h:14-73``):
``integrator(f, t, x, u, dt) -> x_next`` with ``f(t, x, u) -> xdot``, on
tensors of any shape that ``f`` takes (one controller, or a batch on the
trailing axis).
"""

from __future__ import annotations


def euler(f, t, x, u, dt):
    """Forward Euler (``OdeSolver.h:34-51``)."""
    return x + dt * f(t, x, u)


def rk4(f, t, x, u, dt):
    """Classic Runge-Kutta 4 (``OdeSolver.h:53-73``)."""
    half = dt / 2.0
    k1 = f(t, x, u)
    k2 = f(t + half, x + half * k1, u)
    k3 = f(t + half, x + half * k2, u)
    k4 = f(t + dt, x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


INTEGRATORS = {"euler": euler, "rk4": rk4}
