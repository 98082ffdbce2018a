"""The port's C/GMRES closed-loop simulations against the JAX package's,
fp64 on the CPU: ``simulate`` (one controller from ``setup``; the fleet
path at B = 1, against JAX's single-controller scan) and
``simulate_batch`` (three controllers about x_initial, against JAX's
batch-minor scan), 20 control steps each, on the semiactive damper and on
the cart-pole with and without the dummy-input force bound (costate and
dH/du by autodiff of the Hamiltonian).  States, inputs and optimality
errors within 1e-8; the step times equal.

JAX's 20 s closed loops (20,001 control steps, ``tests/test_cgmres.py:
170-208``) are not run here: eager horizon sweeps take a CPU about a
second a step (ROADMAP: open).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.models.cartpole_cgmres import (
    make_cartpole_cgmres_problem as jax_cartpole)
from nmpc_tpu.models.damper import make_damper_problem as jax_damper
from nmpc_tpu.solvers import cgmres as jax_cgmres
from nmpc_tpu_torch import CgmresConfig, CgmresSolver, CgmresState
from nmpc_tpu_torch.models.cartpole_cgmres import make_cartpole_cgmres_problem
from nmpc_tpu_torch.models.damper import make_damper_problem

torch.set_num_threads(1)

N_STEPS = 20
TOL = 1e-8
MODELS = {
    "damper": (jax_damper, make_damper_problem, ()),
    "cartpole": (jax_cartpole, make_cartpole_cgmres_problem, (False,)),
    "cartpole-bounded": (jax_cartpole, make_cartpole_cgmres_problem,
                         (True,)),
}


def _solvers(model):
    make_jax, make_port, args = MODELS[model]
    return (jax_cgmres.CgmresSolver(make_jax(*args),
                                    jax_cgmres.CgmresConfig()),
            CgmresSolver(make_port(*args), CgmresConfig(), device="cpu"))


def _hold(ref, got):
    for name, r, g in zip(("ts", "xs", "us", "errs"), ref, got):
        r, g = np.asarray(r), g.numpy()
        assert r.shape == g.shape, name
        assert np.isfinite(g).all(), name
        assert np.abs(r - g).max() <= TOL, (name, np.abs(r - g).max())


@pytest.mark.parametrize("model", MODELS)
def test_simulate_matches_jax(model):
    """One controller from the problem's initial values: setup, then
    ``simulate``'s N_STEPS control steps with the RK4 plant."""
    ref_solver, solver = _solvers(model)
    _hold(ref_solver.simulate(n_steps=N_STEPS), solver.simulate(
        n_steps=N_STEPS))


@pytest.mark.parametrize("model", MODELS)
def test_simulate_batch_matches_jax(model):
    """Three controllers about x_initial from one setup: the batch-minor
    state held across N_STEPS steps, batch-first outputs."""
    ref_solver, solver = _solvers(model)
    B = 3
    x_init = np.asarray(ref_solver.problem.x_initial)
    rng = np.random.default_rng(len(model))
    x0s = np.tile(x_init, (B, 1)) + 0.05 * rng.normal(size=(B, x_init.size))
    st_j = ref_solver.setup()
    st_t = solver.setup()
    ref = ref_solver.simulate_batch(
        0.0, jnp.asarray(x0s), jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (B,) + a.shape), st_j), N_STEPS)
    got = solver.simulate_batch(
        0.0, torch.as_tensor(x0s), CgmresState(
            *(a[None].expand(B, *a.shape).contiguous() for a in st_t)),
        N_STEPS)
    assert solver.host_syncs == 0
    _hold(ref, got)
