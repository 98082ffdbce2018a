"""The port's batched closed-loop tick loop vs the JAX
``make_closed_loop_batch``, on the same numpy inputs, at fp64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu import DDPConfig as JaxConfig
from nmpc_tpu import DDPSolver as JaxSolver
from nmpc_tpu.models.cartpole import make_cartpole_problem as jax_cartpole
from nmpc_tpu.mpc.closed_loop import make_closed_loop_batch as jax_loop
from nmpc_tpu_torch import DDPConfig, DDPSolver
from nmpc_tpu_torch.convert import ddp_config_from_reference
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.mpc.closed_loop import _tick_solver, make_closed_loop_batch

torch.set_num_threads(1)

DT = 0.01


def test_closed_loop_batch_matches_jax():
    """B=8, N=30, 5 ticks, max_iter=3: iters and status exactly equal,
    xs/us atol 1e-8."""
    B, N, ticks = 8, 30, 5
    rng = np.random.default_rng(0)
    x0s = np.tile([0.0, np.pi, 0.0, 0.0], (B, 1)) + 0.05 * rng.normal(
        size=(B, 4))
    us0 = 0.1 * rng.normal(size=(B, N, 1))
    jc = JaxConfig(horizon_steps=N, max_iter=3)
    ref = jax_loop(JaxSolver(jax_cartpole(DT), jc), n_steps=ticks)(
        0.0, jnp.asarray(x0s), jnp.asarray(us0))
    sim = make_closed_loop_batch(
        DDPSolver(make_cartpole_problem(DT), ddp_config_from_reference(jc)),
        n_steps=ticks)
    log = sim(0.0, torch.as_tensor(x0s), torch.as_tensor(us0))
    assert log.xs.shape == (B, ticks, 4) and log.us.shape == (B, ticks, 1)
    assert log._fields == ref._fields
    np.testing.assert_array_equal(log.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(log.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(log.ts.numpy(), np.asarray(ref.ts), rtol=1e-14)
    np.testing.assert_allclose(log.xs.numpy(), np.asarray(ref.xs), atol=1e-8,
                               rtol=0)
    np.testing.assert_allclose(log.us.numpy(), np.asarray(ref.us), atol=1e-8,
                               rtol=0)


@pytest.mark.parametrize("ls_mode,want", [("auto", "sweep"),
                                          ("head", "head"),
                                          ("sweep", "sweep")])
def test_tick_solver_ls_mode(ls_mode, want):
    """The tick loop rebuilds an ``ls_mode="auto"`` solver with the sweep
    path and keeps an explicit mode (nmpc_tpu/mpc/closed_loop.py:31-44)."""
    solver = DDPSolver(make_cartpole_problem(DT),
                       DDPConfig(horizon_steps=10, ls_mode=ls_mode))
    assert _tick_solver(solver).config.ls_mode == want
