"""``ls_mode="serial"`` in the port's batched DDP solve against its other
line-search modes and JAX's serial mode (nmpc_tpu/solvers/ddp.py:
1133-1192), at fp64: the cart-pole and the boxed vertical-motion model
across its switch to two contacts, B=8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu import DDPConfig as JaxConfig
from nmpc_tpu import DDPSolver as JaxSolver
from nmpc_tpu.models import cartpole as jax_cp
from nmpc_tpu.models import vertical as jax_vert
from nmpc_tpu_torch import DDPSolver
from nmpc_tpu_torch.convert import ddp_config_from_reference, result_to_numpy
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.models.vertical import make_vertical_problem

torch.set_num_threads(1)

DT, B = 0.01, 8


def _case(model):
    """(JAX problem, port problem, config keywords, t0, x0s, us0)."""
    rng = np.random.default_rng(3)
    if model == "cartpole":
        N = 40
        x0s = (np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
               + 0.3 * rng.normal(size=(B, 4)))
        return (jax_cp.make_cartpole_problem(DT), make_cartpole_problem(DT),
                dict(horizon_steps=N, max_iter=20), 0.0, x0s,
                np.zeros((B, N, 1)))
    # a far start and a rough guess: lanes backtrack, some through the
    # whole schedule
    N = 20
    x0s = np.tile([1.2, 0.0], (B, 1)) + 0.3 * rng.normal(size=(B, 2))
    return (jax_vert.make_vertical_problem(DT), make_vertical_problem(DT),
            dict(horizon_steps=N, max_iter=6, initial_lambda=1e-6,
                 with_input_constraint=True), 1.9, x0s,
            10.0 * rng.normal(size=(B, N, 2)))


@pytest.mark.parametrize("model", ["cartpole", "vertical"])
def test_serial_matches_other_modes_and_jax(model):
    """Statuses, iterations, us and every trace row equal across
    ``serial``, ``head`` and ``sweep`` (the same accept decisions from the
    same cost sums); within 1e-10 of JAX's serial mode; each iteration's
    serial loop reads the host once a trip and once more to end, so the
    solve's host syncs are sweep's plus the sum over iterations of 1 + the
    trips taken (``DDPSolver.ls_trips``)."""
    jprob, prob, kw, t0, x0s, us0 = _case(model)
    jc = JaxConfig(ls_mode="serial", **kw)
    jres = JaxSolver(jprob, jc).solve_batch(
        jnp.asarray(t0), jnp.asarray(x0s), jnp.asarray(us0))
    out = {}
    for mode in ("serial", "head", "sweep"):
        solver = DDPSolver(prob, ddp_config_from_reference(JaxConfig(
            ls_mode=mode, **kw)))
        res = solver.solve_batch(t0, torch.as_tensor(x0s),
                                 torch.as_tensor(us0))
        out[mode] = (res, solver.host_syncs, solver.ls_trips)
    serial, syncs, trips = out["serial"]
    for mode in ("head", "sweep"):
        other = out[mode][0]
        for f in ("status", "iters", "us", "xs", "costs", "lam"):
            assert torch.equal(getattr(serial, f), getattr(other, f)), (mode,
                                                                        f)
        for f in ("cost", "alpha", "cost_update_actual",
                  "cost_update_ratio"):
            assert torch.equal(getattr(serial.trace, f),
                               getattr(other.trace, f)), (mode, f)
        assert out[mode][2] == []
    assert len(trips) == int(serial.iters.max())
    assert max(trips) >= (11 if model == "vertical" else 1)
    assert syncs == out["sweep"][1] + sum(1 + t for t in trips)

    got = result_to_numpy(serial)
    np.testing.assert_array_equal(got["status"], np.asarray(jres.status))
    np.testing.assert_array_equal(got["iters"], np.asarray(jres.iters))
    np.testing.assert_allclose(got["us"], np.asarray(jres.us), atol=1e-10,
                               rtol=0)
    np.testing.assert_allclose(got["xs"], np.asarray(jres.xs), atol=1e-10,
                               rtol=0)
    np.testing.assert_array_equal(got["trace"]["alpha"],
                                  np.asarray(jres.trace.alpha))
