"""The port's centroidal model (``models/centroidal.py``: nx = 9, 16
friction-pyramid ridge forces, a flight phase with every input masked)
against the JAX package's, and the port's derivative checker
(``utils/check.py``), fp64 on the CPU, on the same seeded numpy inputs.

* dynamics, costs, masks, stance and limits at random points and at times
  about the flight phase's ends (1.4 s, 1.6 s): 1e-12;
* ``solve_batch`` (B = 3, N = 40, 20 iterations) from t0 = 0 and from
  t0 = 1.3 (the horizon crosses the flight phase), unboxed, against JAX's
  ``solve_batch``: statuses and iterations equal, u within 1e-8, every
  masked u exactly 0 (the boxed solves are in
  ``test_torch_centroidal_boxed.py``);
* ``check_problem_derivatives`` on the cart-pole, the oscillator and the
  centroidal model, and its failure on a wrong analytic derivative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu import DDPConfig as JaxConfig
from nmpc_tpu import DDPSolver as JaxSolver
from nmpc_tpu.models import centroidal as jax_centroidal
from nmpc_tpu_torch import DDPSolver, Problem
from nmpc_tpu_torch.convert import (centroidal_problem_from_reference,
                                    ddp_config_from_reference)
from nmpc_tpu_torch.models import centroidal
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.models.oscillator import make_oscillator_problem
from nmpc_tpu_torch.utils.check import check_problem_derivatives

torch.set_num_threads(1)

DT = 0.03
F64 = torch.float64
TIMES = (0.0, 0.7, 1.399, 1.3999995, 1.4, 1.45, 1.5, 1.5999995, 1.6, 2.2)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _max_diff(ref, got):
    return float(np.abs(np.asarray(ref, float)
                        - got.double().numpy()).max())


def test_centroidal_model_matches_jax():
    """Dynamics, running and terminal costs, the input mask, the stance
    and the limits against JAX's at random states and inputs and at
    times on both sides of 1.4 s and 1.6 s (1e-12); the flight phase has
    every input masked and ignores the forces."""
    pj = jax_centroidal.make_centroidal_problem(
        DT, force_limits=(0.0, 1000.0))
    pt = centroidal_problem_from_reference(
        DT, jax_centroidal.CentroidalCostWeight(), (0.0, 1000.0))
    vj, rj, _ = jax_centroidal.example_stance_func()
    vt, rt, _ = centroidal.example_stance_func()
    ref_j = jax_centroidal.example_ref_pos_func()
    ref_t = centroidal.example_ref_pos_func()
    rng = np.random.default_rng(0)
    for t in TIMES:
        x = rng.normal(size=9) + np.r_[0.0, 0.0, 1.0, np.zeros(6)]
        u = rng.uniform(0.0, 80.0, size=16)
        tj, tt = jnp.asarray(t), _t(t)
        xj, uj, xt, ut = jnp.asarray(x), jnp.asarray(u), _t(x), _t(u)
        assert _max_diff(pj.dynamics(tj, xj, uj),
                         pt.dynamics(tt, xt, ut)) <= 1e-12
        assert _max_diff(pj.running_cost(tj, xj, uj),
                         pt.running_cost(tt, xt, ut)) <= 1e-12
        assert _max_diff(pj.terminal_cost(tj, xj),
                         pt.terminal_cost(tt, xt)) <= 1e-12
        mask = pt.input_mask(tt)
        assert mask.dtype == torch.bool and mask.shape == (16,)
        np.testing.assert_array_equal(np.asarray(pj.input_mask(tj)),
                                      mask.numpy())
        assert _max_diff(vj(tj), vt(tt)) <= 1e-12
        assert _max_diff(rj(tj), rt(tt)) <= 1e-12
        assert _max_diff(ref_j(tj), ref_t(tt)) <= 1e-12
        for a, b in zip(pj.input_limits(tj), pt.input_limits(tt)):
            assert _max_diff(a, b) == 0.0
        if 1.4 <= t + 1e-6 < 1.6:
            assert not mask.any()
            assert torch.equal(pt.dynamics(tt, xt, ut),
                               pt.dynamics(tt, xt, 0 * ut))
    vs, rs = centroidal.rect_stance(0.5, 0.1)
    vjs, rjs = jax_centroidal.rect_stance(0.5, 0.1)
    assert _max_diff(vjs, vs) == 0.0 and _max_diff(rjs, rs) <= 1e-15


def _start(problem, t0, B, N, seed=1):
    """x0 about the standing pose (``bench_all.py:111-115``), 60 N a
    ridge (about the weight) where the stage's inputs are active and 0
    where they are masked, from a seed; and the masked stages [N, 16]."""
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([[0.0, 0.0, 1.0], np.zeros(6)])
    x0s = np.tile(x0, (B, 1)) + 0.02 * rng.normal(size=(B, 9))
    ts = t0 + DT * torch.arange(N, dtype=F64)
    masked = torch.stack([~problem.input_mask(t) for t in ts])
    us0 = np.where(masked.numpy()[None], 0.0, 60.0) * np.ones((B, N, 16))
    return x0s, us0, masked


def jax_solver(boxed, N, max_iter):
    """The JAX solver of the centroidal model (boxed: force limits (0,
    1000)); one per module serves both t0 with one compile."""
    jc = JaxConfig(horizon_steps=N, max_iter=max_iter,
                   with_input_constraint=boxed)
    return JaxSolver(jax_centroidal.make_centroidal_problem(
        DT, force_limits=(0.0, 1000.0) if boxed else None), jc)


@pytest.fixture(scope="module")
def unboxed_solver():
    return jax_solver(False, 40, 20)


def hold_solve_batch(js, t0, boxed):
    """B = 3, fp64, the JAX solver ``js``'s config: statuses and
    iterations equal, u within 1e-8 of JAX's, every masked input exactly
    0 and (boxed) every first-stage input inside [0, 1000]."""
    B = 3
    N = js.config.horizon_steps
    problem = centroidal.make_centroidal_problem(
        DT, force_limits=(0.0, 1000.0) if boxed else None)
    x0s, us0, masked = _start(problem, t0, B, N)
    jr = js.solve_batch(jnp.asarray(t0, jnp.float64), jnp.asarray(x0s),
                        jnp.asarray(us0))
    res = DDPSolver(problem, ddp_config_from_reference(
        js.config)).solve_batch(t0, _t(x0s), _t(us0))
    np.testing.assert_array_equal(np.asarray(jr.status), res.status.numpy())
    np.testing.assert_array_equal(np.asarray(jr.iters), res.iters.numpy())
    assert _max_diff(jr.us, res.us) <= 1e-8
    assert bool(masked.any()) == (t0 == 1.3)
    assert torch.all(res.us[:, masked] == 0)
    if boxed:
        assert torch.all((res.us[:, 0] >= 0.0) & (res.us[:, 0] <= 1000.0))


@pytest.mark.parametrize("t0", [0.0, 1.3])
def test_solve_batch_matches_jax(unboxed_solver, t0):
    """Unboxed, N = 40, 20 iterations (on the card ``auto`` takes K1)."""
    hold_solve_batch(unboxed_solver, t0, boxed=False)


def _checked_problems():
    return {"cart-pole": (make_cartpole_problem(0.01), 0.3,
                          [0.1, 2.9, 0.2, -0.1], [1.5]),
            "oscillator": (make_oscillator_problem(0.01), 0.0, [0.5, -0.3],
                           [0.2]),
            "centroidal": (centroidal.make_centroidal_problem(DT), 0.5,
                           [0.01, -0.02, 0.98, 0.5, 0.1, -0.2, 0.05, 0.1,
                            -0.03], list(np.linspace(40.0, 80.0, 16)))}


@pytest.mark.parametrize("name", ["cart-pole", "oscillator", "centroidal"])
def test_check_problem_derivatives(name):
    """The autodiff derivatives of each model (and the oscillator's
    inequality Jacobians) agree with central differences within the
    checker's 1e-5."""
    problem, t, x, u = _checked_problems()[name]
    errs = check_problem_derivatives(problem, t, x, u)
    assert {"Fx", "Fu", "Lx", "Lu", "Vx"} <= set(errs)
    assert ("C" in errs) == (problem.ineq_const is not None)
    assert max(errs.values()) <= 1e-5


def test_check_problem_derivatives_catches_a_wrong_analytic_one():
    """A cart-pole whose analytic Fu is off by 1e-3 in one entry fails
    the check, naming Fu."""
    base = make_cartpole_problem(0.01)

    def wrong(t, x, u):
        Fx, Fu = base.linearize_dynamics(t, x, u)
        return Fx, Fu + torch.tensor([[0.0], [0.0], [1e-3], [0.0]],
                                     dtype=Fu.dtype)

    bad = dataclasses.replace(base, dynamics_derivs=wrong)
    assert isinstance(bad, Problem)
    with pytest.raises(AssertionError, match="Fu"):
        check_problem_derivatives(bad, 0.3, [0.1, 2.9, 0.2, -0.1], [1.5])
