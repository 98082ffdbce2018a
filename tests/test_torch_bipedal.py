"""The bipedal CoM-ZMP model, the receding-horizon driver and the single
closed loop of the port against the JAX package on the CPU: the model's
callables and derivatives, the batched bipedal solve, ``run_mpc`` and
``make_closed_loop`` on the bipedal and the boxed vertical-motion models
over short windows, ``run_mpc``'s options on the cart-pole, and
``shift_warm_start`` across the vertical model's contact switch.  Inputs
are made from numpy seeds and handed to both."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu import DDPConfig as JaxDDPConfig
from nmpc_tpu import DDPSolver as JaxDDPSolver
from nmpc_tpu.models import bipedal as jb
from nmpc_tpu.models.vertical import make_vertical_problem as jax_vertical
from nmpc_tpu.models.vertical import VerticalCostWeight as JaxVerticalWeight
from nmpc_tpu.mpc.closed_loop import make_closed_loop as jax_closed_loop
from nmpc_tpu.mpc.driver import run_mpc as jax_run_mpc
from nmpc_tpu.mpc.driver import shift_warm_start as jax_shift
from nmpc_tpu_torch import (BipedalCostWeight, DDPSolver, MpcLog,
                            example_omega2_func, example_ref_zmp_func,
                            make_bipedal_problem, make_closed_loop, run_mpc,
                            shift_warm_start)
from nmpc_tpu_torch.convert import (bipedal_problem_from_reference,
                                    ddp_config_from_reference,
                                    result_to_numpy,
                                    vertical_problem_from_reference)
from nmpc_tpu_torch.kernels import tileval
from nmpc_tpu_torch.solvers.ddp import _resolve_backward_impl

torch.set_num_threads(1)

DT, END_T = 0.01, 20.0
# times across the footstep edges (1.5, 2, 3, 18.5) and inside the squat
# (7-8 s down, 12-13 s up) of the example profiles
TIMES = (0.0, 0.7, 1.4999, 1.5, 1.5001, 1.99, 2.0, 2.5, 3.0, 7.0, 7.3, 7.999,
         8.4, 12.0, 12.6, 13.01, 18.49, 18.5, 19.7)


def _problems():
    jp = jb.make_bipedal_problem(DT, jb.example_ref_zmp_func(END_T),
                                 jb.example_omega2_func())
    pp = bipedal_problem_from_reference(DT, END_T, jb.BipedalCostWeight())
    return jp, pp


def test_bipedal_callables_and_derivatives_match_jax():
    """The reference ZMP, omega^2, dynamics, costs and their derivatives
    (torch.func vs jax) at fp64 on TIMES and random states, within 1e-12;
    the footstep and the int cast batch under ``vmap`` with a tensor t."""
    jp, pp = _problems()
    ref, w2 = example_ref_zmp_func(END_T), example_omega2_func()
    jref, jw2 = jb.example_ref_zmp_func(END_T), jb.example_omega2_func()
    rng = np.random.default_rng(0)
    for t in TIMES:
        tt = torch.tensor(t, dtype=torch.float64)
        assert ref(tt).dtype == torch.float64
        np.testing.assert_allclose(float(ref(tt)), float(jref(t)), atol=1e-12)
        np.testing.assert_allclose(float(w2(tt)), float(jw2(t)), rtol=1e-12)
        x, u = rng.normal(size=2), rng.normal(size=1)
        xt, ut = torch.as_tensor(x), torch.as_tensor(u)
        xj, uj = jnp.asarray(x), jnp.asarray(u)
        pairs = [(pp.dynamics(tt, xt, ut), jp.dynamics(t, xj, uj)),
                 (pp.running_cost(tt, xt, ut), jp.running_cost(t, xj, uj)),
                 (pp.terminal_cost(tt, xt), jp.terminal_cost(t, xj))]
        pairs += list(zip(pp.linearize_dynamics(tt, xt, ut),
                          jp.linearize_dynamics(t, xj, uj)))
        pairs += list(zip(pp.quadraticize_running_cost(tt, xt, ut),
                          jp.quadraticize_running_cost(t, xj, uj)))
        pairs += list(zip(pp.quadraticize_terminal_cost(tt, xt),
                          jp.quadraticize_terminal_cost(t, xj)))
        for a, b in pairs:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-12)
    ts = torch.tensor(TIMES, dtype=torch.float64)
    batched = torch.func.vmap(ref)(ts)
    np.testing.assert_allclose(batched.numpy(),
                               [float(jref(t)) for t in TIMES], atol=1e-12)


def test_bipedal_is_served_by_the_sweep_fed_kernel():
    """The generator rejects the model (clamp, integer ops), so on the card
    ``auto`` takes the sweep-fed kernel at (nx, nu) = (2, 1) and the plain
    rollouts; on the CPU the plain backward."""
    _, pp = _problems()
    with pytest.raises(tileval.TileEvalError):
        tileval.generate(pp, "remat", 2, 1, torch.float32)
    cfg = ddp_config_from_reference(JaxDDPConfig())
    for dtype in (torch.float32, torch.float64):
        assert _resolve_backward_impl(cfg, pp, dtype, torch.device("cuda"),
                                      False, False) == "pallas"
        assert _resolve_backward_impl(cfg, pp, dtype, torch.device("cpu"),
                                      False, False) == "stacked"


@pytest.mark.parametrize("dma", ["stage", "packed"])
def test_bipedal_solve_batch_matches_jax(dma):
    """fp64 ``solve_batch`` (B=8, N=40, 10 iterations, from t0=1.2 so the
    horizon crosses the first footsteps) vs JAX's: statuses, iterations
    and the trace equal or within 1e-10, u within 1e-8; with
    ``backward_impl="pallas"`` and ``backward_dma`` on the CPU (the plain
    backward, "packed" through the pack)."""
    jp, pp = _problems()
    B, N = 8, 40
    jc = JaxDDPConfig(horizon_steps=N, max_iter=10)
    rng = np.random.default_rng(1)
    x0s = 0.05 * rng.normal(size=(B, 2))
    us0 = 0.02 * rng.normal(size=(B, N, 1))
    want = JaxDDPSolver(jp, jc).solve_batch(1.2, jnp.asarray(x0s),
                                            jnp.asarray(us0))
    cfg = dataclasses.replace(ddp_config_from_reference(jc),
                              backward_impl="pallas")
    got = result_to_numpy(DDPSolver(pp, cfg, backward_dma=dma).solve_batch(
        1.2, torch.as_tensor(x0s), torch.as_tensor(us0)))
    np.testing.assert_array_equal(got["status"], np.asarray(want.status))
    np.testing.assert_array_equal(got["iters"], np.asarray(want.iters))
    np.testing.assert_allclose(got["us"], np.asarray(want.us), atol=1e-8)
    np.testing.assert_allclose(got["xs"], np.asarray(want.xs), atol=1e-8)
    for name in ("cost", "lam", "alpha"):
        np.testing.assert_allclose(got["trace"][name],
                                   np.asarray(getattr(want.trace, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def _vertical():
    jp = jax_vertical(DT)
    pp = vertical_problem_from_reference(DT, JaxVerticalWeight())
    cfg = JaxDDPConfig(horizon_steps=20, max_iter=3, initial_lambda=1e-6,
                       with_input_constraint=True)
    return jp, pp, cfg


def _window(model):
    """(JAX problem, port problem, JAX config, t0, x0, us0) of a short
    window: the bipedal model from t0=1.45 across the first footstep, the
    boxed vertical model from t0=1.78, whose horizon's end crosses the
    switch to two contacts at t=2."""
    rng = np.random.default_rng(2)
    if model == "bipedal":
        jp, pp = _problems()
        cfg = JaxDDPConfig(horizon_steps=20, max_iter=10)
        return (jp, pp, cfg, 1.45, np.array([0.037, 0.116]),
                0.01 * rng.normal(size=(20, 1)))
    jp, pp, cfg = _vertical()
    return jp, pp, cfg, 1.78, np.array([1.1, 0.05]), np.zeros((20, 2))


def _hold_log(got: MpcLog, want, rows):
    np.testing.assert_array_equal(got.solve_iters, want.solve_iters[:rows])
    np.testing.assert_array_equal(got.solve_status,
                                  want.solve_status[:rows])
    np.testing.assert_allclose(got.ts, want.ts[:rows], atol=1e-12)
    np.testing.assert_allclose(got.xs, want.xs[:rows], atol=1e-8)
    np.testing.assert_allclose(got.us, want.us[:rows], atol=1e-8)


@pytest.mark.parametrize("model", ["bipedal", "vertical"])
def test_run_mpc_and_closed_loop_match_jax(model):
    """``run_mpc`` over 5 steps vs JAX's ``run_mpc`` (fp64): iterations
    and statuses equal, times, states and applied inputs within 1e-8; and
    ``make_closed_loop`` over the same 5 ticks vs JAX's, and vs the port's
    ``run_mpc``, within 1e-8."""
    jp, pp, jc, t0, x0, us0 = _window(model)
    end_t = t0 + 4.5 * DT
    want = jax_run_mpc(JaxDDPSolver(jp, jc), jnp.asarray(x0), t0=t0,
                       end_t=end_t, us_init=jnp.asarray(us0))
    solver = DDPSolver(pp, ddp_config_from_reference(jc))
    seen = []
    got = run_mpc(solver, torch.as_tensor(x0), t0=t0, end_t=end_t,
                  us_init=torch.as_tensor(us0),
                  callback=lambda t, x, u, res: seen.append(int(res.iters)))
    assert len(got.ts) == len(want.ts) == 5 and seen == list(got.solve_iters)
    _hold_log(got, want, 5)
    assert (got.solve_wall_ms > 0).all()

    jlog = jax_closed_loop(JaxDDPSolver(jp, jc), n_steps=5)(
        t0, jnp.asarray(x0), jnp.asarray(us0))
    log = make_closed_loop(solver, n_steps=5)(t0, torch.as_tensor(x0),
                                              torch.as_tensor(us0))
    for name in ("ts", "xs", "us"):
        np.testing.assert_allclose(getattr(log, name).numpy(),
                                   np.asarray(getattr(jlog, name)),
                                   atol=1e-8, err_msg=name)
    for name in ("iters", "status"):
        np.testing.assert_array_equal(getattr(log, name).numpy(),
                                      np.asarray(getattr(jlog, name)))
    np.testing.assert_allclose(log.xs.numpy(), got.xs, atol=1e-8)


@pytest.mark.parametrize("t_next", [1.895, 1.905, 2.5, 2.895, 4.395, 4.405])
def test_shift_warm_start_matches_jax(t_next):
    """``shift_warm_start`` on the vertical model (N=10) vs JAX's where the
    terminal mask keeps or changes its number of contacts (1 -> 2 at t=2,
    2 -> 1 at t=3, 1 -> 0 at t=4.5): equal bit for bit, and the new
    terminal entry zero where the mask changed."""
    jp, pp, _ = _vertical()
    us = np.random.default_rng(3).normal(size=(10, 2))
    want = np.asarray(jax_shift(jp, t_next, jnp.asarray(us)))
    got = shift_warm_start(pp, t_next, torch.as_tensor(us)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:-1], us[1:])
    cost_weight = BipedalCostWeight()
    bip = make_bipedal_problem(DT, example_ref_zmp_func(END_T),
                               example_omega2_func(), cost_weight)
    shifted = shift_warm_start(bip, t_next, torch.as_tensor(us[:, :1]))
    np.testing.assert_array_equal(shifted.numpy(),
                                  np.concatenate([us[1:, :1], us[-1:, :1]]))


def test_run_mpc_options_match_jax():
    """``run_mpc``'s options on the cart-pole (N=20, fp64) vs JAX's: a
    re-solve every second step, an input clamp, an input disturbance and
    a plant at half the horizon's dt; iterations, statuses, states and
    inputs within 1e-8, and no solve time on the steps without a solve."""
    from nmpc_tpu.models.cartpole import make_cartpole_problem as jax_cp
    from nmpc_tpu_torch.models.cartpole import make_cartpole_problem

    jc = JaxDDPConfig(horizon_steps=20, max_iter=5)
    x0 = np.array([0.0, np.pi - 0.3, 0.0, 0.0])
    kw = dict(t0=0.0, end_t=0.0275, sim_dt=0.005, mpc_interval=2)

    def plant(dynamics, time):
        return lambda t, x, u, h: x + (h / DT) * (dynamics(time(t), x, u) - x)

    want = jax_run_mpc(
        JaxDDPSolver(jax_cp(DT), jc), jnp.asarray(x0),
        sim_dynamics=plant(jax_cp(DT).dynamics, float),
        disturbance_func=lambda t: jnp.array([0.5 * np.sin(40.0 * t)]),
        input_clamp=lambda t, u: jnp.clip(u, -2.0, 2.0), **kw)
    pp = make_cartpole_problem(DT)
    got = run_mpc(
        DDPSolver(pp, ddp_config_from_reference(jc)), torch.as_tensor(x0),
        sim_dynamics=plant(pp.dynamics, torch.tensor),
        disturbance_func=lambda t: torch.tensor([0.5 * np.sin(40.0 * t)],
                                                dtype=torch.float64),
        input_clamp=lambda t, u: torch.clamp(u, -2.0, 2.0), **kw)
    assert len(got.ts) == len(want.ts) == 6
    _hold_log(got, want, 6)
    assert (got.solve_wall_ms[1::2] == 0).all()
    assert (got.solve_wall_ms[::2] > 0).all()
    assert np.abs(got.us).max() > 2.0    # the disturbance is added after the clamp
