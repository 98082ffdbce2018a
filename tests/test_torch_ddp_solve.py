"""The port's batched DDP solve end to end (cart-pole) vs the JAX
``solve_batch`` and the NumPy golden DDP, on the same numpy inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden.cartpole_numpy import CartPoleGolden
from golden.ddp_numpy import GoldenConfig, GoldenDDP
from nmpc_tpu import DDPConfig as JaxConfig
from nmpc_tpu import DDPSolver as JaxSolver
from nmpc_tpu.models.cartpole import make_cartpole_problem as jax_cartpole
from nmpc_tpu_torch import DDPConfig, DDPSolver, DDPStatus
from nmpc_tpu_torch.convert import ddp_config_from_reference, result_to_numpy
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.kernels.tileval import TileEvalError
from nmpc_tpu_torch.solvers.ddp import (_resolve_backward_impl,
                                         _resolve_forward_impl)

torch.set_num_threads(1)

DT = 0.01
HANG = [0.0, np.pi, 0.0, 0.0]
TRACE = ("cost", "lam", "dlam", "alpha", "k_rel_norm", "cost_update_actual",
         "cost_update_expected", "cost_update_ratio")


def _inputs(B, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x0s = (np.tile(HANG, (B, 1)) + 0.1 * rng.normal(size=(B, 4))).astype(dtype)
    return x0s, np.zeros((B, N, 1), dtype)


def _jax_numpy(res):
    out = {f: np.asarray(getattr(res, f)) for f in
           ("status", "iters", "xs", "us", "costs", "ks", "Ks", "lam", "dlam")}
    out["trace"] = {f: np.asarray(getattr(res.trace, f)) for f in
                    ("iter",) + TRACE}
    return out


def _solve_both(jc, x0s, us0):
    """(JAX result, port result) as numpy dicts, same config and inputs."""
    t0 = jnp.asarray(0.0, x0s.dtype)
    jr = JaxSolver(jax_cartpole(DT), jc).solve_batch(
        t0, jnp.asarray(x0s), jnp.asarray(us0))
    tr = DDPSolver(make_cartpole_problem(DT),
                   ddp_config_from_reference(jc)).solve_batch(
                       0.0, torch.as_tensor(x0s), torch.as_tensor(us0))
    return _jax_numpy(jr), result_to_numpy(tr)


@pytest.mark.parametrize("ls_mode", ["auto", "head", "sweep"])
def test_solve_batch_matches_jax_fp64(ls_mode):
    """B=8, N=100, max_iter=50 at fp64: status and iters exactly equal,
    us/xs atol 1e-8, the trace rows rtol 1e-10.  Three trace rows are
    differences of near-equal numbers, so their error scales with the
    operands, not with the result: cost_update_actual (cost_old - cost_new)
    and k_rel_norm (|k| shrinks to ~1e-6 of its start) get an absolute
    floor of 1e-12 times the row's largest value, and cost_update_ratio
    (actual / expected) is held as ratio * expected against JAX's actual
    with that floor, plus an equal sign."""
    x0s, us0 = _inputs(8, 100, np.float64)
    jr, tr = _solve_both(JaxConfig(horizon_steps=100, max_iter=50,
                                   ls_mode=ls_mode), x0s, us0)
    np.testing.assert_array_equal(tr["status"], jr["status"])
    np.testing.assert_array_equal(tr["iters"], jr["iters"])
    assert (tr["status"] == DDPStatus.SUCCEEDED).all()
    np.testing.assert_allclose(tr["us"], jr["us"], atol=1e-8, rtol=0)
    np.testing.assert_allclose(tr["xs"], jr["xs"], atol=1e-8, rtol=0)
    np.testing.assert_allclose(tr["lam"], jr["lam"], rtol=1e-10)
    a, b = tr["trace"], jr["trace"]
    np.testing.assert_array_equal(a["iter"], b["iter"])
    for name in ("cost", "lam", "dlam", "alpha", "cost_update_expected"):
        np.testing.assert_allclose(a[name], b[name], rtol=1e-10, err_msg=name)
    for name in ("k_rel_norm", "cost_update_actual"):
        floor = 1e-12 * np.abs(b[name]).max()
        np.testing.assert_allclose(a[name], b[name], rtol=1e-10, atol=floor,
                                   err_msg=name)
    floor = 1e-12 * np.abs(b["cost_update_actual"]).max()
    np.testing.assert_allclose(a["cost_update_ratio"]
                               * b["cost_update_expected"],
                               b["cost_update_actual"], rtol=1e-10,
                               atol=floor)
    np.testing.assert_array_equal(np.sign(a["cost_update_ratio"]),
                                  np.sign(b["cost_update_ratio"]))


def test_solve_matches_golden():
    """Port ``solve`` (solve_batch at B=1) vs the NumPy golden DDP: us/xs
    atol 1e-8 and the same iterations (tests/test_ddp_cartpole.py:48-62)."""
    N = 100
    solver = DDPSolver(make_cartpole_problem(DT),
                       DDPConfig(horizon_steps=N, max_iter=50))
    golden = GoldenDDP(CartPoleGolden(DT),
                       GoldenConfig(horizon_steps=N, max_iter=50))
    x0 = np.array(HANG)
    g = golden.solve(0.0, x0, np.zeros((N, 1)))
    res = solver.solve(0.0, torch.as_tensor(x0),
                       torch.zeros((N, 1), dtype=torch.float64))
    assert g["status"] == "succeeded"
    assert int(res.status) == DDPStatus.SUCCEEDED
    assert int(res.iters) == g["iters"]
    np.testing.assert_allclose(res.us.numpy(), g["us"], atol=1e-8, rtol=0)
    np.testing.assert_allclose(res.xs.numpy(), g["xs"], atol=1e-8, rtol=0)
    for row in g["trace"]:
        for name in ("cost", "lam", "dlam", "alpha"):
            if name in row:
                np.testing.assert_allclose(
                    float(getattr(res.trace, name)[row["iter"]]), row[name],
                    rtol=1e-10, err_msg=f"iter {row['iter']} {name}")


@pytest.mark.parametrize("deriv_dtype", ["same", "float64"])
def test_solve_batch_matches_jax_fp32(deriv_dtype):
    """fp32 with ``for_fp32()``, max_iter=10, port vs JAX: the end-to-end
    contract of benchmarks/parity_gate.py:58-74 — statuses and iters
    equal, cost rel <= 1e-4, u normalized <= 1e-2.  Half the lanes start
    near upright and terminate (SUCCEEDED) within the 10 iterations, half
    near hanging and run out of iterations.  ``deriv_dtype="float64"``
    runs the derivative callbacks and the line-search cost sums at fp64
    inside the fp32 solve."""
    x0s, us0 = _inputs(16, 100, np.float32, seed=1)
    x0s[8:, 1] -= np.float32(np.pi)
    jc = dataclasses.replace(
        JaxConfig(horizon_steps=100, max_iter=10).for_fp32(),
        deriv_dtype=deriv_dtype)
    jr, tr = _solve_both(jc, x0s, us0)
    assert tr["us"].dtype == np.float32
    assert set(jr["status"].tolist()) == {DDPStatus.SUCCEEDED,
                                          DDPStatus.MAX_ITER_REACHED}
    np.testing.assert_array_equal(tr["status"], jr["status"])
    np.testing.assert_array_equal(tr["iters"], jr["iters"])
    ua, ub = jr["us"].astype(np.float64), tr["us"].astype(np.float64)
    assert np.abs(ua - ub).max() / (1.0 + np.abs(ua).max()) <= 1e-2
    ca = jr["costs"].astype(np.float64).sum(1)
    cb = tr["costs"].astype(np.float64).sum(1)
    assert (np.abs(ca - cb) / (1.0 + np.abs(ca))).max() <= 1e-4


def test_nan_lane_is_isolated():
    """A NaN initial state fails its own lane (FAIL_*), while the other
    lanes succeed with finite outputs equal to a solve without it."""
    x0s, us0 = _inputs(4, 30, np.float64, seed=2)
    solver = DDPSolver(make_cartpole_problem(DT),
                       DDPConfig(horizon_steps=30, max_iter=30))
    clean = solver.solve_batch(0.0, torch.as_tensor(x0s),
                               torch.as_tensor(us0))
    x0s[2] = np.nan
    res = solver.solve_batch(0.0, torch.as_tensor(x0s), torch.as_tensor(us0))
    assert int(res.status[2]) in (DDPStatus.FAIL_BACKWARD_LAMBDA,
                                  DDPStatus.FAIL_FORWARD_LAMBDA)
    keep = [0, 1, 3]
    assert (res.status[keep] == DDPStatus.SUCCEEDED).all()
    assert torch.isfinite(res.us[keep]).all()
    assert torch.equal(res.iters[keep], clean.iters[keep])
    np.testing.assert_allclose(res.us[keep].numpy(), clean.us[keep].numpy(),
                               atol=1e-12, rtol=0)


def test_wrong_shape_us_init_names_expected_shape():
    solver = DDPSolver(make_cartpole_problem(DT),
                       DDPConfig(horizon_steps=20, max_iter=2))
    x0s = torch.zeros((2, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match=r"shape \(2, 20, 1\)"):
        solver.solve_batch(0.0, x0s, torch.zeros((2, 21, 1),
                                                 dtype=torch.float64))
    with pytest.raises(ValueError, match=r"shape \(20, 1\)"):
        solver.solve(0.0, x0s[0], torch.zeros((20, 2), dtype=torch.float64))


@pytest.mark.parametrize("change,item", [
    ({"with_input_constraint": True}, "A6"),
    ({"ls_mode": "serial"}, "A4"),
    ({"backward_impl": "remat"}, "B3"),
    ({"forward_impl": "fused"}, "B2"),
])
def test_unported_options_raise(change, item):
    """Options once left to port, each named by its ROADMAP item; every
    one is ported now and none raises.  The remat backward (B3), the fused
    rollouts (B2) and the serial line search (A4) construct and, on CPU
    tensors, solve exactly like the default path (the serial loop takes
    the same accept decisions from the same cost sums).  Boxed DDP (A6)
    is ported: with limits that never
    bind it takes the unboxed solve's decisions (statuses, iterations,
    alphas equal; costs within 1e-12 relative).  Its QP keeps the warm
    start (the later stage's k) where the gradient there is below
    ``grad_thre`` = 1e-8 (BoxQP.h), which leaves k up to grad_thre / Quu
    off the Newton point: u within 1e-4."""
    x0s, us0 = _inputs(4, 20, np.float64, seed=3)
    cfg = DDPConfig(horizon_steps=20, max_iter=5)
    if item == "A6":
        wide = make_cartpole_problem(DT, input_limits=(-1e3, 1e3))
        got = DDPSolver(wide, dataclasses.replace(cfg, **change)).solve_batch(
            0.0, torch.as_tensor(x0s), torch.as_tensor(us0))
        ref = DDPSolver(make_cartpole_problem(DT), cfg).solve_batch(
            0.0, torch.as_tensor(x0s), torch.as_tensor(us0))
        assert torch.equal(got.status, ref.status)
        assert torch.equal(got.iters, ref.iters)
        assert torch.equal(got.trace.alpha, ref.trace.alpha)
        np.testing.assert_allclose(got.trace.cost.numpy(),
                                   ref.trace.cost.numpy(), rtol=1e-12)
        np.testing.assert_allclose(got.us.numpy(), ref.us.numpy(), rtol=0,
                                   atol=1e-4)
        return
    got = DDPSolver(make_cartpole_problem(DT), dataclasses.replace(
        cfg, **change)).solve_batch(0.0, torch.as_tensor(x0s),
                                    torch.as_tensor(us0))
    ref = DDPSolver(make_cartpole_problem(DT), cfg).solve_batch(
        0.0, torch.as_tensor(x0s), torch.as_tensor(us0))
    assert torch.equal(got.status, ref.status)
    assert torch.equal(got.iters, ref.iters)
    assert torch.equal(got.us, ref.us)


@pytest.mark.parametrize("device,dtype,second,nx_nu,impl,want", [
    ("cuda", torch.float32, False, (4, 1), "auto", "remat"),
    ("cuda", torch.float64, False, (4, 1), "auto", "remat"),
    ("cpu", torch.float32, False, (4, 1), "auto", "stacked"),
    ("cuda", torch.float32, True, (4, 1), "auto", "stacked"),
    ("cuda", torch.float32, False, (12, 2), "auto", "stacked"),
    ("cuda", torch.float16, False, (4, 1), "auto", "stacked"),
    ("cpu", torch.float32, False, (4, 1), "pallas", "pallas"),
    ("cuda", torch.float32, True, (4, 1), "pallas", NotImplementedError),
    ("cpu", torch.float64, True, (4, 1), "pallas", NotImplementedError),
    ("cuda", torch.float32, True, (4, 1), "stacked", "stacked"),
    ("cpu", torch.float32, False, (4, 1), "remat", "remat"),
    ("cuda", torch.float32, True, (4, 1), "remat", NotImplementedError),
    ("cuda", torch.float32, False, (6, 2), "remat", TileEvalError),
    ("cuda", torch.float32, False, (6, 2), "auto", "pallas"),
])
def test_auto_backward_rule(device, dtype, second, nx_nu, impl, want):
    """``auto`` takes a CUDA kernel only on CUDA tensors, first order and
    unboxed: the remat kernel where the generator takes the problem, else
    the sweep-fed kernel within its limits (nx <= 9, nu <= 16, float32 or
    float64: a problem the generator rejects at (6, 2) takes it, one at
    (12, 2) the plain backward); no B % 128 condition.  An explicit
    ``"pallas"`` or ``"remat"`` on a second-order
    solve raises rather than running a plain version in the kernel's
    place, and so does ``"remat"`` on a problem whose callables do not
    generate at its (nx, nu)."""
    p = make_cartpole_problem(DT)
    p = type(p)(**{**p.__dict__, "state_dim": nx_nu[0],
                   "input_dim": nx_nu[1]})
    cfg = DDPConfig(backward_impl=impl)
    resolve = lambda: _resolve_backward_impl(cfg, p, dtype,
                                             torch.device(device),
                                             boxed=False, second=second)
    if want is NotImplementedError:
        with pytest.raises(NotImplementedError, match="ROADMAP B1"):
            resolve()
    elif want is TileEvalError:
        with pytest.raises(TileEvalError):
            resolve()
    else:
        assert resolve() == want


@pytest.mark.parametrize("device,forward_impl,cdtype,want", [
    ("cuda", "auto", torch.float32, "fused"),
    ("cpu", "auto", torch.float32, "scan"),
    ("cuda", "auto", torch.float64, "scan"),
    ("cuda", "scan", torch.float32, "scan"),
    ("cpu", "fused", torch.float32, "fused"),
    ("cuda", "fused", torch.float64, ValueError),
])
def test_auto_forward_rule(device, forward_impl, cdtype, want):
    """``auto`` takes the fused rollouts on CUDA tensors when the costs
    sum at the solve dtype (fp32 here); an explicit ``"fused"`` whose
    costs would sum wider raises."""
    cfg = DDPConfig(forward_impl=forward_impl)
    resolve = lambda: _resolve_forward_impl(
        cfg, make_cartpole_problem(DT), torch.float32, torch.device(device),
        cdtype)
    if want is ValueError:
        with pytest.raises(ValueError, match="solve dtype"):
            resolve()
    else:
        assert resolve() == want


def test_constant_analytic_derivatives_solve():
    """A linear problem whose analytic derivative callables return
    constants solves like the same problem on autodiff derivatives (the
    lane batching once returned tensors of garbage shape for outputs that
    do not depend on the lane)."""
    from nmpc_tpu_torch.core.problem import Problem

    rng = np.random.default_rng(4)
    A = torch.as_tensor(np.eye(2) + 0.1 * rng.normal(size=(2, 2)))
    Bm = torch.as_tensor(0.1 * rng.normal(size=(2, 1)))
    base = dict(
        dt=0.1, state_dim=2, input_dim=1,
        dynamics=lambda t, x, u: A @ x + Bm @ u,
        running_cost=lambda t, x, u: 0.5 * (x @ x) + 0.05 * (u @ u),
        terminal_cost=lambda t, x: 0.5 * (x @ x))
    analytic = Problem(**base, dynamics_derivs=lambda t, x, u: (A, Bm),
                       running_cost_derivs=lambda t, x, u: (
                           x, 0.1 * u, torch.eye(2, dtype=x.dtype),
                           0.1 * torch.eye(1, dtype=x.dtype),
                           torch.zeros((2, 1), dtype=x.dtype)))
    x0s = torch.as_tensor(rng.normal(size=(3, 2)))
    us0 = torch.zeros((3, 15, 1), dtype=torch.float64)
    cfg = DDPConfig(horizon_steps=15, max_iter=10)
    got = DDPSolver(analytic, cfg).solve_batch(0.0, x0s, us0)
    ref = DDPSolver(Problem(**base), cfg).solve_batch(0.0, x0s, us0)
    assert (got.status == DDPStatus.SUCCEEDED).all()
    assert torch.equal(got.iters, ref.iters)
    np.testing.assert_allclose(got.us.numpy(), ref.us.numpy(), atol=1e-10,
                               rtol=0)
