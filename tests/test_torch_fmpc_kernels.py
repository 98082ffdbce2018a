"""FMPC's per-stage pieces and its kernels' plain versions in the port
against the JAX package on the same numpy inputs, on CPU tensors:
``linearize_ineq``, ``_inv_bl``, the coefficient sweep and the KKT error,
the condensed Riccati backward (``_backward_bm`` and K8's entry
``backward_fmpc_fused``, which runs its plain version on CPU) against
JAX's ``_backward_bm`` and its Pallas kernel in interpret mode, and the
Δx/Δu recursion (K11's plain version and entry) against the JAX scan and
its Pallas kernel."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from nmpc_tpu.core.problem import Problem as JaxProblem
from nmpc_tpu.core.types import FmpcConfig as JaxFmpcConfig
from nmpc_tpu.core.types import FmpcVariable as JaxVariable
from nmpc_tpu.kernels.ddp_backward import _mv as jax_mv
from nmpc_tpu.kernels.fmpc_backward_pallas import backward_fmpc_pallas
from nmpc_tpu.kernels.fmpc_forward_pallas import forward_fmpc_deltas_pallas
from nmpc_tpu.models import cartpole as jax_cp
from nmpc_tpu.models.oscillator import make_oscillator_problem as jax_osc
from nmpc_tpu.solvers import fmpc as JF
from nmpc_tpu.solvers.parallel_riccati import _inv_bl as jax_inv_bl
from nmpc_tpu_torch.convert import (cartpole_fmpc_problem_from_reference,
                                    fmpc_config_from_reference,
                                    fmpc_variable_from_numpy,
                                    oscillator_problem_from_reference)
from nmpc_tpu_torch.core.problem import Problem
from nmpc_tpu_torch.kernels.fmpc_backward import backward_fmpc_fused
from nmpc_tpu_torch.kernels.fmpc_forward import (forward_fmpc_deltas_fused,
                                                 forward_fmpc_deltas_plain)
from nmpc_tpu_torch.kernels.linalg import _inv_bl
from nmpc_tpu_torch.solvers import fmpc as F
from nmpc_tpu_torch.solvers.stages import _stage_times

torch.set_num_threads(1)

DT = 0.01
# kernel / plain version vs JAX (tests/test_pallas_kernels.py:583)
TOL = {np.float32: 3e-5, np.float64: 1e-12}


@pytest.fixture()
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _t(a):
    return torch.as_tensor(np.array(a)).contiguous()


def two_input_problems():
    """A synthetic nx=2, nu=2, ng=2 linear problem, so that G is a genuine
    2x2 block and the Gauss-Jordan fallback pivots
    (``tests/test_pallas_kernels.py::_make_two_input_problem``), in both
    packages."""
    dt = 0.02
    A = [[1.0, dt], [-0.3 * dt, 1.0 - 0.1 * dt]]
    Bm = [[0.5 * dt, 0.0], [dt, 0.7 * dt]]
    rc = lambda s: lambda t, x, u: 0.5 * (s(x * x) + 0.1 * s(u * u))
    jax_p = JaxProblem(
        dt=dt, state_dim=2, input_dim=2, ineq_dim=2,
        dynamics=lambda t, x, u: (jnp.array(A, x.dtype) @ x
                                  + jnp.array(Bm, x.dtype) @ u),
        running_cost=rc(jnp.sum),
        terminal_cost=lambda t, x: 0.5 * jnp.sum(x * x),
        ineq_const=lambda t, x, u: jnp.array([u[0] - 1.0, -u[1] - 1.0],
                                             x.dtype))
    port_p = Problem(
        dt=dt, state_dim=2, input_dim=2, ineq_dim=2,
        dynamics=lambda t, x, u: (torch.tensor(A, dtype=x.dtype) @ x
                                  + torch.tensor(Bm, dtype=x.dtype) @ u),
        running_cost=rc(torch.sum),
        terminal_cost=lambda t, x: 0.5 * torch.sum(x * x),
        ineq_const=lambda t, x, u: torch.stack([u[0] - 1.0, -u[1] - 1.0]))
    return jax_p, port_p


def problems(kind):
    """(JAX problem, port problem) of a model."""
    if kind == "oscillator":
        return jax_osc(DT), oscillator_problem_from_reference(DT)
    if kind == "cartpole":
        return (jax_cp.make_cartpole_fmpc_problem(DT),
                cartpole_fmpc_problem_from_reference(
                    DT, jax_cp.CartPoleParam(), jax_cp.CartPoleCostWeight()))
    return two_input_problems()


def _case(kind, N, B, dtype, seed, **cfg):
    """First-iteration data of ``tests/test_pallas_kernels.py::
    _fmpc_backward_case`` (random batch-minor iterate, s and nu in
    [0.2, 1.2)): (JAX problem, config, coefficients, variable, masks, eps)
    and the port's problem, config, JAX's coefficients as tensors, the
    variable, masks and eps."""
    jp, pp = problems(kind)
    nx, nu, ng = jp.state_dim, jp.input_dim, jp.ineq_dim
    rng = np.random.default_rng(seed)
    raw = dict(xs=0.3 * rng.normal(size=(N + 1, nx, B)),
               us=0.3 * rng.normal(size=(N, nu, B)),
               lambdas=0.3 * rng.normal(size=(N + 1, nx, B)),
               ss=0.2 + rng.uniform(size=(N, ng, B)),
               nus=0.2 + rng.uniform(size=(N, ng, B)))
    raw = {k: v.astype(dtype) for k, v in raw.items()}
    jc = JaxFmpcConfig(horizon_steps=N, max_iter=10, **cfg)
    jvar = JaxVariable(**{k: jnp.asarray(v) for k, v in raw.items()})
    t0 = jnp.asarray(0.0, dtype)
    ts = t0 + jp.dt * jnp.arange(N, dtype=dtype)
    jgms = jax.vmap(lambda t: jp.ineq_mask_at(t).astype(dtype))(ts)
    jeps = jnp.full((B,), 1e-4, dtype)
    jco = JF._coeffs_bm(jp, jc, t0, jvar)
    pvar = fmpc_variable_from_numpy("cpu", torch.float64 if dtype == np.float64
                                    else torch.float32, **raw)
    pco = F._StCoeffs(*map(_t, jco))
    return ((jp, jc, jco, jvar, jgms, jeps),
            (pp, fmpc_config_from_reference(jc), pco, pvar, _t(jgms),
             _t(jeps)))


def _norm_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (1.0 + np.abs(a).max())


@pytest.mark.parametrize("kind", ["oscillator", "cartpole"])
def test_linearize_ineq_matches_jax(kind):
    """``linearize_ineq`` (torch.func.jacfwd) vs ``jax.jacfwd`` at random
    points, and the all-set masks of a problem without masks."""
    jp, pp = problems(kind)
    rng = np.random.default_rng(1)
    for _ in range(4):
        x = rng.normal(size=jp.state_dim)
        u = rng.normal(size=jp.input_dim)
        C, D = pp.linearize_ineq(torch.tensor(0.3), torch.as_tensor(x),
                                 torch.as_tensor(u))
        jC, jD = jp.linearize_ineq(0.3, jnp.asarray(x), jnp.asarray(u))
        np.testing.assert_allclose(C.numpy(), np.asarray(jC), atol=1e-15)
        np.testing.assert_allclose(D.numpy(), np.asarray(jD), atol=1e-15)
    t = torch.tensor(0.3)
    assert pp.ineq_mask_at(t).tolist() == [True] * jp.ineq_dim
    assert pp.input_mask_at(t).tolist() == [True] * jp.input_dim


def test_inv_bl_matches_jax():
    """``_inv_bl`` vs JAX's on 1x1..4x4 blocks, including columns that force
    a pivot swap (a zero leading entry) and a singular lane (zero pivot ->
    1e-30, the same finite or infinite result as JAX)."""
    rng = np.random.default_rng(2)
    for n in (1, 2, 3, 4):
        A = rng.normal(size=(n, n, 16))
        A[0, 0, :4] = 0.0                        # swap at the first column
        A[:, :, 5] = 0.0                         # singular lane
        got = _inv_bl(torch.as_tensor(A)).numpy()
        want = np.asarray(jax_inv_bl(jnp.asarray(A)))
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)
        eye = np.einsum("ijb,jkb->ikb", A, got)[..., 6:]
        np.testing.assert_allclose(eye, np.repeat(np.eye(n)[..., None], 10,
                                                  -1), atol=1e-9)


@pytest.mark.parametrize("kind", ["oscillator", "cartpole", "two_input"])
def test_coeffs_and_kkt_match_jax(kind):
    """``_coeffs_bm`` and ``_kkt_error_bm`` vs JAX's at fp64, every field
    within 1e-13."""
    (jp, jc, jco, jvar, jgms, jeps), (pp, pc, _, pvar, gms, eps) = _case(
        kind, 12, 32, np.float64, seed=0)
    co = F._coeffs_bm(pp, pc, torch.tensor(0.0, dtype=torch.float64), pvar)
    for name, a, b in zip(F._StCoeffs._fields, jco, co):
        assert b.is_contiguous()
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-13,
                                   err_msg=name)
    x0 = np.random.default_rng(3).normal(size=(jp.state_dim, 32))
    want = JF._kkt_error_bm(jnp.asarray(x0), jvar, jco, jeps, jgms)
    got = F._kkt_error_bm(torch.as_tensor(x0), pvar, co, eps, gms)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


def _hold_backward(want, got, dtype):
    tol = TOL[dtype]
    for name, a, b in zip(("ks", "Ks", "svecs", "Ps"), want[:4], got[:4]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol,
                                   err_msg=name)
    for name, a, b in zip(("ok", "finite"), want[4:], got[4:]):
        assert b.dtype == torch.bool
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("break_if_llt_fails", [False, True])
def test_backward_matches_jax(interpret_pallas, dtype, break_if_llt_fails):
    """The plain ``_backward_bm`` and K8's entry (CPU: its plain version,
    no launch) vs JAX's ``_backward_bm`` and ``backward_fmpc_pallas`` in
    interpret mode, on the data of ``_fmpc_backward_case`` (oscillator,
    N=10, B=128) with lane 5 NaN-poisoned: ks, Ks, s, P within 3e-5 (fp32)
    or 1e-12 (fp64), ok and finite equal."""
    (jp, jc, jco, jvar, jgms, jeps), (pp, pc, co, var, gms, eps) = _case(
        "oscillator", 10, 128, dtype, seed=0,
        break_if_llt_fails=break_if_llt_fails)
    poison = np.asarray(jco.A).copy()
    poison[4, 0, 1, 5] = np.nan
    jco = jco._replace(A=jnp.asarray(poison))
    co = co._replace(A=_t(poison))
    want = JF._backward_bm(jp, jc, jco, jvar.ss, jvar.nus, jgms, jeps)
    got = F._backward_bm(pp, pc, co, var.ss, var.nus, gms, eps)
    _hold_backward(want, got, dtype)
    assert not bool(got[5][5]) and int(got[5].sum()) == 127
    before = backward_fmpc_fused.launches
    entry = backward_fmpc_fused(pp, pc, co, var.ss, var.nus, gms, eps)
    assert backward_fmpc_fused.launches == before      # no launch on CPU
    if dtype == np.float32:
        kern = backward_fmpc_pallas(jp, jc, jco, jvar.ss, jvar.nus, jgms,
                                    jeps)
        _hold_backward(kern, entry, dtype)
    _hold_backward(want, entry, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("break_if_llt_fails", [False, True])
def test_backward_nonpd_fallback_matches_jax(interpret_pallas, dtype,
                                             break_if_llt_fails):
    """The two-input non-PD case of ``tests/test_pallas_kernels.py:
    720-772`` (N=8, B=128, Luu = -400 I on stages 2 and 5 of half the
    lanes): with the fallback the Gauss-Jordan gains equal JAX's; with
    ``break_if_llt_fails`` the poisoned lanes fail and the rest do not.
    Plain version and K8's entry vs JAX's stacked backward (and, at fp32,
    its Pallas kernel in interpret mode, atol 5e-4 as there)."""
    (jp, jc, jco, jvar, jgms, jeps), (pp, pc, co, var, gms, eps) = _case(
        "two_input", 8, 128, dtype, seed=7,
        break_if_llt_fails=break_if_llt_fails)
    B = 128
    bad = np.zeros((8, 1, 1, B), dtype)
    bad[2, :, :, :B // 2] = 1.0
    bad[5, :, :, :B // 2] = 1.0
    eye = np.eye(2, dtype=dtype)[None, :, :, None]
    Luu = np.asarray(jco.Luu) * (1.0 - bad) + bad * (-400.0) * eye
    jco = jco._replace(Luu=jnp.asarray(Luu))
    co = co._replace(Luu=_t(Luu))
    want = JF._backward_bm(jp, jc, jco, jvar.ss, jvar.nus, jgms, jeps)
    for got in (F._backward_bm(pp, pc, co, var.ss, var.nus, gms, eps),
                backward_fmpc_fused(pp, pc, co, var.ss, var.nus, gms, eps)):
        _hold_backward(want, got, dtype)
        ok = got[4].numpy()
        if break_if_llt_fails:
            assert not ok[:B // 2].any() and ok[B // 2:].all()
        else:
            assert ok.all()
    if dtype == np.float32:
        kern = backward_fmpc_pallas(jp, jc, jco, jvar.ss, jvar.nus, jgms,
                                    jeps)
        for a, b in zip(kern[:4], got[:4]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-4)
        for a, b in zip(kern[4:], got[4:]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_forward_recursion_matches_jax(interpret_pallas, dtype):
    """K11's plain version and entry (CPU: plain, no launch) vs the JAX
    scan of ``_forward_bm`` (3e-5 / 1e-12) and, at fp32, the JAX Pallas
    kernel in interpret mode, on the random data of
    ``test_fmpc_forward_pallas_matches_scan`` (N=20, nx=4, nu=2, B=256)."""
    rng = np.random.default_rng(3)
    N, nx, nu, B = 20, 4, 2, 256
    f = lambda *s: (rng.normal(size=s) * 0.3).astype(dtype)
    A, Bm, xb = f(N, nx, nx, B), f(N, nx, nu, B), f(N, nx, B)
    ks, Ks, dx0 = f(N, nu, B), f(N, nu, nx, B), f(nx, B)

    def fstep(dx, inp):
        A_, Bm_, x_bar, k, K = inp
        du = jax_mv(K, dx) + k
        return jax_mv(A_, dx) + jax_mv(Bm_, du) + x_bar, (dx, du)

    jin = [jnp.asarray(a) for a in (A, Bm, xb, ks, Ks)]
    dx_T, (dxs, dus) = lax.scan(fstep, jnp.asarray(dx0), tuple(jin))
    want = (np.concatenate([np.asarray(dxs), np.asarray(dx_T)[None]]),
            np.asarray(dus))
    args = [_t(a) for a in (A, Bm, xb, ks, Ks, dx0)]
    before = forward_fmpc_deltas_fused.launches
    for got in (forward_fmpc_deltas_plain(*args),
                forward_fmpc_deltas_fused(*args)):
        for a, b in zip(want, got):
            np.testing.assert_allclose(b.numpy(), a, atol=TOL[dtype])
    assert forward_fmpc_deltas_fused.launches == before
    if dtype == np.float32:
        kern = forward_fmpc_deltas_pallas(*jin, jnp.asarray(dx0))
        for a, b in zip(kern, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5)


def test_kernel_entries_check_their_inputs():
    """The K8 and K11 entries raise on a wrong shape, a non-contiguous
    input or a device they do not take, before anything runs."""
    _, (pp, pc, co, var, gms, eps) = _case("oscillator", 4, 8, np.float64,
                                           seed=0)
    with pytest.raises(ValueError, match="shape"):
        backward_fmpc_fused(pp, pc, co, var.ss[:, :2], var.nus, gms, eps)
    with pytest.raises(ValueError, match="contiguous"):
        backward_fmpc_fused(pp, pc, co._replace(
            A=co.A.transpose(1, 2)), var.ss, var.nus, gms, eps)
    args = [co.A, co.B, co.x_bar, torch.zeros(4, 1, 8, dtype=torch.float64),
            torch.zeros(4, 1, 2, 8, dtype=torch.float64),
            torch.zeros(2, 8, dtype=torch.float64)]
    with pytest.raises(ValueError, match="dtype"):
        forward_fmpc_deltas_fused(*args[:-1], args[-1].float())
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        forward_fmpc_deltas_fused(*meta)
