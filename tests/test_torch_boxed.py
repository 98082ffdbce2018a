"""Boxed DDP in the port (``with_input_constraint``) against the JAX package
on the same numpy inputs, on CPU tensors: the plain boxed backward
(``backward_stacked_boxed``), the boxed kernels' entry points (K4
``backward_fused_boxed`` and K5 ``backward_remat(boxed=True)``, which run
their plain versions on CPU) against the JAX Pallas kernels in interpret
mode, the generator's masked fields and bounds (the aux group), boxed
``solve_batch`` on the vertical-motion and cart-pole models, and the
vertical tick loop."""

import ctypes
import dataclasses
import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nmpc_tpu import DDPConfig as JaxConfig
from nmpc_tpu import DDPSolver as JaxSolver
from nmpc_tpu.core.types import BoxQPConfig as JaxBoxQPConfig
from nmpc_tpu.kernels.ddp_backward import (
    StackedBounds as JaxBounds, StackedDerivs as JaxDerivs,
    backward_stacked_boxed as jax_backward_stacked_boxed)
from nmpc_tpu.kernels.ddp_backward_pallas import backward_pallas_boxed
from nmpc_tpu.kernels.ddp_backward_remat import (
    backward_remat as jax_backward_remat)
from nmpc_tpu.kernels.lanes import block_lanes, lane_factors
from nmpc_tpu.models import cartpole as jax_cp
from nmpc_tpu.models import vertical as jax_vert
from nmpc_tpu.mpc.closed_loop import make_closed_loop_batch as jax_loop
from nmpc_tpu.solvers import ddp as jax_ddp
from nmpc_tpu_torch import DDPConfig, DDPSolver
from nmpc_tpu_torch.convert import (ddp_config_from_reference,
                                    result_to_numpy,
                                    vertical_problem_from_reference)
from nmpc_tpu_torch.kernels import tileval
from nmpc_tpu_torch.kernels.ddp_backward import (StackedBounds, StackedDerivs,
                                                 backward_stacked_boxed)
from nmpc_tpu_torch.kernels.ddp_backward_boxed import backward_fused_boxed
from nmpc_tpu_torch.kernels.ddp_backward_remat import backward_remat
from nmpc_tpu_torch.kernels.tileval import TileEvalError
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.models.vertical import make_vertical_problem, num_contacts
from nmpc_tpu_torch.mpc.closed_loop import make_closed_loop_batch
from nmpc_tpu_torch.solvers import ddp, stages

from test_torch_ddp_solve import _jax_numpy

torch.set_num_threads(1)

DT = 0.01
FORCE = (0.0, 30.0)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _t(a):
    return torch.as_tensor(np.array(a)).contiguous()


def _vertical_case(N, B, dtype, seed, t0=0.0, **cfg):
    """First-iteration boxed backward data of the vertical model (the
    construction of test_pallas_kernels.py::_boxed_backward_case): x0 near
    1.2 m, small random forces.  Returns (JAX config, JAX (D, bounds,
    VxT, VxxT, t0, xs, us), the same as torch tensors)."""
    p = jax_vert.make_vertical_problem(DT)
    jc = JaxConfig(horizon_steps=N, max_iter=3, initial_lambda=1e-6,
                   with_input_constraint=True, **cfg)
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray((np.tile([1.2, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 2))).astype(dtype))
    us0 = jnp.asarray((0.02 * rng.normal(size=(B, N, 2))).astype(dtype))
    t0 = jnp.asarray(t0, dtype)
    S, L = lane_factors(B)
    xs_l, _ = jax_ddp._rollout_lanes(p, jc, t0, block_lanes(x0s, 0, S, L),
                                     block_lanes(us0, 0, S, L))
    us_l = block_lanes(us0, 0, S, L)
    D, VxT, VxxT = jax_ddp._derivative_sweep_lanes(p, jc, t0, xs_l, us_l)
    flat = lambda a: a.reshape(a.shape[:-2] + (B,))
    jD = JaxDerivs(*(flat(getattr(D, f)) for f in JaxDerivs._fields))
    jB = JaxBounds(lower=flat(D.lower), upper=flat(D.upper), u=flat(D.u))
    jax_side = (jD, jB, flat(VxT), flat(VxxT), t0, flat(xs_l), flat(us_l))
    torch_side = (StackedDerivs(*map(_t, jD)), StackedBounds(*map(_t, jB)),
                  _t(flat(VxT)), _t(flat(VxxT)), float(t0), _t(flat(xs_l)),
                  _t(flat(us_l)))
    return jc, jax_side, torch_side


def _norm_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (1.0 + np.abs(a).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("reg_type,lam", [(1, 1e-6), (2, 0.3)])
def test_backward_stacked_boxed_matches_jax(dtype, reg_type, lam):
    """The plain boxed backward vs JAX's on vertical data (N=20, B=128,
    masked inputs, the default BoxQPConfig): ok equal; at fp32 ks and Ks
    within 3e-6 normalized (max|a-b| / (1 + max|a|); the reg_type 2 Ks run
    to ~1e3) and dV within 2e-4; at fp64 everything within 1e-12."""
    jc, (jD, jB, jVx, jVxx, *_), (D, bnd, Vx, Vxx, *_) = _vertical_case(
        20, 128, dtype, seed=0, reg_type=reg_type)
    lam_np = np.full(128, lam, dtype)
    want = jax_backward_stacked_boxed(jc, jD, jB, jVx, jVxx,
                                      jnp.asarray(lam_np))
    got = backward_stacked_boxed(ddp_config_from_reference(jc), D, bnd, Vx,
                                 Vxx, _t(lam_np))
    tols = (3e-6, 3e-6, 2e-4) if dtype == np.float32 else (1e-12,) * 3
    for a, b, tol in zip(want[:3], got[:3], tols):
        assert _norm_err(a, b.numpy()) <= tol
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3].dtype == torch.bool


def test_k4_entry_matches_jax_kernel(interpret_pallas):
    """``backward_fused_boxed`` (K4's entry; on CPU its plain version) vs
    JAX's ``backward_pallas_boxed`` in interpret mode on the data of
    test_pallas_boxed_backward_matches_stacked (max_ls_iter=16): ks, Ks,
    dV within 3e-6, ok equal; both regularization types."""
    for reg_type, lam in ((1, 1e-6), (2, 0.3)):
        jc, (jD, jB, jVx, jVxx, *_), (D, bnd, Vx, Vxx, *_) = _vertical_case(
            20, 128, np.float32, seed=0, reg_type=reg_type,
            boxqp=JaxBoxQPConfig(max_ls_iter=16))
        lam_np = np.full(128, lam, np.float32)
        want = backward_pallas_boxed(jc, jD, jB, jVx, jVxx,
                                     jnp.asarray(lam_np))
        before = backward_fused_boxed.launches
        got = backward_fused_boxed(ddp_config_from_reference(jc), D, bnd, Vx,
                                   Vxx, _t(lam_np))
        assert backward_fused_boxed.launches == before   # no launch on CPU
        for a, b in zip(want[:3], got[:3]):
            assert _norm_err(a, b.numpy()) <= 3e-6
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_remat_boxed_entry_matches_jax_kernel(interpret_pallas):
    """``backward_remat(boxed=True)`` vs JAX's in interpret mode on the
    data of test_remat_backward_boxed_matches_stacked (N=12, B=128, seed
    1): ks, Ks within 2e-5, dV within 2e-4, ok equal.  The bounds come
    from the problem's limits and mask on both sides."""
    jc, (_, _, jVx, jVxx, t0, jxs, jus), (_, _, Vx, Vxx, _, xs, us) = (
        _vertical_case(12, 128, np.float32, seed=1))
    lam_np = np.full(128, 1e-6, np.float32)
    want = jax_backward_remat(jax_vert.make_vertical_problem(DT), jc, t0,
                              jxs, jus, jVx, jVxx, jnp.asarray(lam_np),
                              boxed=True)
    got = backward_remat(make_vertical_problem(DT),
                         ddp_config_from_reference(jc), 0.0, xs, us, Vx,
                         Vxx, _t(lam_np), boxed=True)
    for a, b, tol in zip(want[:3], got[:3], (2e-5, 2e-5, 2e-4)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol,
                                   rtol=0)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def _lane_inputs(nx, nu, B, dtype, seed=0):
    """Stage times across every contact switch of the vertical model,
    states and inputs inside and outside the force box."""
    rng = np.random.default_rng(seed)
    t = torch.as_tensor(np.concatenate([[1.999999, 2.0, 2.999999, 3.0, 4.5,
                                         5.0, 7.999999, 8.0],
                                        rng.uniform(0, 9, B - 8)]),
                        dtype=dtype)
    x = torch.as_tensor(rng.normal(size=(nx, B)), dtype=dtype)
    u = torch.as_tensor(20 * rng.normal(size=(nu, B)), dtype=dtype)
    named = {"t": t, **{f"x_{a}": x[a] for a in range(nx)},
             **{f"u_{a}": u[a] for a in range(nu)}}
    return t, x, u, named


def _boxed_problems():
    return ((make_vertical_problem(DT), 2, 2),
            (make_cartpole_problem(DT, input_limits=(-15.0, 15.0)), 4, 1),
            (make_vertical_problem(DT, with_limits=False), 2, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_generated_fields_and_aux_match_stage_derivs(dtype):
    """The generator's ``remat_boxed`` unit (masked fields and the aux
    group's bounds) through its evaluator vs ``_stage_derivs`` with mask
    and bounds, for the vertical model (with and without limits: +-inf)
    and the boxed cart-pole: bit for bit at fp32, within 1e-12 at fp64."""
    cfg = DDPConfig(horizon_steps=1, with_input_constraint=True)
    for p, nx, nu in _boxed_problems():
        t, x, u, named = _lane_inputs(nx, nu, 64, dtype)
        unit = tileval.generate(p, "remat_boxed", nx, nu, dtype)
        got = torch.cat([torch.stack(prog.evaluate(outs, named, t))
                         for prog, outs in (unit.functions["fields"],
                                            unit.functions["aux"])])
        D = torch.func.vmap(lambda tt, xx, uu: stages._stage_derivs(
            p, cfg, tt, xx, uu), in_dims=(0, 1, 1))(t, x, u)
        # per lane: the 7 fields, then lower and upper (u rides along)
        ref = torch.cat([a.reshape(64, -1) for a in D[:9]], dim=1).T
        tol = 0.0 if dtype == torch.float32 else 1e-12
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=tol)
    assert not tileval.tile_supported(dataclasses.replace(
        make_vertical_problem(DT), input_limits=lambda t: (
            torch.zeros(int(t.sum() > 1) + 1), torch.ones(2))),
        "remat_boxed", 2, 2, torch.float64)


_HARNESS = """
extern "C" void run(int B, const double* t, const double* x, const double* u,
                    double* out) {{
  for (int b = 0; b < B; ++b) {{
    double xb[{nx}], ub[{nu}], o[{nf} + 2 * {nu}];
    for (int a = 0; a < {nx}; ++a) xb[a] = x[a * B + b];
    for (int a = 0; a < {nu}; ++a) ub[a] = u[a * B + b];
    gen_fields<double>(t[b], xb, ub, o);
    gen_aux<double>(t[b], xb, ub, o + {nf});
    for (int k = 0; k < {nf} + 2 * {nu}; ++k) out[k * B + b] = o[k];
  }}
}}
"""


def test_generated_boxed_unit_as_host_cpp(tmp_path):
    """The emitted ``gen_fields`` and ``gen_aux`` of the vertical model,
    compiled by g++ as host code at fp64, vs the evaluator: 1e-12."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ on PATH")
    p, nx, nu = make_vertical_problem(DT), 2, 2
    unit = tileval.generate(p, "remat_boxed", nx, nu, torch.float64)
    nf = len(unit.functions["fields"][1])
    src = tmp_path / "gen.cpp"
    src.write_text(unit.cpp + _HARNESS.format(nx=nx, nu=nu, nf=nf))
    lib = tmp_path / "libgen.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    t, x, u, named = _lane_inputs(nx, nu, 32, torch.float64, seed=5)
    out = torch.empty((nf + 2 * nu, 32), dtype=torch.float64)
    ptr = lambda a: ctypes.c_void_p(a.contiguous().data_ptr())
    ctypes.CDLL(str(lib)).run(32, ptr(t), ptr(x), ptr(u), ptr(out))
    want = torch.cat([torch.stack(prog.evaluate(outs, named, t))
                      for prog, outs in (unit.functions["fields"],
                                         unit.functions["aux"])])
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=1e-12)


def _check_box(us, ts):
    """Every first-stage u inside [0, 30] and every masked-out u exactly 0
    (us [B, N, 2] numpy, ts [N] stage times).  The box binds the QP's
    feedforward: the first stage, which a controller applies, has dx = 0;
    later stages add the forward pass's unclipped feedback K dx, as in
    the JAX package and the reference, and may leave the box."""
    assert us[:, 0].min() >= FORCE[0] and us[:, 0].max() <= FORCE[1]
    n = num_contacts(torch.as_tensor(ts)).numpy()
    for i, k in enumerate(n):
        assert (us[:, i, k:] == 0).all()


def _vertical_solve_both(dtype, t0, B=128, N=20, seed=1, **cfg):
    rng = np.random.default_rng(seed)
    x0s = (np.tile([1.2, 0.0], (B, 1))
           + 0.05 * rng.normal(size=(B, 2))).astype(dtype)
    us0 = np.zeros((B, N, 2), dtype)
    jc = JaxConfig(horizon_steps=N, max_iter=3, initial_lambda=1e-6,
                   with_input_constraint=True, **cfg)
    jr = JaxSolver(jax_vert.make_vertical_problem(DT), jc).solve_batch(
        jnp.asarray(t0, dtype), jnp.asarray(x0s), jnp.asarray(us0))
    solver = DDPSolver(make_vertical_problem(DT), ddp_config_from_reference(jc))
    tr = result_to_numpy(solver.solve_batch(t0, torch.as_tensor(x0s),
                                            torch.as_tensor(us0)))
    return _jax_numpy(jr), tr, solver.host_syncs


@pytest.mark.parametrize("t0", [0.0, 1.9])
def test_vertical_solve_matches_jax_fp64(t0):
    """Boxed vertical ``solve_batch`` at fp64 (N=20, B=128, 3 iterations;
    from t0=1.9 the horizon crosses the switch to two contacts at t=2):
    statuses and iterations equal, us and xs within 1e-8, the trace rows as
    in test_solve_batch_matches_jax_fp64; every first-stage u inside
    [0, 30] and every masked u exactly 0.  The plain QP's loops read their
    device flags through the solver's counted host reads."""
    jr, tr, syncs = _vertical_solve_both(np.float64, t0)
    np.testing.assert_array_equal(tr["status"], jr["status"])
    np.testing.assert_array_equal(tr["iters"], jr["iters"])
    np.testing.assert_allclose(tr["us"], jr["us"], atol=1e-8, rtol=0)
    np.testing.assert_allclose(tr["xs"], jr["xs"], atol=1e-8, rtol=0)
    a, b = tr["trace"], jr["trace"]
    for name in ("cost", "lam", "dlam", "alpha", "cost_update_expected"):
        np.testing.assert_allclose(a[name], b[name], rtol=1e-10, err_msg=name)
    for name in ("k_rel_norm", "cost_update_actual"):
        floor = 1e-12 * np.abs(b[name]).max()
        np.testing.assert_allclose(a[name], b[name], rtol=1e-10, atol=floor,
                                   err_msg=name)
    _check_box(tr["us"], t0 + DT * np.arange(20))
    assert syncs > 3 * 20     # QP trips of every stage, every iteration


@pytest.mark.parametrize("t0", [0.0, 1.9])
def test_vertical_solve_matches_jax_fp32(t0):
    """Boxed vertical ``solve_batch`` at fp32, the same batch.  The first
    costs differ from JAX's by an ulp (summation order), and by the second
    iteration the cost updates are a few ulp of the cost (the problem is
    nearly linear-quadratic), so an accept decision can part on rounding
    (ROADMAP §C).  Held: the end-to-end contract (u normalized <= 1e-2,
    cost rel <= 1e-4); on every lane whose statuses, iterations and alphas
    agree, us within 2e-5; every lane that parts does so where its cost
    update is at most 16 ulp of its cost; the box and the mask."""
    jr, tr, _ = _vertical_solve_both(np.float32, t0)
    same = ((tr["status"] == jr["status"]) & (tr["iters"] == jr["iters"])
            & (tr["trace"]["alpha"] == jr["trace"]["alpha"]).all(axis=1))
    assert same.sum() >= len(same) // 2
    np.testing.assert_allclose(tr["us"][same], jr["us"][same], atol=2e-5,
                               rtol=0)
    for lane in np.nonzero(~same)[0]:
        j = int(np.argmax((tr["trace"]["alpha"][lane]
                           != jr["trace"]["alpha"][lane])))
        if tr["trace"]["alpha"][lane, j] == jr["trace"]["alpha"][lane, j]:
            j = int(min(tr["iters"][lane], jr["iters"][lane]))
        ulp = np.spacing(np.float32(jr["trace"]["cost"][lane, j - 1]))
        update = max(abs(tr["trace"]["cost_update_actual"][lane, j]),
                     abs(jr["trace"]["cost_update_actual"][lane, j]))
        assert update <= 16 * ulp, (lane, j, update / ulp)
    assert _norm_err(jr["us"], tr["us"]) <= 1e-2
    ca, cb = (r["costs"].astype(np.float64).sum(1) for r in (jr, tr))
    assert (np.abs(ca - cb) / (1 + np.abs(ca))).max() <= 1e-4
    _check_box(tr["us"], t0 + DT * np.arange(20))


def test_boxed_cartpole_matches_jax_fp64():
    """Cart-pole with the force limited to (-15, 15) (tests/test_ddp_models.
    py:86), N=40, 10 iterations, fp64: statuses and iterations equal, us
    and xs within 1e-8; the limits bind, and every first-stage u stays
    inside them."""
    B, N = 16, 40
    rng = np.random.default_rng(0)
    x0s = np.tile([0.0, np.pi, 0.0, 0.0], (B, 1)) + 0.1 * rng.normal(
        size=(B, 4))
    us0 = np.zeros((B, N, 1))
    jc = JaxConfig(horizon_steps=N, max_iter=10, with_input_constraint=True)
    jr = JaxSolver(jax_cp.make_cartpole_problem(DT, input_limits=(-15., 15.)),
                   jc).solve_batch(0.0, jnp.asarray(x0s), jnp.asarray(us0))
    tr = result_to_numpy(DDPSolver(
        make_cartpole_problem(DT, input_limits=(-15.0, 15.0)),
        ddp_config_from_reference(jc)).solve_batch(
            0.0, torch.as_tensor(x0s), torch.as_tensor(us0)))
    np.testing.assert_array_equal(tr["status"], np.asarray(jr.status))
    np.testing.assert_array_equal(tr["iters"], np.asarray(jr.iters))
    np.testing.assert_allclose(tr["us"], np.asarray(jr.us), atol=1e-8, rtol=0)
    np.testing.assert_allclose(tr["xs"], np.asarray(jr.xs), atol=1e-8, rtol=0)
    assert (np.abs(tr["us"][:, 0]) <= 15.0).all()
    assert (np.abs(tr["us"]) == 15.0).any()


@pytest.mark.parametrize("impls", [("pallas", "scan"), ("remat", "fused"),
                                   ("remat", "scan")])
def test_boxed_kernel_paths_run_their_plain_versions_on_cpu(impls):
    """The boxed kernel paths (K4; K5 boxed with or without the fused
    rollouts) on CPU tensors solve through their plain versions: the same
    result as the plain path, bit for bit, at fp64, with no launch."""
    B, N = 8, 20
    rng = np.random.default_rng(4)
    x0s = torch.as_tensor(np.tile([1.2, 0.0], (B, 1))
                          + 0.05 * rng.normal(size=(B, 2)))
    us0 = torch.zeros((B, N, 2), dtype=torch.float64)
    cfg = DDPConfig(horizon_steps=N, max_iter=3, initial_lambda=1e-6,
                    with_input_constraint=True)
    counts = (backward_fused_boxed.launches, backward_remat.boxed_launches)
    got = DDPSolver(make_vertical_problem(DT), dataclasses.replace(
        cfg, backward_impl=impls[0], forward_impl=impls[1])).solve_batch(
            1.9, x0s, us0)
    ref = DDPSolver(make_vertical_problem(DT), dataclasses.replace(
        cfg, backward_impl="stacked", forward_impl="scan")).solve_batch(
            1.9, x0s, us0)
    assert (backward_fused_boxed.launches,
            backward_remat.boxed_launches) == counts
    assert torch.equal(got.status, ref.status)
    assert torch.equal(got.iters, ref.iters)
    assert torch.equal(got.us, ref.us)


@pytest.mark.parametrize("device,nu,impl,rejected,want", [
    ("cuda", 2, "auto", False, "remat"),
    ("cuda", 2, "auto", True, "pallas"),
    ("cuda", 5, "auto", False, "pallas"),
    ("cpu", 2, "auto", False, "stacked"),
    ("cuda", 2, "pallas", False, "pallas"),
    ("cuda", 5, "pallas", False, "pallas"),
    ("cuda", 5, "remat", False, NotImplementedError),
    ("cuda", 2, "remat", True, TileEvalError),
    ("cuda", 5, "stacked", False, "stacked"),
])
def test_boxed_backward_rule(device, nu, impl, rejected, want):
    """``auto`` on a boxed solve takes the boxed remat kernel (K5) where the
    generator takes the problem with its limits and mask, else the
    sweep-fed boxed kernel (K4); at nu > 4, past K5 boxed's limit, ``auto``
    and an explicit ``"pallas"`` take K4 (its wide unit) where JAX's rule
    keeps the plain path, and an explicit ``"remat"`` raises (ROADMAP B7);
    an explicit ``"remat"`` on a problem the generator rejects raises."""
    p = make_vertical_problem(DT)
    if nu != 2:
        p = dataclasses.replace(p, input_dim=nu, input_mask=None,
                                input_limits=lambda t: (torch.zeros(nu),
                                                        torch.ones(nu)))
    if rejected:
        base = p.input_limits
        p = dataclasses.replace(p, input_limits=lambda t: base(t) if float(
            t) >= 0 else None)
    cfg = DDPConfig(backward_impl=impl, with_input_constraint=True)
    resolve = lambda: ddp._resolve_backward_impl(
        cfg, p, torch.float32, torch.device(device), True, False)
    if want is NotImplementedError:
        with pytest.raises(NotImplementedError, match="ROADMAP B7"):
            resolve()
    elif want is TileEvalError:
        with pytest.raises(TileEvalError):
            resolve()
    else:
        assert resolve() == want


def test_vertical_tick_loop_matches_jax():
    """``make_closed_loop_batch`` on the boxed vertical model (B=8, N=30,
    5 ticks from t0=1.67: the horizon's end crosses the switch to two
    contacts at the third tick, where the warm-start shift meets a change
    of the terminal mask) vs the JAX loop at fp64: iterations and
    statuses equal, xs and us within 1e-8; every applied u (a solve's
    first stage) inside [0, 30], masked ones exactly 0."""
    B, N, ticks, t0 = 8, 30, 5, 1.67
    t_end = [t0 + DT * (k + 1) + N * DT for k in range(ticks)]
    assert [int(num_contacts(torch.tensor(t))) for t in t_end] == [
        1, 1, 2, 2, 2]
    rng = np.random.default_rng(0)
    x0s = np.tile([1.2, 0.0], (B, 1)) + 0.05 * rng.normal(size=(B, 2))
    us0 = np.zeros((B, N, 2))
    jc = JaxConfig(horizon_steps=N, max_iter=3, initial_lambda=1e-6,
                   with_input_constraint=True)
    ref = jax_loop(JaxSolver(jax_vert.make_vertical_problem(DT), jc),
                   n_steps=ticks)(t0, jnp.asarray(x0s), jnp.asarray(us0))
    log = make_closed_loop_batch(
        DDPSolver(make_vertical_problem(DT), ddp_config_from_reference(jc)),
        n_steps=ticks)(t0, torch.as_tensor(x0s), torch.as_tensor(us0))
    np.testing.assert_array_equal(log.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(log.status.numpy(), np.asarray(ref.status))
    np.testing.assert_allclose(log.xs.numpy(), np.asarray(ref.xs), atol=1e-8,
                               rtol=0)
    np.testing.assert_allclose(log.us.numpy(), np.asarray(ref.us), atol=1e-8,
                               rtol=0)
    us = log.us.numpy()          # each tick's applied, first-stage u
    assert us.min() >= FORCE[0] and us.max() <= FORCE[1]
    _check_box(us, log.ts.numpy())


def test_vertical_model_matches_jax():
    """The port's vertical model built from the JAX parameter dataclass
    (``convert.py``) vs the JAX model: contact count and mask across every
    switch, dynamics and costs at fp64 (1e-14), limits."""
    w = jax_vert.VerticalCostWeight(running_x=(2.0, 1e-2), running_u=3e-4)
    ref = jax_vert.make_vertical_problem(0.02, cost_weight=w,
                                         force_limits=(1.0, 25.0))
    got = vertical_problem_from_reference(0.02, w, force_limits=(1.0, 25.0))
    rng = np.random.default_rng(2)
    for t in (0.0, 1.999998, 1.999999, 2.0, 2.5, 2.999999, 3.0, 4.5,
              4.6, 5.0, 7.999999, 8.0, 9.0):
        tt = torch.tensor(t, dtype=torch.float64)
        assert int(num_contacts(tt)) == int(jax_vert.num_contacts(t))
        np.testing.assert_array_equal(got.input_mask(tt).numpy(),
                                      np.asarray(ref.input_mask(t)))
        x, u = rng.normal(size=2), 10 * rng.normal(size=2)
        for name in ("dynamics", "running_cost"):
            np.testing.assert_allclose(
                getattr(got, name)(tt, torch.as_tensor(x),
                                   torch.as_tensor(u)).numpy(),
                np.asarray(getattr(ref, name)(t, jnp.asarray(x),
                                              jnp.asarray(u))), rtol=1e-14)
        np.testing.assert_allclose(
            float(got.terminal_cost(tt, torch.as_tensor(x))),
            float(ref.terminal_cost(t, jnp.asarray(x))), rtol=1e-14)
        for a, b in zip(got.input_limits(tt), ref.input_limits(t)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
