"""The DMA and residency variants of the port's backward kernels on the CPU:
the chunked and packed sweep-fed DDP backward (K2, K3) and the resident and
packed FMPC backward (K9, K10).  On CPU tensors each wrapper runs its plain
version (K3's and K10's through their pack and unpack, so the offsets are
exercised here); they are held against the JAX package's Pallas kernels in
the same modes, in interpret mode, on the data of
``tests/test_pallas_kernels.py:142-209, 588-627`` and on seeded data at the
wide shape (2, 5), against JAX's ``backward_stacked`` at the centroidal
model's (9, 16), and the solvers' ``backward_dma`` / ``backward_variant``
keywords against the default solve (the centroidal model's too)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nmpc_tpu.kernels.ddp_backward_pallas as JP
from nmpc_tpu.core.types import DDPConfig as JaxDDPConfig
from nmpc_tpu.kernels import fmpc_backward_pallas as JFP
from nmpc_tpu.kernels.ddp_backward import StackedDerivs as JD_derivs
from nmpc_tpu.kernels.ddp_backward import backward_stacked as jax_stacked
from nmpc_tpu.kernels.ddp_backward import stack_derivs
from nmpc_tpu.models.cartpole import make_cartpole_problem as jax_cartpole
from nmpc_tpu.solvers import ddp as JD
from nmpc_tpu_torch import (DDPConfig, DDPSolver, FmpcConfig, FmpcSolver,
                            FmpcVariable, fmpc_variable_reset)
from nmpc_tpu_torch.convert import ddp_config_from_reference
from nmpc_tpu_torch.kernels import ddp_backward_fused as K
from nmpc_tpu_torch.kernels import fmpc_backward as KF
from nmpc_tpu_torch.kernels.ddp_backward import StackedDerivs, backward_stacked
from nmpc_tpu_torch.models.cartpole import (make_cartpole_fmpc_problem,
                                            make_cartpole_problem)
from nmpc_tpu_torch.models.centroidal import make_centroidal_problem
from nmpc_tpu_torch.models.oscillator import make_oscillator_problem
from nmpc_tpu_torch.models.vertical import make_vertical_problem
from nmpc_tpu_torch.solvers import fmpc as F
from test_torch_fmpc_kernels import _case, _hold_backward
from test_torch_k2k3_wide import _centroidal

torch.set_num_threads(1)

DT = 0.01


@pytest.fixture()
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _ddp_case(N, B, seed):
    """The first-iteration cart-pole data of ``tests/test_pallas_kernels.py:
    142-209`` (fp32): JAX's stacked derivatives, terminal expansion and
    lambda, and the same as CPU tensors."""
    p = jax_cartpole(DT)
    c = JaxDDPConfig(horizon_steps=N, max_iter=10)
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us = jnp.asarray(rng.normal(size=(B, N, 1)).astype(np.float32) * 0.2)
    xs, _ = JD._rollout_stacked(p, c, 0.0, x0s, us)
    Ds, VxT, VxxT = jax.vmap(functools.partial(JD._derivative_sweep, p, c),
                             in_axes=(None, 0, 0))(0.0, xs, us)
    S = stack_derivs(Ds.Fx, Ds.Fu, Ds.Lx, Ds.Lu, Ds.Lxx, Ds.Luu, Ds.Lxu)
    VxTs, VxxTs = jnp.moveaxis(VxT, 0, -1), jnp.moveaxis(VxxT, 0, -1)
    lam = jnp.full((B,), 1e-4, jnp.float32)
    t = lambda a: torch.as_tensor(np.array(a)).contiguous()
    port = (ddp_config_from_reference(c), StackedDerivs(*map(t, S)),
            t(VxTs), t(VxxTs), t(lam))
    return (c, S, VxTs, VxxTs, lam), port


def _spd(rng, shape, n):
    """[*shape, n, n] positive definite matrices, from a seed."""
    a = rng.normal(size=(*shape, n, n))
    return np.einsum("...ij,...kj->...ik", a, a) / n + np.eye(n)


def _wide_case(N, B, seed, nx=2, nu=5, dtype=np.float32):
    """Seeded batch-minor stage fields at a wide shape ((2, 5): nu > 4, so
    the port's kernels take their wide units) with Lxx, Luu positive
    definite, as the JAX and the port's arguments."""
    rng = np.random.default_rng(seed)
    last = lambda a: np.moveaxis(a, 0, -1).astype(dtype)   # B axis last
    S = JD_derivs(
        Fx=last(np.eye(nx) + 0.1 * rng.normal(size=(B, N, nx, nx))),
        Fu=last(0.3 * rng.normal(size=(B, N, nx, nu))),
        Lx=last(0.1 * rng.normal(size=(B, N, nx))),
        Lu=last(0.1 * rng.normal(size=(B, N, nu))),
        Lxx=last(_spd(rng, (B, N), nx)), Luu=last(_spd(rng, (B, N), nu)),
        Lxu=last(0.05 * rng.normal(size=(B, N, nx, nu))))
    VxT = last(rng.normal(size=(B, nx)))
    VxxT = last(_spd(rng, (B,), nx))
    lam = np.full((B,), 1e-4, dtype)
    c = JaxDDPConfig(horizon_steps=N)
    t = lambda a: torch.as_tensor(a).contiguous()
    port = (ddp_config_from_reference(c), StackedDerivs(*map(t, S)), t(VxT),
            t(VxxT), t(lam))
    return (c, JD_derivs(*map(jnp.asarray, S)), *map(jnp.asarray,
                                                     (VxT, VxxT, lam))), port


def _counts():
    """The sweep-fed wrappers' launch counters."""
    return (K.backward_fused.launches, K.backward_fused.wide_launches,
            K.backward_fused.chunked_launches,
            K.backward_fused.chunked_wide_launches,
            K.backward_packed.launches, K.backward_packed.wide_launches)


@pytest.mark.parametrize("dma,N,B,seed,wide", [
    pytest.param("chunked", 12, 256, 7, False, id="chunked-12-256-7"),
    pytest.param("packed", 8, 128, 3, False, id="packed-8-128-3"),
    pytest.param("chunked", 3, 128, 5, True, id="chunked-3-128-5-2x5"),
    pytest.param("packed", 3, 128, 6, True, id="packed-3-128-6-2x5")])
def test_ddp_dma_plain_routes_match_jax(interpret_pallas, monkeypatch, dma,
                                        N, B, seed, wide):
    """``backward_fused(dma=...)`` on CPU tensors (K2's plain version;
    K3's through ``pack_derivs`` and its inverse) vs JAX ``backward_pallas``
    in the same mode (``NMPC_PALLAS_DMA``) in interpret mode, fp32, on the
    cart-pole data and at the wide shape (2, 5) on seeded data: ks, Ks
    within 2e-5, dV within 2e-4, ok equal (the
    tolerances of ``test_pallas_backward_matches_stacked``); and bit-equal
    to the port's ``backward_stacked``, which every CPU route runs."""
    jargs, (cfg, D, VxT, VxxT, lam) = (_wide_case if wide else _ddp_case)(
        N, B, seed)
    monkeypatch.setenv("NMPC_PALLAS_DMA", dma)
    want = JP.backward_pallas(*jargs)
    before = _counts()
    got = K.backward_fused(cfg, D, VxT, VxxT, lam, dma=dma)
    assert _counts() == before     # no launch on CPU
    assert bool(got[3].all())
    for name, a, b, tol in zip(("ks", "Ks", "dV"), want[:3], got[:3],
                               (2e-5, 2e-5, 2e-4)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol,
                                   err_msg=name)
    assert got[3].dtype == torch.bool
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for a, b in zip(backward_stacked(cfg, D, VxT, VxxT, lam), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("reg_type,lam", [(1, 1e-6), (2, 0.5)])
@pytest.mark.parametrize("dma", ["chunked", "packed"])
def test_ddp_dma_wide_routes_match_jax(dma, reg_type, lam):
    """The port's chunked and packed routes at the centroidal model's (9,
    16) (``backward_fused`` on CPU tensors: the plain version, "packed"
    through ``pack_derivs`` and its inverse) against the JAX package's
    ``backward_stacked`` (which JAX's own tests hold its Pallas kernels
    to) on the same fp64 centroidal inputs, B = 8, N = 4, the non-PD and
    NaN lanes among them: ok masks equal, ks, Ks and dV within 1e-10
    normalized (max|a-b| / (1 + max|a|)) on the ok lanes."""
    D, VxT, VxxT = _centroidal(torch.float64, 4, B=8)
    B, N = VxT.shape[-1], D.Fx.shape[0]
    jc = JaxDDPConfig(horizon_steps=N, reg_type=reg_type)
    lam_np = np.full(B, lam)
    want = jax_stacked(jc, JD_derivs(*(jnp.asarray(a.numpy()) for a in D)),
                       jnp.asarray(VxT.numpy()), jnp.asarray(VxxT.numpy()),
                       jnp.asarray(lam_np))
    before = _counts()
    got = K.backward_fused(ddp_config_from_reference(jc), D, VxT, VxxT,
                           torch.as_tensor(lam_np), dma=dma)
    assert _counts() == before
    ok = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), ok)
    assert not ok[1] and not ok[2] and ok.sum() == B - 2
    for a, b in zip(want[:3], got[:3]):
        a, b = np.asarray(a)[..., ok], b.numpy()[..., ok]
        assert np.abs(a - b).max() / (1.0 + np.abs(a).max()) <= 1e-10


@pytest.mark.parametrize("dma", ["chunked", "packed"])
def test_ddp_solver_dma_keyword_centroidal(dma):
    """A CPU solve of the centroidal model from t0 = 1.3 (into the flight
    phase) with ``backward_impl="pallas"`` and ``backward_dma`` chunked or
    packed equals the "stage" solve bit for bit: the solver hands its
    ``backward_dma`` to the backward at (9, 16), where every mode now
    takes the shape."""
    B, N = 4, 8
    p = make_centroidal_problem(0.03)
    rng = np.random.default_rng(2)
    x0 = np.concatenate([[0.0, 0.0, 1.0], np.zeros(6)])
    x0s = torch.as_tensor(np.tile(x0, (B, 1)) + 0.02 * rng.normal(
        size=(B, 9)))
    us0 = torch.full((B, N, 16), 5.0, dtype=torch.float64)
    cfg = DDPConfig(horizon_steps=N, max_iter=2, backward_impl="pallas")
    ref = DDPSolver(p, cfg).solve_batch(1.3, x0s, us0)
    got = DDPSolver(p, cfg, backward_dma=dma).solve_batch(1.3, x0s, us0)
    for f in ("status", "iters", "us", "xs", "ks", "Ks", "lam"):
        assert torch.equal(getattr(ref, f), getattr(got, f)), f
    for f in dataclasses.fields(ref.trace):
        assert torch.equal(getattr(ref.trace, f.name),
                           getattr(got.trace, f.name))


@pytest.mark.parametrize("nx,nu", [(4, 1), (2, 1), (2, 2)])
def test_pack_derivs_matches_jax(nx, nu):
    """``pack_derivs`` equals ``pack_derivs_pallas`` with its (B4, 128)
    lanes flattened, ``field_offsets`` equals ``_field_offsets`` (F = 46 at
    (4, 1), 16 at (2, 1)), and ``unpack_derivs`` inverts the pack."""
    N, B = 5, 256
    rng = np.random.default_rng(nx * 10 + nu)
    shapes = ((nx, nx), (nx, nu), (nx,), (nu,), (nx, nx), (nu, nu), (nx, nu))
    fields = [rng.normal(size=(N, *s, B)) for s in shapes]
    D = StackedDerivs(*map(torch.as_tensor, fields))
    want = JP.pack_derivs_pallas(
        type("D", (), dict(zip(StackedDerivs._fields,
                               map(jnp.asarray, fields))))(), B // 128)
    P = K.pack_derivs(D)
    np.testing.assert_array_equal(P.numpy(),
                                  np.asarray(want).reshape(N, -1, B))
    assert K.field_offsets(nx, nu) == JP._field_offsets(nx, nu)
    assert K.field_offsets(4, 1)[1] == 46 and K.field_offsets(2, 1)[1] == 16
    for a, b in zip(D, K.unpack_derivs(P, nx, nu)):
        assert b.is_contiguous() and torch.equal(a, b)


@pytest.mark.parametrize("nx,nu,ng", [(2, 1, 3), (4, 1, 4), (2, 2, 2)])
def test_fmpc_field_offsets_match_jax(nx, nu, ng):
    """The packed FMPC buffers' offsets and widths equal
    ``fmpc_backward_pallas._field_offsets`` (Fin = 78, Fout = 25 at the
    cart-pole's (4, 1, 4))."""
    got = KF.field_offsets(nx, nu, ng)
    want = JFP._field_offsets(nx, nu, ng)
    assert got[1] == want[1] and got[3] == want[3]
    assert got[0] == want[0]
    assert list(got[2].values()) == list(want[2].values())
    assert KF.field_offsets(4, 1, 4)[1::2] == (78, 25)


@pytest.mark.parametrize("variant,break_if_llt_fails", [
    ("resident", False), ("packed", False), ("packed", True)])
def test_fmpc_variant_plain_routes_match_jax(interpret_pallas, monkeypatch,
                                             variant, break_if_llt_fails):
    """``backward_fmpc_fused(variant=...)`` on CPU tensors (K9's plain
    version; K10's through ``pack_fmpc_inputs``, ``backward_fmpc_packed``'s
    unpack-recursion-pack and the output slicing) vs JAX
    ``backward_fmpc_pallas`` in the same mode (``NMPC_FMPC_PALLAS=resident``
    or ``packed=True``) in interpret mode, on the oscillator data of
    ``_fmpc_backward_case`` (N=10, B=128, fp32) with lane 5 NaN-poisoned:
    ks, Ks, s, P within 3e-5, ok and finite equal; and bit-equal to the
    plain ``_backward_bm``.  (The resident kernel's interpretation unrolls
    its stages and takes most of this file's time: one case.)"""
    (jp, jc, jco, jvar, jgms, jeps), (pp, pc, co, var, gms, eps) = _case(
        "oscillator", 10, 128, np.float32, seed=0,
        break_if_llt_fails=break_if_llt_fails)
    poison = np.asarray(jco.A).copy()
    poison[4, 0, 1, 5] = np.nan
    jco = jco._replace(A=jnp.asarray(poison))
    co = co._replace(A=torch.as_tensor(poison))
    if variant == "resident":
        monkeypatch.setenv("NMPC_FMPC_PALLAS", "resident")
        want = JFP.backward_fmpc_pallas(jp, jc, jco, jvar.ss, jvar.nus, jgms,
                                        jeps)
    else:
        want = JFP.backward_fmpc_pallas(jp, jc, jco, jvar.ss, jvar.nus, jgms,
                                        jeps, packed=True)
    before = (KF.backward_fmpc_fused.launches,
              KF.backward_fmpc_fused.resident_launches,
              KF.backward_fmpc_packed.launches)
    got = KF.backward_fmpc_fused(pp, pc, co, var.ss, var.nus, gms, eps,
                                 variant=variant)
    assert (KF.backward_fmpc_fused.launches,
            KF.backward_fmpc_fused.resident_launches,
            KF.backward_fmpc_packed.launches) == before
    _hold_backward(want, got, np.float32)
    assert not bool(got[5][5]) and int(got[5].sum()) == 127
    for a, b in zip(F._backward_bm(pp, pc, co, var.ss, var.nus, gms, eps),
                    got):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)


def _port_case(kind, N, B, seed):
    """A random batch-minor iterate (s and nu in [0.2, 1.2)) of a port
    problem, fp64, and its coefficients: (problem, config, coefficients,
    variable, masks, eps)."""
    p = {"oscillator": make_oscillator_problem,
         "cartpole": make_cartpole_fmpc_problem}[kind](DT)
    nx, nu, ng = p.state_dim, p.input_dim, p.ineq_dim
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a).contiguous()
    var = FmpcVariable(xs=t(0.3 * rng.normal(size=(N + 1, nx, B))),
                       us=t(0.3 * rng.normal(size=(N, nu, B))),
                       lambdas=t(0.3 * rng.normal(size=(N + 1, nx, B))),
                       ss=t(0.2 + rng.uniform(size=(N, ng, B))),
                       nus=t(0.2 + rng.uniform(size=(N, ng, B))))
    cfg = FmpcConfig(horizon_steps=N)
    t0 = torch.tensor(0.0, dtype=torch.float64)
    co = F._coeffs_bm(p, cfg, t0, var)
    gms = F._ineq_masks(p, t0 + DT * torch.arange(N, dtype=torch.float64),
                        torch.float64)
    return p, cfg, co, var, gms, torch.full((B,), 1e-4, dtype=torch.float64)


def test_fmpc_packed_buffers_hold_the_fields():
    """``pack_fmpc_inputs`` puts each field at its offset, and
    ``backward_fmpc_packed``'s plain output holds k, K, s, P of rows
    0 .. N-1 at theirs, on cart-pole data (fp64)."""
    pp, pc, co, var, gms, eps = _port_case("cartpole", 6, 32, seed=7)
    nx, nu, ng = 4, 1, 4
    nu_s, tilde = KF.condensation(co, var.ss, var.nus, gms, eps)
    P_in = KF.pack_fmpc_inputs(co, nu_s, tilde)
    off_in, Fin, off_out, Fout = KF.field_offsets(nx, nu, ng)
    assert P_in.shape == (6, Fin, 32)
    assert torch.equal(P_in[:, off_in["C"]:off_in["C"] + ng * nx],
                       co.C.reshape(6, -1, 32))
    assert torch.equal(P_in[:, off_in["tilde"]:], tilde)
    out, ok, finite = KF.backward_fmpc_packed(pp, pc, P_in, -co.Lx_bar_term,
                                              co.Lxx_term, nx, nu, ng)
    ref = F._backward_bm(pp, pc, co, var.ss, var.nus, gms, eps)
    assert out.shape == (6, Fout, 32)
    assert torch.equal(out[:, off_out["K"]:off_out["svec"]],
                       ref[1].reshape(6, -1, 32))
    assert torch.equal(out[:, off_out["P"]:], ref[3][:6].reshape(6, -1, 32))
    assert torch.equal(ok, ref[4]) and torch.equal(finite, ref[5])


def test_resident_fits_and_raises():
    """``resident_fits``: N <= 32 and the horizon of a block's fewest lanes
    within 227 KB (cart-pole (4, 1, 4): every N <= 32 at fp32 and fp64;
    (8, 4, 16) at fp64: N <= 7; past (8, 4, 16) the wide unit's rule with
    the lanes' scratch: the masses' (12, 3, 30) N <= 14; nothing past
    the ceiling (16, 16, 64)); the wrapper asked for the resident kernel
    at a shape that does not fit raises, on the CPU too, and an unknown
    variant raises."""
    fits = lambda *s: KF.resident_fits(*s)
    assert fits(2, 1, 3, 20, torch.float32) and fits(2, 1, 3, 32,
                                                     torch.float32)
    assert not fits(2, 1, 3, 33, torch.float32)
    assert fits(4, 1, 4, 32, torch.float32)
    assert not fits(4, 1, 4, 33, torch.float32)
    assert fits(4, 1, 4, 32, torch.float64)
    assert fits(8, 4, 16, 7, torch.float64)
    assert not fits(8, 4, 16, 8, torch.float64)
    assert fits(9, 1, 4, 4, torch.float32)
    assert fits(12, 3, 30, 14, torch.float32)
    assert not fits(12, 3, 30, 15, torch.float32)
    assert not fits(17, 1, 4, 4, torch.float32)
    pp, pc, co, var, gms, eps = _port_case("cartpole", 33, 8, seed=1)
    with pytest.raises(ValueError, match="resident"):
        KF.backward_fmpc_fused(pp, pc, co, var.ss, var.nus, gms, eps,
                               variant="resident")
    with pytest.raises(ValueError, match="variant"):
        KF.backward_fmpc_fused(pp, pc, co, var.ss, var.nus, gms, eps,
                               variant="streamed")


def test_chunk_stages():
    """K2's chunk: two slots of 32 lanes within 96 KB, at most 32 stages
    and N; (4, 1) fp32 8 (a shorter last chunk at N=100), fp64 4; (2, 1)
    fp32 24 (N=300: 12 full chunks and one of 12), fp64 12."""
    assert K.chunk_stages(4, 1, 100, torch.float32) == 8
    assert K.chunk_stages(4, 1, 100, torch.float64) == 4
    assert K.chunk_stages(2, 1, 300, torch.float32) == 24
    assert K.chunk_stages(2, 1, 300, torch.float64) == 12
    assert K.chunk_stages(2, 1, 5, torch.float32) == 5
    assert K.chunk_stages(1, 1, 100, torch.float32) == 32


@pytest.mark.parametrize("dma", ["stage", "chunked", "packed"])
def test_ddp_solver_dma_keyword(dma):
    """A CPU solve with ``backward_impl="pallas"`` and each
    ``backward_dma`` equals the default solve bit for bit (the CPU routes
    run the plain backward; "packed" through the pack)."""
    B, N = 16, 20
    rng = np.random.default_rng(4)
    x0s = torch.as_tensor(np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                          + 0.05 * rng.normal(size=(B, 4)))
    us0 = torch.zeros((B, N, 1), dtype=torch.float64)
    cfg = DDPConfig(horizon_steps=N, max_iter=5, backward_impl="pallas")
    p = make_cartpole_problem(DT)
    ref = DDPSolver(p, cfg).solve_batch(0.0, x0s, us0)
    got = DDPSolver(p, cfg, backward_dma=dma).solve_batch(0.0, x0s, us0)
    for f in ("status", "iters", "us", "xs", "ks", "Ks", "lam"):
        assert torch.equal(getattr(ref, f), getattr(got, f)), f
    for f in dataclasses.fields(ref.trace):
        assert torch.equal(getattr(ref.trace, f.name),
                           getattr(got.trace, f.name))


@pytest.mark.parametrize("variant", ["stream", "resident", "packed"])
def test_fmpc_solver_variant_keyword(variant):
    """A CPU FMPC solve with ``backward_impl="pallas"`` and each
    ``backward_variant`` equals the default solve bit for bit."""
    B, N = 8, 12
    p = make_oscillator_problem(DT)
    rng = np.random.default_rng(5)
    x0s = torch.as_tensor(np.tile([0.0, 1.0], (B, 1))
                          + 0.05 * rng.normal(size=(B, 2)))
    v1 = fmpc_variable_reset(N, 2, 1, 3, dtype=torch.float64)
    var = FmpcVariable(**{f.name: getattr(v1, f.name).expand(
        B, *getattr(v1, f.name).shape).contiguous()
        for f in dataclasses.fields(v1)})
    eps = torch.full((B,), 1e-4, dtype=torch.float64)
    cfg = FmpcConfig(horizon_steps=N, max_iter=4, backward_impl="pallas")
    ref = FmpcSolver(p, cfg).solve_batch(0.0, x0s, var, eps)
    got = FmpcSolver(p, cfg, backward_variant=variant).solve_batch(
        0.0, x0s, var, eps)
    assert torch.equal(ref.status, got.status)
    assert torch.equal(ref.iters, got.iters)
    for f in dataclasses.fields(ref.variable):
        assert torch.equal(getattr(ref.variable, f.name),
                           getattr(got.variable, f.name))
    assert torch.equal(ref.trace.kkt_error, got.trace.kkt_error)


def test_solver_keywords_reject_bad_values():
    """Unknown ``backward_dma`` / ``backward_variant`` values raise, and so
    does a chunked or packed DDP backward on a boxed solve (K2 and K3 are
    unboxed, as in the JAX package)."""
    p = make_cartpole_problem(DT)
    with pytest.raises(ValueError, match="backward_dma"):
        DDPSolver(p, DDPConfig(), backward_dma="chunk")
    boxed = DDPConfig(with_input_constraint=True)
    DDPSolver(make_vertical_problem(DT), boxed)
    for dma in ("chunked", "packed"):
        with pytest.raises(ValueError, match="unboxed"):
            DDPSolver(make_vertical_problem(DT), boxed, backward_dma=dma)
    with pytest.raises(ValueError, match="backward_variant"):
        FmpcSolver(make_oscillator_problem(DT), FmpcConfig(),
                   backward_variant="packed_resident")
    D = StackedDerivs(*(torch.zeros(s) for s in (
        (2, 4, 4, 3), (2, 4, 1, 3), (2, 4, 3), (2, 1, 3), (2, 4, 4, 3),
        (2, 1, 1, 3), (2, 4, 1, 3))))
    with pytest.raises(ValueError, match="dma"):
        K.backward_fused(DDPConfig(horizon_steps=2), D, torch.zeros(4, 3),
                         torch.zeros(4, 4, 3), torch.zeros(3), dma="chunk")
