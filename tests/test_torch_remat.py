"""The remat backward (TPU K5) and the fused line-search rollouts (K6, K7)
of the port, on CPU tensors, against the JAX package's Pallas kernels in
interpret mode on the same numpy inputs (``tests/test_pallas_kernels.py``),
and the solve through them against JAX ``solve_batch``.  On CPU the
port's entry points run their plain versions after the generator's gate;
the generated program itself is held against the JAX kernel through its
torch evaluator.  Also the build cache key of ``kernels/build.py``."""

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nmpc_tpu import DDPSolver as JaxSolver
from nmpc_tpu.core.types import DDPConfig as JaxConfig
from nmpc_tpu.kernels.ddp_backward_remat import (
    backward_remat as jax_backward_remat)
from nmpc_tpu.kernels.ddp_forward_remat import (
    forward_costs_remat as jax_forward_costs,
    forward_selected_remat as jax_forward_selected)
from nmpc_tpu.kernels.lanes import block_lanes, lane_factors
from nmpc_tpu.models import cartpole as jax_cp
from nmpc_tpu.solvers import ddp as jax_ddp
from nmpc_tpu_torch import DDPConfig, DDPSolver
from nmpc_tpu_torch.convert import (cartpole_problem_from_reference,
                                    ddp_config_from_reference,
                                    result_to_numpy)
from nmpc_tpu_torch.kernels import build, ddp_backward_fused, tileval
from nmpc_tpu_torch.kernels.ddp_backward import StackedDerivs, backward_stacked
from nmpc_tpu_torch.kernels.ddp_backward_remat import (backward_remat,
                                                       remat_supported)
from nmpc_tpu_torch.kernels.ddp_forward_remat import (
    forward_costs_remat, forward_remat_supported, forward_selected_remat)
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem

torch.set_num_threads(1)

DT = 0.01
N, B = 12, 256


@pytest.fixture()
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype).contiguous()


def _backward_inputs():
    """The inputs of test_pallas_kernels.py::test_remat_backward_matches_
    stacked: a cart-pole rollout at fp32, t0 = 0.3, seed 0 (JAX arrays,
    batch-minor)."""
    p = jax_cp.make_cartpole_problem(DT)
    c = JaxConfig(horizon_steps=N, max_iter=10)
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us = jnp.asarray(rng.normal(size=(B, N, 1)).astype(np.float32) * 0.2)
    t0 = jnp.float32(0.3)
    xs, _ = jax_ddp._rollout_stacked(p, c, t0, x0s, us)
    _, VxT, VxxT = jax.vmap(functools.partial(jax_ddp._derivative_sweep, p, c),
                            in_axes=(None, 0, 0))(t0, xs, us)
    mv = lambda a: jnp.moveaxis(a, 0, -1)
    return p, t0, mv(xs), mv(us), mv(VxT), mv(VxxT)


@pytest.mark.parametrize("reg_type", [1, 2])
def test_backward_remat_matches_jax_kernel(interpret_pallas, reg_type):
    """Port ``backward_remat`` vs JAX ``backward_remat`` (K5, interpret
    mode): ks, Ks within 2e-5, dV within 2e-4, ok masks equal (the
    tolerances of test_remat_backward_matches_stacked)."""
    p, t0, xs, us, VxT, VxxT = _backward_inputs()
    lam_val = 1e-4 if reg_type == 1 else 0.5
    lam = jnp.full((B,), lam_val, jnp.float32)
    want = jax_backward_remat(p, JaxConfig(horizon_steps=N,
                                           reg_type=reg_type),
                              t0, xs, us, VxT, VxxT, lam)
    got = backward_remat(make_cartpole_problem(DT),
                         DDPConfig(horizon_steps=N, reg_type=reg_type),
                         0.3, _t(xs), _t(us), _t(VxT), _t(VxxT), _t(lam))
    for a, b, tol in zip(want[:3], got[:3], (2e-5, 2e-5, 2e-4)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol,
                                   rtol=0)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3].dtype == torch.bool and bool(got[3].all())


def test_generated_fields_feed_backward_like_jax_kernel(interpret_pallas):
    """The generator's field program (what the CUDA kernel computes per
    stage), run through its torch evaluator at every stage and fed to
    ``backward_stacked``, vs the JAX remat kernel: the same tolerances."""
    p, t0, xs, us, VxT, VxxT = _backward_inputs()
    lam = jnp.full((B,), 1e-4, jnp.float32)
    want = jax_backward_remat(p, JaxConfig(horizon_steps=N), t0, xs, us,
                              VxT, VxxT, lam)
    prog, outs = tileval.generate(make_cartpole_problem(DT), "remat", 4, 1,
                                  torch.float32).functions["fields"]
    xs_t, us_t = _t(xs), _t(us)
    t_i = torch.tensor(0.3) + DT * torch.arange(N, dtype=torch.float32)
    fields = []
    for i in range(N):
        named = {"t": t_i[i].expand(B), "u_0": us_t[i, 0],
                 **{f"x_{a}": xs_t[i, a] for a in range(4)}}
        fields.append(torch.stack(prog.evaluate(outs, named, us_t[i, 0])))
    F = torch.stack(fields)                                  # [N, 46, B]
    shapes = ((4, 4), (4, 1), (4,), (1,), (4, 4), (1, 1), (4, 1))
    D, k = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        D.append(F[:, k:k + n].reshape((N,) + shape + (B,)).contiguous())
        k += n
    got = backward_stacked(DDPConfig(horizon_steps=N), StackedDerivs(*D),
                           _t(VxT), _t(VxxT), _t(lam))
    for a, b, tol in zip(want[:3], got[:3], (2e-5, 2e-5, 2e-4)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol,
                                   rtol=0)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def _forward_inputs():
    """The inputs of test_pallas_kernels.py::test_forward_remat_matches_
    scan (seed 0, t0 = 0.3), flat-B batch-minor JAX arrays."""
    p = jax_cp.make_cartpole_problem(DT)
    c = JaxConfig(horizon_steps=N, max_iter=10)
    rng = np.random.default_rng(0)
    x0s = jnp.asarray((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                       + 0.05 * rng.normal(size=(B, 4))).astype(np.float32))
    us = jnp.asarray(rng.normal(size=(B, N, 1)).astype(np.float32) * 0.2)
    t0 = jnp.float32(0.3)
    S_, L_ = lane_factors(B)
    xs_l, _ = jax_ddp._rollout_lanes(p, c, t0, block_lanes(x0s, 0, S_, L_),
                                     block_lanes(us, 0, S_, L_))
    us_l = block_lanes(us, 0, S_, L_)
    ks_l = jnp.asarray(rng.normal(size=(N, 1, S_, L_)).astype(np.float32)
                       * 0.1)
    Ks_l = jnp.asarray(rng.normal(size=(N, 1, 4, S_, L_)).astype(np.float32)
                       * 0.1)
    alpha_l = jnp.asarray(
        rng.uniform(0.1, 1.0, size=(S_, L_)).astype(np.float32))
    flat = lambda a: a.reshape(a.shape[:-2] + (B,))
    return p, c, t0, tuple(flat(a) for a in (xs_l, us_l, ks_l, Ks_l,
                                             alpha_l))


def test_forward_selected_matches_jax_kernel(interpret_pallas):
    """Port ``forward_selected_remat`` vs JAX (K6, interpret mode): xs,
    us, costs within 1e-5, the cost sum within 2e-5."""
    p, c, t0, (xs, us, ks, Ks, alpha) = _forward_inputs()
    want = jax_forward_selected(p, c, t0, xs, us, ks, Ks, alpha)
    got = forward_selected_remat(make_cartpole_problem(DT),
                                 DDPConfig(horizon_steps=N), 0.3,
                                 *map(_t, (xs, us, ks, Ks, alpha)))
    for a, b, tol in zip(want, got, (1e-5, 1e-5, 1e-5, 2e-5)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol,
                                   rtol=0)


def test_forward_costs_matches_jax_kernel(interpret_pallas):
    """Port ``forward_costs_remat`` vs JAX (K7, interpret mode) over the
    11-alpha schedule, within 2e-5; and the port's alpha column equals
    its selected rollout's sum at that alpha (the head/sweep accept
    contract)."""
    p, c, t0, (xs, us, ks, Ks, _) = _forward_inputs()
    want = jax_forward_costs(p, c, t0, xs, us, ks, Ks, tuple(c.alpha_list))
    tp, tc = make_cartpole_problem(DT), DDPConfig(horizon_steps=N)
    alphas = torch.tensor(tc.alpha_list, dtype=torch.float32)
    args = tuple(map(_t, (xs, us, ks, Ks)))
    got = forward_costs_remat(tp, tc, 0.3, *args, alphas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    ia = 3
    sel = forward_selected_remat(tp, tc, 0.3, *args,
                                 alphas[ia].expand(B).contiguous())[3]
    assert torch.equal(got[ia], sel)


def _solve_inputs(dtype, seed=7, B_=128, N_=12):
    rng = np.random.default_rng(seed)
    x0s = (np.tile([0.0, np.pi, 0.0, 0.0], (B_, 1))
           + 0.1 * rng.normal(size=(B_, 4))).astype(dtype)
    return x0s, np.zeros((B_, N_, 1), dtype)


@pytest.mark.parametrize("ls_mode", ["auto", "sweep"])
def test_remat_fused_solve_matches_jax_fp32(interpret_pallas, ls_mode):
    """``solve_batch`` with (remat, fused) vs JAX ``solve_batch`` with the
    same options in interpret mode (the pattern of test_forward_fused_
    solve_end_to_end): fp32, B=128, N=12, 3 iterations.  Statuses and
    iterations equal; us within 1e-5 on every lane whose accepted alphas
    agree.  One lane (9) takes another alpha at iteration 3, where its
    cost update is at fp32 rounding level: the port's plain path and the
    JAX scan path part there too, so it is an fp32 decision flip of the
    kind ROADMAP §C logs, held to the end-to-end contract (u normalized
    <= 1e-2, cost rel <= 1e-4).  Against the port's own plain path the
    remat/fused solve is exact on CPU."""
    x0s, us0 = _solve_inputs(np.float32)
    jc = JaxConfig(horizon_steps=12, max_iter=3, backward_impl="remat",
                   forward_impl="fused", ls_mode=ls_mode)
    jr = JaxSolver(jax_cp.make_cartpole_problem(DT), jc).solve_batch(
        jnp.float32(0.0), jnp.asarray(x0s), jnp.asarray(us0))
    tc = ddp_config_from_reference(jc)
    tr = result_to_numpy(DDPSolver(make_cartpole_problem(DT), tc).solve_batch(
        0.0, torch.as_tensor(x0s), torch.as_tensor(us0)))
    np.testing.assert_array_equal(tr["status"], np.asarray(jr.status))
    np.testing.assert_array_equal(tr["iters"], np.asarray(jr.iters))
    ju = np.asarray(jr.us)
    same = (tr["trace"]["alpha"] == np.asarray(jr.trace.alpha)).all(axis=1)
    assert same.sum() >= len(same) - 1
    np.testing.assert_allclose(tr["us"][same], ju[same], atol=1e-5, rtol=0)
    assert np.abs(tr["us"] - ju).max() / (1 + np.abs(ju).max()) <= 1e-2
    jc_, tc_ = (np.asarray(jr.costs, np.float64).sum(1),
                tr["costs"].astype(np.float64).sum(1))
    assert (np.abs(jc_ - tc_) / (1 + np.abs(jc_))).max() <= 1e-4
    plain = result_to_numpy(DDPSolver(make_cartpole_problem(DT),
                                      dataclasses.replace(
        tc, backward_impl="stacked", forward_impl="scan")).solve_batch(
            0.0, torch.as_tensor(x0s), torch.as_tensor(us0)))
    np.testing.assert_array_equal(tr["us"], plain["us"])


def test_remat_fused_solve_matches_jax_fp64():
    """fp64 ``solve_batch`` with (remat, fused) vs JAX ``solve_batch``
    (the JAX remat kernel keeps its ok mask in fp32 and does not run at
    fp64, so the JAX side takes its default path): statuses and
    iterations equal, us and xs within 1e-8."""
    x0s, us0 = _solve_inputs(np.float64, seed=2, B_=16, N_=40)
    jc = JaxConfig(horizon_steps=40, max_iter=30)
    jr = JaxSolver(jax_cp.make_cartpole_problem(DT), jc).solve_batch(
        jnp.float64(0.0), jnp.asarray(x0s), jnp.asarray(us0))
    tc = dataclasses.replace(ddp_config_from_reference(jc),
                             backward_impl="remat", forward_impl="fused")
    tr = result_to_numpy(DDPSolver(make_cartpole_problem(DT), tc).solve_batch(
        0.0, torch.as_tensor(x0s), torch.as_tensor(us0)))
    np.testing.assert_array_equal(tr["status"], np.asarray(jr.status))
    np.testing.assert_array_equal(tr["iters"], np.asarray(jr.iters))
    np.testing.assert_allclose(tr["us"], np.asarray(jr.us), atol=1e-8,
                               rtol=0)
    np.testing.assert_allclose(tr["xs"], np.asarray(jr.xs), atol=1e-8,
                               rtol=0)


def test_converted_cartpole_generates():
    """The cart-pole built from the JAX package's parameter dataclasses
    (``convert.py``) traces in the generator at both dtypes."""
    param = jax_cp.CartPoleParam(cart_mass=1.3, pole_mass=0.4,
                                 pole_length=1.5)
    p = cartpole_problem_from_reference(0.02, param,
                                        jax_cp.CartPoleCostWeight())
    for dtype in (torch.float32, torch.float64):
        assert remat_supported(p, 4, 1, dtype)
        assert forward_remat_supported(p, 4, 1, dtype)


def test_wrappers_refuse_what_the_kernel_does_not_compute():
    """Second order and wider derivative dtypes raise in the remat
    backward's wrapper on any device (the kernel computes neither)."""
    p = make_cartpole_problem(DT)
    xs, us = torch.zeros((N + 1, 4, 8)), torch.zeros((N, 1, 8))
    args = (0.0, xs, us, torch.zeros((4, 8)), torch.zeros((4, 4, 8)),
            torch.ones(8))
    with pytest.raises(NotImplementedError, match="first-order"):
        backward_remat(p, DDPConfig(horizon_steps=N,
                                    use_state_eq_second_derivative=True),
                       *args)
    with pytest.raises(ValueError, match="deriv_dtype"):
        backward_remat(p, DDPConfig(horizon_steps=N, deriv_dtype="float64"),
                       *args)


def test_library_name_follows_included_headers(tmp_path):
    """The build cache key covers every csrc header a unit includes
    (directly or through another header) and the flags: editing
    riccati_stage.cuh in a copy of csrc/ renames the sweep-fed kernel's
    library and a generated unit's, and editing an unrelated header
    renames neither.  Nothing is compiled."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    k1 = ddp_backward_fused.unit_source(4, 1, torch.float32)
    gen = '#include "ddp_backward_remat.cuh"\n'
    before = [build.library_path("k", text, csrc) for text in (k1, gen)]
    assert before == [build.library_path("k", text, csrc)
                      for text in (k1, gen)]
    assert {p.name for p in build.included_headers(gen, csrc)} == {
        "ddp_backward_remat.cuh", "cp_async.cuh", "remat_common.cuh",
        "riccati_stage.cuh", "boxqp.cuh", "linalg.cuh", "row_group.cuh"}
    fwd = csrc / "ddp_forward_remat.cuh"
    fwd.write_text(fwd.read_text() + "\n// edited\n")
    assert before == [build.library_path("k", text, csrc)
                      for text in (k1, gen)]
    header = csrc / "riccati_stage.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [build.library_path("k", text, csrc) for text in (k1, gen)]
    assert all(a != b for a, b in zip(before, after))
    assert build.library_path("k", gen + " ", csrc) != after[1]
    # a header included only through another one (riccati_stage.cuh ->
    # boxqp.cuh -> linalg.cuh), and a unit's own flags
    linalg = csrc / "linalg.cuh"
    linalg.write_text(linalg.read_text() + "\n// edited\n")
    again = [build.library_path("k", text, csrc) for text in (k1, gen)]
    assert all(a != b for a, b in zip(after, again))
    assert build.library_path("k", gen, csrc, ("-fmad=false",)) != again[1]
