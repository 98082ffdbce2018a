"""The port's projected-Newton BoxQP (``nmpc_tpu_torch/solvers/boxqp.py``
and the batched ``kernels/ddp_backward.py::boxqp_stacked``) and its small
linear algebra (``kernels/linalg.py``) against the JAX package on the same
numpy inputs at fp64, mirroring ``tests/test_boxqp.py``: the same random
QPs, the active-set enumeration golden, the worst-case iteration count and
the MAX_LS_ITER retcode."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nmpc_tpu import BoxQPConfig as JaxBoxQPConfig
from nmpc_tpu import boxqp_solve as jax_boxqp_solve
from nmpc_tpu.kernels import linalg as jax_linalg
from nmpc_tpu.kernels.ddp_backward import boxqp_stacked as jax_boxqp_stacked
from nmpc_tpu_torch import BoxQPConfig, BoxQPStatus, boxqp_solve
from nmpc_tpu_torch.kernels import linalg
from nmpc_tpu_torch.kernels.ddp_backward import boxqp_stacked

from test_boxqp import _random_psd, golden_boxqp

torch.set_num_threads(1)

_t = torch.as_tensor
# one compile per (shape, config) instead of one per call
_jax_solve = jax.jit(jax_boxqp_solve, static_argnums=5)


def _both(H, g, lower, upper, x0, **cfg):
    """(port result, JAX result) of ``boxqp_solve`` on numpy inputs."""
    mine = boxqp_solve(_t(H), _t(g), _t(lower), _t(upper), _t(x0),
                       BoxQPConfig(**cfg))
    ref = _jax_solve(jnp.asarray(H), jnp.asarray(g), jnp.asarray(lower),
                     jnp.asarray(upper), jnp.asarray(x0),
                     JaxBoxQPConfig(**cfg))
    return mine, ref


def _assert_same(mine, ref, atol=1e-12):
    assert mine.status == int(ref.status)
    assert mine.iters == int(ref.iters)
    np.testing.assert_allclose(mine.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=atol)
    np.testing.assert_array_equal(mine.free_mask.numpy(),
                                  np.asarray(ref.free_mask))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_random_qps_match_jax_and_enumeration(n):
    """The 20 random QPs of test_random_qps_match_enumeration per size: x
    within 1e-12 of JAX with the same status, iterations and free set,
    and within 1e-6 of the enumeration golden."""
    rng = np.random.default_rng(42 + n)
    for _ in range(20):
        H = _random_psd(rng, n)
        g = rng.normal(size=n) * 2
        lower = -np.abs(rng.normal(size=n))
        upper = np.abs(rng.normal(size=n))
        mine, ref = _both(H, g, lower, upper, np.zeros(n))
        _assert_same(mine, ref)
        assert mine.status >= 0
        np.testing.assert_allclose(mine.x.numpy(),
                                   golden_boxqp(H, g, lower, upper),
                                   atol=1e-6)


def test_interior_clamped_and_feedback_factor():
    """An interior optimum is the Newton point (1e-8), a fully clamped one
    the lower corner; the exposed (free_mask, chol) factor F H F + C
    (BoxQP.h:386-389) as the JAX tests pin it, each equal to JAX's."""
    H = np.array([[2.0, 0.3], [0.3, 1.0]])
    g = np.array([0.1, -0.2])
    mine, ref = _both(H, g, np.full(2, -10.0), np.full(2, 10.0), np.zeros(2))
    _assert_same(mine, ref)
    np.testing.assert_allclose(mine.x.numpy(), np.linalg.solve(H, -g),
                               atol=1e-8)
    assert bool(mine.free_mask.all())
    mine, ref = _both(np.eye(2), np.array([5.0, 5.0]), np.full(2, -1.0),
                      np.full(2, 1.0), np.zeros(2))
    _assert_same(mine, ref)
    np.testing.assert_allclose(mine.x.numpy(), [-1.0, -1.0], atol=1e-8)
    assert mine.status >= 0
    rng = np.random.default_rng(7)
    H = _random_psd(rng, 3)
    mine, ref = _both(H, np.array([4.0, -0.1, 0.05]), np.full(3, -1.0),
                      np.full(3, 1.0), np.zeros(3))
    _assert_same(mine, ref)
    fm = mine.free_mask.numpy().astype(float)
    chol = mine.chol.numpy()
    np.testing.assert_allclose(chol @ chol.T,
                               np.outer(fm, fm) * H + np.diag(1.0 - fm),
                               atol=1e-8)
    np.testing.assert_allclose(chol, np.asarray(ref.chol), atol=1e-12)


def test_worst_case_iterations_match_jax():
    """test_boxqp_worst_case_iterations: 16-dimensional QPs with condition
    number 1e6 and a friction-ridge box, from random starts.  Same status,
    iterations and free set as JAX; x within 1e-12 relative to its scale
    (the box is [0, 40]); KKT optimality; at most 100 iterations."""
    rng = np.random.default_rng(11)
    n = 16
    worst = 0
    for _ in range(20):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        H = Q @ np.diag(np.logspace(-3, 3, n)) @ Q.T
        g = rng.normal(size=n) * 10.0
        lower, upper = np.zeros(n), np.full(n, 40.0)
        x0 = rng.uniform(0, 40, size=n)
        mine, ref = _both(H, g, lower, upper, x0)
        _assert_same(mine, ref, atol=40.0 * 1e-12)
        assert mine.status >= 0
        worst = max(worst, mine.iters)
        x = mine.x.numpy()
        grad = g + H @ x
        at_lo, at_hi = x <= lower + 1e-9, x >= upper - 1e-9
        free = ~(at_lo | at_hi)
        assert np.abs(grad[free]).max(initial=0.0) < 1e-5
        assert grad[at_lo].min(initial=0.0) > -1e-6
        assert grad[at_hi].max(initial=0.0) < 1e-6
    assert worst <= 100, worst


def test_max_ls_iter_retcode():
    """test_boxqp_max_ls_iter_retcode: armijo_param > 1 makes Armijo
    unsatisfiable, so the search runs down to min_step and exits
    MAX_LS_ITER with the tiny-step candidate, on the single and the
    batched path, as in JAX; a normal config converges on the same QP."""
    H = np.diag([1.0, 2.0, 3.0])
    g = np.array([1.0, -2.0, 0.5])
    lo, hi, x0 = -10.0 * np.ones(3), 10.0 * np.ones(3), np.zeros(3)
    mine, ref = _both(H, g, lo, hi, x0, armijo_param=1.5)
    _assert_same(mine, ref)
    assert mine.status == BoxQPStatus.MAX_LS_ITER
    assert torch.isfinite(mine.x).all()
    bm = lambda a: _t(np.repeat(a[..., None], 4, axis=-1))
    x, ok, _, _, _ = boxqp_stacked(bm(H), bm(g), bm(lo), bm(hi), bm(x0),
                                   BoxQPConfig(armijo_param=1.5))
    assert torch.isfinite(x).all() and bool(ok.all())
    np.testing.assert_allclose(x[:, 0].numpy(), mine.x.numpy(), atol=1e-12)
    mine, ref = _both(np.eye(2), np.ones(2), -5.0 * np.ones(2),
                      5.0 * np.ones(2), np.zeros(2))
    _assert_same(mine, ref)
    assert mine.status in (BoxQPStatus.SMALL_IMPROVEMENT,
                           BoxQPStatus.SMALL_GRADIENT)


# A 2x2 QP that takes 5 projected-Newton iterations from x0 = 0 under
# max_ls_iter=16, beyond BoxQPConfig.unroll_iter = 4 (a random search).
_LONG_QP = (np.array([[2.38, 5.0], [5.0, 10.65]]), np.array([-1.58, -2.98]),
            np.array([-0.11, -0.99]), np.array([1.22, 0.96]), np.zeros(2))


def _qp_batch(n, B, seed):
    """Random convex QPs [n, n, B] / [n, B]; half the starts sit just
    inside the lower bound, which sends their Armijo search deep."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n, B))
    H = np.einsum("ikb,jkb->ijb", A, A) + 1e-2 * np.eye(n)[:, :, None]
    g = 5 * rng.normal(size=(n, B))
    lo = -np.abs(rng.normal(size=(n, B)))
    hi = np.abs(rng.normal(size=(n, B)))
    x0 = np.where(rng.uniform(size=(n, B)) < 0.5,
                  lo + 1e-4 * rng.uniform(size=(n, B)),
                  2 * rng.normal(size=(n, B)))
    if n == 2:
        H, g, lo, hi, x0 = (np.concatenate([a, b[..., None]], axis=-1)
                            for a, b in zip((H, g, lo, hi, x0), _LONG_QP))
    return H, g, lo, hi, x0


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_boxqp_stacked_matches_jax(n):
    """The batched BoxQP vs JAX's ``boxqp_stacked`` at fp64 with a truncated
    Armijo schedule (max_ls_iter=16, so lanes exhaust it and the
    sequential tail runs past the ls_block=9 head), lanes past
    unroll_iter=4 QP iterations (n >= 2), and lanes per-lane equal to
    ``boxqp_solve``: x, free set and factor within 1e-12, ok equal."""
    H, g, lo, hi, x0 = _qp_batch(n, 64, seed=0)
    cfg = dict(max_ls_iter=16)
    stats = {}
    x, ok, free, chol, _ = boxqp_stacked(
        *map(_t, (H, g, lo, hi, x0)), BoxQPConfig(**cfg), stats=stats)
    ref = jax_boxqp_stacked(*map(jnp.asarray, (H, g, lo, hi, x0)),
                            JaxBoxQPConfig(**cfg))
    np.testing.assert_allclose(x.numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(free.numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(chol.numpy(), np.asarray(ref[3]), rtol=0,
                               atol=1e-12)
    assert int((stats["ls_candidates"] > 9).sum()) > 0
    assert int((stats["ls_candidates"] == 17).sum()) > 0
    if n >= 2:
        assert int((stats["qp_iters"] > 4).sum()) > 0
    for b in range(0, H.shape[-1], 8):
        single = boxqp_solve(*(_t(a[..., b]) for a in (H, g, lo, hi, x0)),
                             BoxQPConfig(**cfg))
        np.testing.assert_allclose(x[:, b].numpy(), single.x.numpy(),
                                   rtol=0, atol=1e-12)
        assert single.iters == int(stats["qp_iters"][b])


def test_small_linalg_matches_jax():
    """``cholesky_small`` (with Eigen's LLT failure rule on a non-PD and a
    NaN matrix), ``cho_solve_small`` and ``lu_solve_small`` vs the JAX
    package's, batched, at fp64: 1e-12."""
    rng = np.random.default_rng(5)
    A = np.stack([_random_psd(rng, 3) for _ in range(6)])
    A[1] = -A[1]
    A[2, 0, 0] = np.nan
    Bm = rng.normal(size=(6, 3, 2))
    L, ok = linalg.cholesky_small(_t(A))
    Lj, okj = jax_linalg.cholesky_small(jnp.asarray(A))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    assert ok.tolist() == [True, False, False, True, True, True]
    keep = ok.numpy()
    np.testing.assert_allclose(L.numpy()[keep], np.asarray(Lj)[keep],
                               atol=1e-12)
    X = linalg.cho_solve_small(L, _t(Bm))
    np.testing.assert_allclose(
        X.numpy()[keep], np.asarray(jax_linalg.cho_solve_small(
            Lj, jnp.asarray(Bm)))[keep], atol=1e-12)
    np.testing.assert_allclose(
        linalg.cho_solve_small(L, _t(Bm[..., 0])).numpy()[keep],
        X.numpy()[keep][..., 0], atol=1e-12)
    G = rng.normal(size=(6, 4, 4))
    np.testing.assert_allclose(
        linalg.lu_solve_small(_t(G), _t(Bm[:, :1].repeat(4, 1))).numpy(),
        np.asarray(jax_linalg.lu_solve_small(
            jnp.asarray(G), jnp.asarray(Bm[:, :1].repeat(4, 1)))),
        atol=1e-12)
    b = rng.normal(size=(6, 4))
    np.testing.assert_allclose(linalg.lu_solve_small(_t(G), _t(b)).numpy(),
                               np.linalg.solve(G, b[..., None])[..., 0],
                               atol=1e-10)
