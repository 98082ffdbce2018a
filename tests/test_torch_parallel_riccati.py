"""The port's parallel-in-time Riccati (``solvers/parallel_riccati.py``)
and the horizon-sharded algorithm in one process
(``parallel/horizon.py::solve_lqr_horizon_blocks``) against the JAX
package, on the same numpy inputs (the cases of
tests/test_parallel_riccati.py).

The port's scan forms ``lax.associative_scan``'s combine tree, so its
parallel result matches JAX's to rounding (1e-12), not only the
sequential recursion's 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.solvers import parallel_riccati as jax_pr
from nmpc_tpu_torch.parallel.horizon import solve_lqr_horizon_blocks
from nmpc_tpu_torch.solvers.parallel_riccati import (LQRStage,
                                                     associative_scan,
                                                     solve_lqr_parallel,
                                                     solve_lqr_sequential)

torch.set_num_threads(1)


def _random_stage(rng, N, nx, nu, affine=True):
    """tests/test_parallel_riccati.py's stage, as numpy arrays."""
    A = rng.normal(size=(N, nx, nx)) * 0.3 + np.eye(nx)[None]
    B = rng.normal(size=(N, nx, nu)) * 0.3
    c = rng.normal(size=(N, nx)) * (0.1 if affine else 0.0)
    W = rng.normal(size=(N, nx, nx)) * 0.3
    Qxx = W @ W.transpose(0, 2, 1) + 0.5 * np.eye(nx)[None]
    Wu = rng.normal(size=(N, nu, nu)) * 0.3
    Quu = Wu @ Wu.transpose(0, 2, 1) + 1.0 * np.eye(nu)[None]
    Qux = rng.normal(size=(N, nu, nx)) * 0.2
    q = rng.normal(size=(N, nx)) * (0.2 if affine else 0.0)
    r = rng.normal(size=(N, nu)) * (0.2 if affine else 0.0)
    return (A, B, c, Qxx, Quu, Qux, q, r)


def _case(N, affine):
    rng = np.random.default_rng(N)
    nx, nu = 4, 2
    stage = _random_stage(rng, N, nx, nu, affine)
    W = rng.normal(size=(nx, nx))
    S_T = W @ W.T + np.eye(nx)
    v_T = rng.normal(size=nx) * (1.0 if affine else 0.0)
    return stage, S_T, v_T


def _both(stage, S_T, v_T):
    """(JAX parallel, JAX sequential, port parallel, port sequential)."""
    js = jax_pr.LQRStage(*map(jnp.asarray, stage))
    ts = LQRStage(*map(torch.as_tensor, stage))
    jargs, targs = (jnp.asarray(S_T), jnp.asarray(v_T)), (
        torch.as_tensor(S_T), torch.as_tensor(v_T))
    to_np = lambda out: tuple(np.asarray(a) for a in out)
    return (to_np(jax_pr.solve_lqr_parallel(js, *jargs)),
            to_np(jax_pr.solve_lqr_sequential(js, *jargs)),
            to_np(solve_lqr_parallel(ts, *targs)),
            to_np(solve_lqr_sequential(ts, *targs)))


def _close(a, b, tol):
    """Relative to the array's largest value (ROADMAP's floor)."""
    np.testing.assert_allclose(a, b, rtol=tol,
                               atol=tol * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("N", [1, 7, 64, 257])
def test_parallel_matches_jax(N, affine):
    """Ks, ks and the value matrices Ss within 1e-12 of JAX's parallel
    result, the sequential recursions within 1e-12 of each other, and the
    port's parallel Ks, ks within 1e-8 of the sequential recursion."""
    jp, jseq, tp, tseq = _both(*_case(N, affine))
    for got, want in zip(tp, jp):
        assert got.shape == want.shape
        _close(got, want, 1e-12)
    for got, want in zip(tseq, jseq):
        _close(got, want, 1e-12)
    for got, want in zip(tp[:2], tseq):
        np.testing.assert_allclose(got, want, atol=1e-8, rtol=1e-8)


@pytest.mark.parametrize("blocks", [1, 4, 8])
def test_horizon_blocks_match_sequential(blocks):
    """The horizon-sharded steps run on ``blocks`` blocks in one process
    (the totals stacked where the ranks gather them): within 1e-8 of
    JAX's sequential recursion and 1e-10 of the port's parallel scan."""
    stage, S_T, v_T = _case(64, True)
    _, jseq, tp, _ = _both(stage, S_T, v_T)
    Ks, ks, Ss = solve_lqr_horizon_blocks(
        LQRStage(*map(torch.as_tensor, stage)), torch.as_tensor(S_T),
        torch.as_tensor(v_T), blocks=blocks)
    assert Ss.shape == (64, 5, 5)
    np.testing.assert_allclose(Ks.numpy(), jseq[0], atol=1e-8, rtol=1e-8)
    np.testing.assert_allclose(ks.numpy(), jseq[1], atol=1e-8, rtol=1e-8)
    for got, want in zip((Ks, ks, Ss), (tp[0], tp[1], tp[2][:-1])):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-10,
                                   rtol=1e-10)
    with pytest.raises(ValueError, match="divisible"):
        solve_lqr_horizon_blocks(LQRStage(*map(torch.as_tensor, stage)),
                                 torch.as_tensor(S_T), blocks=5)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_associative_scan_matches_lax(n):
    """The scan forms ``lax.associative_scan``'s combine tree: with the
    non-associative f(a, b) = 2a + 3b on small integers (exact in
    float64), whose value depends on the grouping, the port's scan equals
    JAX's bit for bit, forward and reverse."""
    from jax import lax
    rng = np.random.default_rng(n)
    v = rng.integers(0, 10, size=(n, 3)).astype(np.float64)
    for reverse in (False, True):
        want = np.asarray(lax.associative_scan(
            lambda a, b: 2 * a + 3 * b, jnp.asarray(v), reverse=reverse))
        (got,) = associative_scan(lambda a, b: (2 * a[0] + 3 * b[0],),
                                  (torch.as_tensor(v),), reverse=reverse)
        np.testing.assert_array_equal(got.numpy(), want)


def test_value_matrices_match_rollout():
    """tests/test_parallel_riccati.py's value identity on the port: the
    difference of S_0's quadratic values at two states equals the
    difference of the costs of simulating the optimal policy from them."""
    rng = np.random.default_rng(0)
    nx, nu, N = 3, 2, 30
    st = LQRStage(*map(torch.as_tensor, _random_stage(rng, N, nx, nu)))
    S_T = torch.eye(nx, dtype=torch.float64)
    Ks, ks, Ss = solve_lqr_parallel(st, S_T, torch.zeros(nx,
                                                         dtype=torch.float64))

    def cost_and_value(x0):
        x, total = x0, 0.0
        for i in range(N):
            u = Ks[i] @ x + ks[i]
            total += float(0.5 * x @ st.Qxx[i] @ x + st.q[i] @ x
                           + 0.5 * u @ st.Quu[i] @ u + st.r[i] @ u
                           + u @ st.Qux[i] @ x)
            x = st.A[i] @ x + st.B[i] @ u + st.c[i]
        total += float(0.5 * x @ S_T @ x)
        z = torch.cat([x0, torch.ones(1, dtype=torch.float64)])
        return total, float(0.5 * z @ Ss[0] @ z)

    c0, v0 = cost_and_value(torch.as_tensor(rng.normal(size=nx)))
    c1, v1 = cost_and_value(torch.as_tensor(rng.normal(size=nx)))
    np.testing.assert_allclose(v0 - v1, c0 - c1, rtol=1e-7)
