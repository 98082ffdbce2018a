"""The port's GMRES (``solvers/gmres.py``) and the fleet path's batch-minor
GMRES (``solvers/cgmres.py::gmres_bm``) against the JAX package's, on the
same seeded numpy systems, fp64 (the cases of ``tests/test_cgmres.py``:
random dense systems for every (``make_triangular``, ``reorth``), a
truncated run, a warm start, least squares against Givens, and the
batch-minor random, truncated and mixed-convergence cases).

Tolerances: x within 1e-12 of JAX's, relative to its largest entry;
iteration counts equal; ``err_history`` NaN where JAX's is and within
rtol 1e-8 (atol 1e-12 of the first residual) elsewhere: the last
residuals of a run to n are rounding-level, where the two libraries'
norms part in their last digits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu.solvers.cgmres import gmres_bm as jax_gmres_bm
from nmpc_tpu.solvers.gmres import gmres as jax_gmres
from nmpc_tpu.solvers.gmres import gmres_dense as jax_gmres_dense
from nmpc_tpu_torch import gmres, gmres_dense
from nmpc_tpu_torch.solvers.cgmres import gmres_bm

torch.set_num_threads(1)

X_TOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close_x(ref, got):
    ref, got = np.asarray(ref), got.numpy()
    assert np.abs(ref - got).max() <= X_TOL * max(np.abs(ref).max(), 1.0)


def _same_result(ref, got):
    _close_x(ref.x, got.x)
    assert int(ref.iters) == int(got.iters)
    e_ref, e_got = np.asarray(ref.err_history), got.err_history.numpy()
    np.testing.assert_array_equal(np.isnan(e_ref), np.isnan(e_got))
    np.testing.assert_allclose(e_got, e_ref, rtol=1e-8,
                               atol=1e-12 * e_ref[0])
    np.testing.assert_allclose(float(got.residual), float(ref.residual),
                               rtol=1e-8, atol=1e-12 * e_ref[0])


@pytest.mark.parametrize("n", [10, 50, 100])
@pytest.mark.parametrize("make_triangular", [True, False])
@pytest.mark.parametrize("reorth", [True, False])
def test_gmres_variants_match_jax(n, make_triangular, reorth):
    """Every (Givens, least squares) x (reorthogonalization on, off) on a
    random dense system, solved to n iterations, as JAX solves it, and to
    the dense solution (``TestGmres.cpp:114-155``)."""
    rng = np.random.default_rng(100 * n + make_triangular)
    A = rng.normal(size=(n, n)) + n * np.eye(n)
    b = rng.normal(size=n)
    kw = dict(k_max=n, reorth=reorth, make_triangular=make_triangular)
    ref = jax_gmres_dense(jnp.asarray(A), jnp.asarray(b), jnp.zeros(n), **kw)
    got = gmres_dense(_t(A), _t(b), torch.zeros(n, dtype=torch.float64),
                      **kw)
    _same_result(ref, got)
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(A, b),
                               atol=1e-8)


def test_gmres_truncated_matches_jax():
    """k_max < n on a slowly converging system: JAX's iterate, iteration
    count and monotone residual history; the true residual matches the
    tracked Givens estimate."""
    n, k = 120, 20
    rng = np.random.default_rng(0)
    A = rng.normal(size=(n, n)) + 0.2 * n * np.eye(n)
    b = rng.normal(size=n)
    At = _t(A)
    ref = jax_gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                    jnp.zeros(n), k_max=k)
    got = gmres(lambda v: At @ v, _t(b), torch.zeros(n, dtype=torch.float64),
                k_max=k)
    _same_result(ref, got)
    errs = got.err_history.numpy()
    assert np.all(np.diff(errs[~np.isnan(errs)]) <= 1e-9)
    r_true = np.linalg.norm(b - A @ got.x.numpy())
    np.testing.assert_allclose(r_true, float(got.residual), rtol=1e-6)


def test_gmres_warm_start_matches_jax():
    """A warm start near the solution, k_max = 5 (the continuation's)."""
    n = 30
    rng = np.random.default_rng(1)
    A = rng.normal(size=(n, n)) + n * np.eye(n)
    b = rng.normal(size=n)
    x_true = np.linalg.solve(A, b)
    x0 = x_true + 1e-3 * rng.normal(size=n)
    At = _t(A)
    ref = jax_gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                    jnp.asarray(x0), k_max=5)
    got = gmres(lambda v: At @ v, _t(b), _t(x0), k_max=5)
    _same_result(ref, got)
    assert np.linalg.norm(got.x.numpy() - x_true) < 1e-5


def test_gmres_least_squares_truncated_matches_givens():
    """Truncated runs of the two algorithms give the same Krylov-optimal
    iterate, each as JAX's does."""
    n, k = 80, 12
    rng = np.random.default_rng(3)
    A = rng.normal(size=(n, n)) + 0.3 * n * np.eye(n)
    b = rng.normal(size=n)
    out = {}
    for tri in (True, False):
        ref = jax_gmres_dense(jnp.asarray(A), jnp.asarray(b), jnp.zeros(n),
                              k_max=k, make_triangular=tri)
        out[tri] = gmres_dense(_t(A), _t(b),
                               torch.zeros(n, dtype=torch.float64), k_max=k,
                               make_triangular=tri)
        _same_result(ref, out[tri])
    np.testing.assert_allclose(out[False].x.numpy(), out[True].x.numpy(),
                               atol=1e-8)
    np.testing.assert_allclose(float(out[False].residual),
                               float(out[True].residual), rtol=1e-6)


def test_gmres_counts_its_host_reads():
    """The early-exit test reads one device value a trip through
    ``host``: n reads for a run to k_max = n (none once k reaches
    k_max), two where the first trip converges (an identity system)."""
    n = 6
    reads = []
    host = lambda flag: reads.append(bool(flag)) or reads[-1]
    rng = np.random.default_rng(4)
    A = _t(rng.normal(size=(n, n)) + n * np.eye(n))
    gmres(lambda v: A @ v, _t(rng.normal(size=n)),
          torch.zeros(n, dtype=torch.float64), k_max=n, host=host)
    assert len(reads) == n and all(reads)
    reads.clear()
    res = gmres(lambda v: v, _t(rng.normal(size=n)),
                torch.zeros(n, dtype=torch.float64), k_max=n, host=host)
    assert reads == [True, False] and int(res.iters) == 1


# ------------------------------------------------------------- gmres_bm


def _bm_both(As, bs, x0s, k_max):
    """(JAX's gmres_bm, the port's) on the stacked systems, as numpy."""
    A_b = np.stack(As, axis=-1)
    b_b, x0_b = np.stack(bs, axis=-1), np.stack(x0s, axis=-1)
    Aj, At = jnp.asarray(A_b), _t(A_b)
    ref = jax_gmres_bm(lambda v: jnp.einsum("ijb,jb->ib", Aj, v),
                       jnp.asarray(b_b), jnp.asarray(x0_b), k_max=k_max)
    got = gmres_bm(lambda v: torch.einsum("ijb,jb->ib", At, v), _t(b_b),
                   _t(x0_b), k_max=k_max)
    return [np.asarray(a) for a in ref], [a.numpy() for a in got]


def _same_bm(ref, got):
    (x1, k1, rho1), (x2, k2, rho2) = ref, got
    assert np.isfinite(x2).all()
    assert np.abs(x1 - x2).max() <= X_TOL * max(np.abs(x1).max(), 1.0)
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_allclose(rho2, rho1, rtol=1e-8, atol=1e-13)


def test_gmres_bm_random_dense_matches_jax():
    """Random dense systems to k_max = n: JAX's iterates and freeze
    iterations, and the dense solutions."""
    n, B = 12, 5
    rng = np.random.default_rng(3)
    As = [rng.normal(size=(n, n)) + n * np.eye(n) for _ in range(B)]
    bs = [rng.normal(size=n) for _ in range(B)]
    ref, got = _bm_both(As, bs, [np.zeros(n)] * B, k_max=n)
    _same_bm(ref, got)
    for i in range(B):
        np.testing.assert_allclose(got[0][:, i],
                                   np.linalg.solve(As[i], bs[i]), atol=1e-8)


def test_gmres_bm_truncated_matches_jax():
    """k_max < n (the continuation's k_max = 5) from warm starts."""
    n, B, k_max = 20, 4, 5
    rng = np.random.default_rng(4)
    As = [rng.normal(size=(n, n)) + 2 * n * np.eye(n) for _ in range(B)]
    bs = [rng.normal(size=n) for _ in range(B)]
    x0s = [0.1 * rng.normal(size=n) for _ in range(B)]
    ref, got = _bm_both(As, bs, x0s, k_max=k_max)
    _same_bm(ref, got)
    assert (got[1] == k_max).all()


def test_gmres_bm_mixed_convergence_matches_jax():
    """A lane converging at k = 1 batched with one running to k_max: the
    early lane's frozen Hessenberg block must not poison its
    back-substitution (no NaN), and both lanes equal JAX's."""
    n, k_max = 8, 5
    rng = np.random.default_rng(5)
    A_stiff = rng.normal(size=(n, n)) + 3 * np.eye(n)
    b = rng.normal(size=n)
    ref, got = _bm_both([np.eye(n), A_stiff], [b, b], [np.zeros(n)] * 2,
                        k_max=k_max)
    _same_bm(ref, got)
    assert got[1][0] == 1 and got[1][1] > 1
    np.testing.assert_allclose(got[0][:, 0], b, atol=1e-10)


def test_gmres_bm_all_lanes_converge_early_matches_jax():
    """Every lane converges before k_max (JAX's loop stops there; the
    port runs its k_max trips, the late ones changing nothing): JAX's
    iterates and freeze iterations, and every lane's own truncation."""
    n, k_max = 10, 8
    rng = np.random.default_rng(6)
    # eigenvalues on 1, 2 or 3 points: GMRES converges in as many trips
    As, bs = [], []
    for points in ([1.0], [1.0, 2.0], [1.0, 2.0, 3.0]):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        d = np.array([points[i % len(points)] for i in range(n)])
        As.append(Q @ np.diag(d) @ Q.T)
        bs.append(rng.normal(size=n))
    ref, got = _bm_both(As, bs, [np.zeros(n)] * 3, k_max=k_max)
    _same_bm(ref, got)
    np.testing.assert_array_equal(got[1], [1, 2, 3])
    for i in range(3):
        np.testing.assert_allclose(got[0][:, i], np.linalg.solve(As[i], bs[i]),
                                   atol=1e-9)
