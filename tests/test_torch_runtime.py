"""The port's native MPC executor (``nmpc_tpu_torch/runtime``) against the
JAX package's: the same C++ runtime (the port's own copy, built by g++
into build/nmpc_tpu_torch/), driven by the same callables in virtual
time; the port's solver in the loop against JAX's; real-time mode and
error propagation (tests/test_runtime.py).  The full 6 s swing-up (1500
solves) runs on the card, in chip_smoke.py's runtime phase."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nmpc_tpu import DDPConfig as JaxConfig
from nmpc_tpu import DDPSolver as JaxSolver
from nmpc_tpu.models.cartpole import make_cartpole_problem as jax_cartpole
from nmpc_tpu.mpc.driver import shift_warm_start as jax_shift
from nmpc_tpu.runtime.executor import MpcExecutor as JaxExecutor
from nmpc_tpu_torch import DDPConfig, DDPSolver
from nmpc_tpu_torch.kernels.build import BUILD_DIR
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.runtime import executor as rt
from nmpc_tpu_torch.runtime.executor import MpcExecutor, WarmStartedSolve

torch.set_num_threads(1)

HANG = [0.0, np.pi, 0.0, 0.0]


def _executor(cls, mpc_dt=0.004, limits=(-100.0, 100.0), feedback=None):
    ex = cls(nx=4, nu=1, sim_dt=0.002, mpc_dt=mpc_dt)
    ex.set_cartpole_plant(x0=HANG, m1=1.0, m2=0.5, l=2.0)
    if limits is not None:
        ex.set_input_limits(*limits)
    if feedback is not None:
        ex.set_feedback(feedback)
    return ex


class _LinearPolicy:
    """A numpy feedback law: u_ff = -k (x - x_ref), K = -k, x_pred = x."""

    def __init__(self):
        self.k = np.array([[1.0, 40.0, 2.0, 8.0]])
        self.calls = []

    def __call__(self, t, x):
        self.calls.append(t)
        ref = np.array([0.0, np.pi, 0.0, 0.0])
        return -self.k @ (x - ref), -self.k, x + 0.001 * np.sin(t)


@pytest.mark.parametrize("feedback", [None, True, False])
def test_logs_equal_jax_executor(feedback):
    """The port's executor and JAX's, driven by the same numpy callable in
    virtual time (1 s, with and without the inter-solve affine feedback),
    give identical logs, states and solve counts."""
    runs = []
    for cls in (MpcExecutor, JaxExecutor):
        ex = _executor(cls, feedback=feedback)
        pol = _LinearPolicy()
        log, stats = ex.run(pol, duration=1.0, realtime=False)
        runs.append((log, stats, ex.state(), pol.calls))
    (a, sa, xa, ca), (b, sb, xb, cb) = runs
    for f in ("ts", "xs", "us"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(xa, xb)
    assert sa.n_solves == sb.n_solves == 250 and ca == cb
    assert a.ts.shape[0] == 500


def test_library_builds_under_build_dir():
    """g++ builds the port's copy of the runtime into build/nmpc_tpu_torch/
    under a hashed name, never into the JAX package."""
    lib = rt.build()
    assert lib.parent == BUILD_DIR and lib.exists()
    assert lib.name.startswith("libnmpc_runtime-") and lib == rt.library_path()
    assert "nmpc_tpu_torch/runtime/src" in str(rt.SRC)


def test_virtual_time_swingup_matches_jax():
    """0.1 s of tests/test_runtime.py's virtual-time swing-up (25 solves,
    N=100, max_iter=3, fp64): the port's solver on the CPU in the port's
    executor against JAX's solver in JAX's executor; states within 1e-8."""
    duration = 0.1
    solver = DDPSolver(make_cartpole_problem(0.01),
                       DDPConfig(horizon_steps=100, max_iter=3))
    ex = _executor(MpcExecutor)
    log, stats = ex.run(WarmStartedSolve(solver, device="cpu"),
                        duration=duration)

    jproblem = jax_cartpole(0.01)
    jsolver = JaxSolver(jproblem, JaxConfig(horizon_steps=100, max_iter=3))
    state = {"us": jnp.zeros((100, 1))}

    def jax_solve(t, x):
        res = jsolver.solve(t, jnp.asarray(x), state["us"])
        state["us"] = jax_shift(jproblem, t + jproblem.dt, res.us)
        return (np.asarray(res.us[0]), np.asarray(res.Ks[0]),
                np.asarray(res.xs[0]))

    jex = _executor(JaxExecutor)
    jlog, jstats = jex.run(jax_solve, duration=duration)
    assert stats.n_solves == jstats.n_solves == 25
    np.testing.assert_array_equal(log.ts, jlog.ts)
    np.testing.assert_allclose(log.xs, jlog.xs, atol=1e-8, rtol=0)
    np.testing.assert_allclose(log.us, jlog.us, atol=1e-8, rtol=0)
    np.testing.assert_allclose(ex.state(), jex.state(), atol=1e-8, rtol=0)
    assert stats.p99_ms > 0


def test_realtime_mode_runs():
    """tests/test_runtime.py:57-68: the threaded wall-clock mode, 1 s,
    solves every 50 ms on the runtime's own thread: sane stats, a finite
    log.  The solve is the port's on the CPU at N=30, a fraction of an
    N=100 solve's time, so that at least three solves fit in the
    second."""
    solver = DDPSolver(make_cartpole_problem(0.01),
                       DDPConfig(horizon_steps=30, max_iter=3))
    fn = WarmStartedSolve(solver, device="cpu")
    fn(0.0, np.array(HANG))
    fn.reset()
    ex = _executor(MpcExecutor, mpc_dt=0.05, limits=None)
    log, stats = ex.run(fn, duration=1.0, realtime=True)
    assert stats.n_solves >= 3
    assert log.ts.shape[0] > 100
    assert np.all(np.isfinite(log.xs))


def test_solve_error_propagates():
    ex = _executor(MpcExecutor, limits=None)

    def bad_solve(t, x):
        raise ValueError("boom")

    with pytest.raises(RuntimeError, match="callback failed"):
        ex.run(bad_solve, duration=0.1, realtime=False)


def test_callback_outputs_from_tensors():
    """A callback may return tensors (here float32 on the CPU); the
    executor brings them to the host as float64."""
    pol = _LinearPolicy()

    def as_tensors(t, x):
        return tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32)
                     for a in pol(t, x))

    log, stats = _executor(MpcExecutor).run(as_tensors, duration=0.1)
    ref, _ = _executor(MpcExecutor).run(
        lambda t, x: tuple(np.asarray(a, np.float32).astype(float)
                           for a in _LinearPolicy()(t, x)), duration=0.1)
    np.testing.assert_array_equal(log.xs, ref.xs)
    assert stats.n_solves == 25
