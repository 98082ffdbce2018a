"""The port's utilities against the JAX package's
(tests/test_centroidal_and_utils.py:148-260): the print_level gate, the
timed solve and the trace dump, the profiled DDP and FMPC solves, the
trace plot."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu import DDPConfig as JaxConfig
from nmpc_tpu import DDPSolver as JaxSolver
from nmpc_tpu import FmpcConfig as JaxFmpcConfig
from nmpc_tpu import FmpcSolver as JaxFmpcSolver
from nmpc_tpu import fmpc_variable_reset as jax_fmpc_reset
from nmpc_tpu.models.cartpole import make_cartpole_problem as jax_cartpole
from nmpc_tpu.models.oscillator import make_oscillator_problem as jax_osc
from nmpc_tpu.utils import profiled as jax_profiled
from nmpc_tpu_torch import (DDPConfig, DDPSolver, FmpcConfig, FmpcSolver,
                            FmpcVariable, fmpc_variable_reset)
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.models.oscillator import make_oscillator_problem
from nmpc_tpu_torch.utils.profiled import (estimate_backward_split,
                                           profiled_solve_ddp,
                                           profiled_solve_fmpc)
from nmpc_tpu_torch.utils.timing import (ComputationDuration, PhaseTimer,
                                         Stopwatch, profile_solve,
                                         timed_solve)
from nmpc_tpu_torch.utils.trace import (dump_ddp_trace, dump_fmpc_trace,
                                        load_trace)

torch.set_num_threads(1)

F64 = torch.float64
HANG = [0.0, np.pi, 0.0, 0.0]
TRACE = ("cost", "lam", "dlam", "alpha", "k_rel_norm", "cost_update_actual",
         "cost_update_expected", "cost_update_ratio")


def _ddp_lines(out, tag="[DDP] iter"):
    """(iteration, the numbers) of every per-iteration message."""
    rows = []
    for line in out.splitlines():
        if line.startswith(tag):
            head, rest = line[len(tag):].split(":", 1)
            nums = [float(w) for w in rest.split() if w[0] in "0123456789-"]
            rows.append((int(head), nums))
    return rows


def test_print_level_gated_logging(capfd):
    """tests/test_centroidal_and_utils.py:240-260: level 3 prints one
    [DDP] line an iteration from ``solve``, with JAX's numbers; level 0
    prints nothing and adds no host read (host_syncs equal to the silent
    ``solve_batch``'s); ``solve_batch`` is silent at every level."""
    x0 = torch.tensor(HANG, dtype=F64)
    us0 = torch.zeros((10, 1), dtype=F64)
    problem = make_cartpole_problem(0.01)

    quiet = DDPSolver(problem, DDPConfig(horizon_steps=10, max_iter=3))
    quiet.solve(0.0, x0, us0)
    syncs0 = quiet.host_syncs
    quiet.solve_batch(0.0, x0[None], us0[None])
    assert capfd.readouterr().out == ""
    assert syncs0 == quiet.host_syncs

    loud = DDPSolver(problem, DDPConfig(horizon_steps=10, max_iter=3,
                                        print_level=3))
    loud.solve_batch(0.0, x0[None], us0[None])
    assert capfd.readouterr().out == ""
    res = loud.solve(0.0, x0, us0)
    out = capfd.readouterr().out
    assert "[DDP] iter 1:" in out and "lambda" in out
    assert out.count("[DDP] iter") == int(res.iters)
    assert loud.host_syncs > syncs0

    jres = JaxSolver(jax_cartpole(0.01), JaxConfig(
        horizon_steps=10, max_iter=3, print_level=3)).solve(
            0.0, jnp.asarray(HANG), jnp.zeros((10, 1)))
    jax.effects_barrier()
    want = _ddp_lines(capfd.readouterr().out)
    got = _ddp_lines(out)
    assert [r[0] for r in got] == [r[0] for r in want] == list(
        range(1, int(jres.iters) + 1))
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                               rtol=1e-5)


def test_fmpc_print_level(capfd):
    """The FMPC messages (nmpc_tpu/solvers/fmpc.py:623-635) from ``solve``
    at level 3: one line a step, with JAX's iteration numbers and KKT
    errors; none at level 0 and from ``solve_batch``."""
    N = 20
    x0 = torch.tensor([0.0, 1.0], dtype=F64)
    var = fmpc_variable_reset(N, 2, 1, 3, dtype=F64)
    problem = make_oscillator_problem(0.01)
    quiet = FmpcSolver(problem, FmpcConfig(horizon_steps=N, max_iter=3))
    quiet.solve(0.0, x0, var)
    syncs0 = quiet.host_syncs
    assert capfd.readouterr().out == ""
    loud = FmpcSolver(problem, FmpcConfig(horizon_steps=N, max_iter=3,
                                          print_level=3))
    batch = FmpcVariable(**{f.name: getattr(var, f.name)[None]
                            for f in dataclasses.fields(var)})
    loud.solve_batch(0.0, x0[None], batch, torch.tensor([1e-4], dtype=F64))
    assert capfd.readouterr().out == ""
    loud.solve(0.0, x0, var)
    out = capfd.readouterr().out
    assert loud.host_syncs > syncs0

    JaxFmpcSolver(jax_osc(0.01), JaxFmpcConfig(
        horizon_steps=N, max_iter=3, print_level=3)).solve(
            0.0, jnp.asarray([0.0, 1.0]), jax_fmpc_reset(N, 2, 1, 3))
    jax.effects_barrier()
    want = _ddp_lines(capfd.readouterr().out, "[FMPC] iter")
    got = _ddp_lines(out, "[FMPC] iter")
    assert len(got) == len(want) == 3
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                               rtol=1e-5)


def test_trace_dump_roundtrip(tmp_path):
    """tests/test_centroidal_and_utils.py:148-164 on the port."""
    solver = DDPSolver(make_cartpole_problem(0.01),
                       DDPConfig(horizon_steps=30, max_iter=20))
    res, dur = timed_solve(solver, 0.0, torch.tensor(HANG, dtype=F64),
                           torch.zeros((30, 1), dtype=F64))
    assert isinstance(dur, ComputationDuration) and dur.solve > 0
    path = os.path.join(tmp_path, "trace.txt")
    dump_ddp_trace(res, path)
    data = load_trace(path)
    assert list(data.keys()) == [
        "iter", "cost", "lambda", "dlambda", "alpha", "k_rel_norm",
        "cost_update_actual", "cost_update_expected", "cost_update_ratio",
        "duration_derivative", "duration_backward", "duration_forward"]
    assert data["iter"].shape[0] == int(res.iters) + 1
    assert data["cost"][0] == pytest.approx(float(res.trace.cost[0]))


def test_stopwatch_phase_timer_and_profile(tmp_path):
    """Stopwatch accumulates a phase; PhaseTimer fills rows and leaves out
    rows past its table; profile_solve writes a Chrome trace."""
    sw = Stopwatch()
    for _ in range(2):
        with sw.phase("solve"):
            sum(range(1000))
    assert sw.durations_ms["solve"] > 0
    assert sw.as_computation_duration().solve == sw.durations_ms["solve"]
    timer = PhaseTimer("cpu")
    for row in (1, 1, 2, 9):
        with timer.phase("coeff", row):
            sum(range(1000))
    dur = timer.durations(3, ("backward",))
    assert dur["backward"].tolist() == [0.0, 0.0, 0.0]
    assert dur["coeff"][0] == 0 and dur["coeff"][1] > 0 and dur["coeff"][2] > 0
    solver = DDPSolver(make_cartpole_problem(0.01),
                       DDPConfig(horizon_steps=10, max_iter=2))
    res, path = profile_solve(solver, 0.0, torch.tensor(HANG, dtype=F64),
                              torch.zeros((10, 1), dtype=F64),
                              log_dir=tmp_path)
    assert os.path.dirname(path) == str(tmp_path) and os.path.getsize(path)
    assert int(res.iters) == 2


def _close_trace(got, want):
    """The DDP trace rows against JAX's (ROADMAP, "The trace rows"): cost,
    lambda, dlambda, alpha and the expected update at rtol 1e-12; the
    differences of near-equal numbers (the actual update, k_rel_norm)
    with an absolute floor of 1e-12 times the row's largest value, and
    the ratio as ratio * expected against JAX's actual update with that
    floor, signs equal."""
    for name in ("cost", "lam", "dlam", "alpha", "cost_update_expected"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-12,
                                   err_msg=name)
    for name in ("k_rel_norm", "cost_update_actual"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-12,
                                   atol=1e-12 * np.abs(want[name]).max(),
                                   err_msg=name)
    np.testing.assert_allclose(
        got["cost_update_ratio"] * want["cost_update_expected"],
        want["cost_update_actual"], rtol=1e-12,
        atol=1e-12 * np.abs(want["cost_update_actual"]).max())
    np.testing.assert_array_equal(np.sign(got["cost_update_ratio"]),
                                  np.sign(want["cost_update_ratio"]))


def test_profiled_solve_ddp(tmp_path):
    """tests/test_centroidal_and_utils.py:166-203: the profiled solve is
    the untimed solve bit for bit, matches JAX's profiled result (status,
    iterations, us within 1e-10, the trace rows), and fills every phase
    column of every iteration with milliseconds above 0."""
    N = 30
    solver = DDPSolver(make_cartpole_problem(0.01),
                       DDPConfig(horizon_steps=N, max_iter=20))
    x0 = torch.tensor(HANG, dtype=F64)
    us0 = torch.zeros((N, 1), dtype=F64)
    plain = solver.solve(0.0, x0, us0)
    prof, dur, cd = profiled_solve_ddp(solver, 0.0, x0, us0)
    for f in ("status", "iters", "xs", "us", "costs", "ks", "Ks", "lam",
              "dlam"):
        assert torch.equal(getattr(prof, f), getattr(plain, f)), f
    for f in ("iter",) + TRACE:
        assert torch.equal(getattr(prof.trace, f), getattr(plain.trace, f))

    jsolver = JaxSolver(jax_cartpole(0.01), JaxConfig(horizon_steps=N,
                                                      max_iter=20))
    jprof, _, _ = jax_profiled.profiled_solve_ddp(
        jsolver, 0.0, jnp.asarray(HANG), jnp.zeros((N, 1)))
    assert int(prof.status) == int(jprof.status)
    assert int(prof.iters) == int(jprof.iters)
    np.testing.assert_allclose(prof.us.numpy(), np.asarray(jprof.us),
                               atol=1e-10)
    _close_trace({f: getattr(prof.trace, f).numpy() for f in TRACE},
                 {f: np.asarray(getattr(jprof.trace, f)) for f in TRACE})

    n = int(prof.iters)
    for k in ("derivative", "backward", "forward"):
        assert dur[k].shape == (21,) and dur[k][0] == 0
        assert dur[k][1:n + 1].min() > 0.0, k
    assert 0 < cd.opt <= cd.solve and cd.setup > 0
    assert cd.derivative + cd.backward + cd.forward == pytest.approx(cd.opt)

    path = os.path.join(tmp_path, "trace_prof.txt")
    dump_ddp_trace(prof, path, durations=dur)
    assert load_trace(path)["duration_backward"][1:].min() > 0.0

    split = estimate_backward_split(solver, 0.0, x0, us0)
    assert set(split) == {"Q", "reg", "gain"}
    assert all(v > 0 for v in split.values())

    # numpy inputs go to the device asked for (the card by default)
    again, _, _ = profiled_solve_ddp(solver, 0.0, x0.numpy(), us0.numpy(),
                                     warmup=False, device="cpu")
    assert torch.equal(again.us, plain.us)


def test_profiled_solve_fmpc(tmp_path):
    """tests/test_centroidal_and_utils.py:206-238: the profiled FMPC
    solve is the untimed solve bit for bit, matches JAX's profiled result
    (us within 1e-10, the KKT trace row), and fills the coeff / backward
    / forward / update columns."""
    N = 50
    solver = FmpcSolver(make_oscillator_problem(0.01),
                        FmpcConfig(horizon_steps=N, max_iter=5))
    var = fmpc_variable_reset(N, 2, 1, 3, dtype=F64)
    x0 = torch.tensor([0.0, 1.0], dtype=F64)
    plain = solver.solve(0.0, x0, var)
    prof, dur = profiled_solve_fmpc(solver, 0.0, x0, var)
    assert torch.equal(prof.status, plain.status)
    assert torch.equal(prof.iters, plain.iters)
    for f in ("xs", "us", "lambdas", "ss", "nus"):
        assert torch.equal(getattr(prof.variable, f),
                           getattr(plain.variable, f)), f
    assert torch.equal(prof.trace.kkt_error, plain.trace.kkt_error)

    jsolver = JaxFmpcSolver(jax_osc(0.01), JaxFmpcConfig(horizon_steps=N,
                                                         max_iter=5))
    jprof, _ = jax_profiled.profiled_solve_fmpc(
        jsolver, 0.0, jnp.asarray([0.0, 1.0]), jax_fmpc_reset(N, 2, 1, 3))
    assert int(prof.status) == int(jprof.status)
    assert int(prof.iters) == int(jprof.iters)
    np.testing.assert_allclose(prof.variable.us.numpy(),
                               np.asarray(jprof.variable.us), atol=1e-10)
    np.testing.assert_allclose(prof.trace.kkt_error.numpy(),
                               np.asarray(jprof.trace.kkt_error), rtol=1e-10)

    n = int(prof.iters)
    assert dur["coeff"][1:n + 1].min() > 0.0
    for k in ("backward", "forward", "update"):
        assert dur[k][1:n].min() > 0.0, k
    path = os.path.join(tmp_path, "fmpc_trace_prof.txt")
    dump_fmpc_trace(prof, path, durations=dur)
    assert load_trace(path)["duration_coeff"].min() > 0.0


def test_plot_trace_file(tmp_path):
    """plot_trace_file on a dumped trace with the Agg backend: one axis a
    column, the figure written."""
    pytest.importorskip("matplotlib")
    from nmpc_tpu_torch.utils.plotting import plot_trace_file

    solver = DDPSolver(make_cartpole_problem(0.01),
                       DDPConfig(horizon_steps=10, max_iter=3))
    res = solver.solve(0.0, torch.tensor(HANG, dtype=F64),
                       torch.zeros((10, 1), dtype=F64))
    trace = os.path.join(tmp_path, "trace.txt")
    dump_ddp_trace(res, trace)
    out = os.path.join(tmp_path, "trace.png")
    fig = plot_trace_file(trace, out_path=out)
    assert len(fig.axes) == len(load_trace(trace)) - 1
    assert os.path.getsize(out) > 0
