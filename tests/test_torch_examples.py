"""The port's examples (``nmpc_tpu_torch/examples``) at tiny sizes on the
CPU, against what the JAX examples (``examples/*.py``) compute and print
at the same sizes."""

import importlib.util
import math
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from nmpc_tpu import DDPConfig as JaxConfig
from nmpc_tpu import DDPSolver as JaxSolver
from nmpc_tpu import DDPStatus
from nmpc_tpu import FmpcConfig as JaxFmpcConfig
from nmpc_tpu import FmpcSolver as JaxFmpcSolver
from nmpc_tpu import fmpc_variable_reset as jax_fmpc_reset
from nmpc_tpu.models.cartpole import make_cartpole_problem as jax_cartpole
from nmpc_tpu.models.oscillator import make_oscillator_problem as jax_osc
from nmpc_tpu_torch.examples import (centroidal_jump, constrained, fleet,
                                     swingup)
from nmpc_tpu_torch.utils.trace import load_trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_swingup_main(tmp_path, capsys):
    """examples/swingup.py at N=30, 20 iterations, fp64, and 0.05 s of its
    closed loop at N=20: the single solve's printed line equals the one
    JAX's solver gives at that size; the trace table is written; the loop
    applies u inside the force limits."""
    trace = str(tmp_path / "swingup_trace.txt")
    res, log = swingup.main(device="cpu", dtype=torch.float64,
                            horizon_steps=30, max_iter=20,
                            mpc_horizon_steps=20, end_t=0.05,
                            trace_path=trace)
    out = capsys.readouterr().out.splitlines()
    jres = JaxSolver(jax_cartpole(0.01, input_limits=(-15.0, 15.0)),
                     JaxConfig(horizon_steps=30, max_iter=20,
                               with_input_constraint=True)).solve(
        0.0, jnp.array([0.0, np.pi, 0.0, 0.0]), jnp.zeros((30, 1)))
    want = (f"single solve: {DDPStatus(int(jres.status)).name} in "
            f"{int(jres.iters)} iterations, cost "
            f"{float(jnp.sum(jres.costs)):.3f}, |u|max "
            f"{float(jnp.abs(jres.us).max()):.2f} N")
    assert out[0] == want
    assert out[1] == f"trace table: {trace}"
    assert load_trace(trace)["iter"].shape[0] == int(res.iters) + 1
    assert re.fullmatch(r"after 0\.05 s MPC: theta=[+-]\d\.\d{3} rad, "
                        r"omega=[+-]\d+\.\d{3} rad/s, mean solve [\d.]+ ms",
                        out[2]), out[2]
    assert log.xs.shape == (5, 4) and np.all(np.abs(log.us) <= 15.0)


def test_constrained_main(capsys):
    """examples/constrained.py at N=20, 5 steps, fp64: the final state and
    worst constraint value of JAX's loop at that size, and its line."""
    xf, worst = constrained.main(device="cpu", dtype=torch.float64,
                                 horizon_steps=20, n_steps=5)
    problem = jax_osc(0.01)
    solver = JaxFmpcSolver(problem, JaxFmpcConfig(horizon_steps=20,
                                                  max_iter=5))
    var, x, t, eps, jworst = jax_fmpc_reset(20, 2, 1, 3), jnp.array(
        [0.0, 1.0]), 0.0, 1e-4, -np.inf
    for _ in range(5):
        res = solver.solve(t, x, var, eps)
        u = res.variable.us[0]
        jworst = max(jworst, float(problem.ineq_const(t, x, u).max()))
        x = problem.dynamics(t, x, u)
        t += 0.01
        var, eps = res.variable, res.barrier_eps
    np.testing.assert_allclose(xf, np.asarray(x), atol=1e-10, rtol=0)
    np.testing.assert_allclose(worst, jworst, atol=1e-10, rtol=0)
    line = capsys.readouterr().out.strip()
    assert line == (f"final x = {np.round(xf, 4)}, worst constraint value "
                    f"over 0.05 s: {worst:+.2e} (feasible: {worst <= 0})")
    assert worst <= 0


def test_fleet_main(capsys):
    """examples/fleet.py at 8 controllers, N=20, 3 ticks: its two lines,
    the upright share computed from the log."""
    log, wall = fleet.main(device="cpu", batch=8, n_steps=3,
                           horizon_steps=20)
    out = capsys.readouterr().out.splitlines()
    assert log.xs.shape == (8, 3, 4) and log.xs.dtype == torch.float32
    assert bool(torch.isfinite(log.xs).all()) and wall > 0
    assert re.fullmatch(r"8 controllers x 3 MPC ticks in [\d.]+ s "
                        r"\([\d,]+ controller-ticks/s\)", out[0]), out[0]
    theta = np.abs(((log.xs[:, -1, 1].numpy() + math.pi) % (2 * math.pi))
                   - math.pi)
    assert out[1] == (f"upright after 0.03 s: "
                      f"{(theta < 0.5).mean() * 100:.1f}% of fleet")


def _jax_centroidal():
    spec = importlib.util.spec_from_file_location(
        "jax_centroidal_jump", os.path.join(ROOT, "examples",
                                            "centroidal_jump.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_centroidal_jump_main(tmp_path, capsys):
    """examples/centroidal_jump.py over 3 steps with a 0.3 s horizon (N =
    10), --profile: each row's state, forces, reference and iterations
    equal JAX's run at that size (1e-8), every planned position within
    1.0 of the reference (TestDDPCentroidalMotion.cpp:318), the result
    file in the reference's layout, the first solve's trace with its
    measured duration columns."""
    out, trace = tmp_path / "result.txt", tmp_path / "trace.txt"
    rows, errs, xf = centroidal_jump.main(**centroidal_jump._args([
        "--device", "cpu", "--horizon-duration", "0.3", "--end-t", "0.07",
        "--profile", "--out", str(out), "--trace", str(trace)]))
    lines = capsys.readouterr().out.splitlines()
    assert len(rows) == 3 and max(errs) < 1.0
    assert lines[0].startswith("steps=3 max_step_pos_err=")
    assert lines[1] == f"result written to {out}"
    text = out.read_text().splitlines()
    assert text[0] == centroidal_jump.COLUMNS and text[1].startswith("#")
    table = np.loadtxt(out, skiprows=1, ndmin=2)
    assert table.shape == (3, len(centroidal_jump.COLUMNS.split()))
    assert (table[:, 18] > 0).all()          # duration_opt, measured
    data = load_trace(str(trace))
    assert data["duration_backward"][1:].min() > 0

    jrows, jerrs, jxf = _jax_centroidal().run(
        end_t=0.07, horizon_duration=0.3, out_path=str(tmp_path / "j.txt"),
        trace_path=str(tmp_path / "jt.txt"))
    got = np.array([r[:17] for r in rows], float)
    want = np.array([r[:17] for r in jrows], float)
    np.testing.assert_allclose(got, want, atol=1e-8, rtol=0)
    np.testing.assert_allclose(xf, np.asarray(jxf), atol=1e-8, rtol=0)
    np.testing.assert_allclose(errs, jerrs, atol=1e-8, rtol=0)


def test_examples_defaults_and_module_run():
    """Each example's command line takes --device and defaults to the
    card and to the JAX example's sizes; one runs as a module
    (``python -m``) at a tiny size."""
    want = {
        swingup: dict(device="cuda", dtype=torch.float32, horizon_steps=100,
                      max_iter=50, mpc_horizon_steps=200, mpc_max_iter=3,
                      end_t=5.0, trace_path=None),
        fleet: dict(device="cuda", batch=4096, n_steps=100,
                    horizon_steps=100, max_iter=3),
        constrained: dict(device="cuda", dtype=torch.float32,
                          horizon_steps=200, max_iter=5, n_steps=400),
        centroidal_jump: dict(end_t=3.0, horizon_duration=3.0,
                              max_steps=None, profile=False, out_path=None,
                              trace_path=None, device="cuda"),
    }
    for mod, defaults in want.items():
        assert mod._args([]) == defaults, mod.__name__
        assert mod._args(["--device", "cpu"])["device"] == "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "nmpc_tpu_torch.examples.fleet", "--device",
         "cpu", "--batch", "2", "--n-steps", "1", "--horizon-steps", "5"],
        capture_output=True, text=True, cwd=ROOT, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("2 controllers x 1 MPC ticks in ")
