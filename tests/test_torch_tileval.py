"""The port's code generator (``nmpc_tpu_torch/kernels/tileval.py``): the
scalar programs it builds from the problem's callables, run through its
torch evaluator and, where ``g++`` is present, as emitted C++ on the host,
against ``torch.func`` and the JAX tile interpreter's contract
(``tests/test_tileval.py``)."""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from nmpc_tpu_torch import DDPConfig, DDPSolver
from nmpc_tpu_torch.core.problem import Problem
from nmpc_tpu_torch.kernels import tileval
from nmpc_tpu_torch.kernels.ddp_backward_remat import remat_supported
from nmpc_tpu_torch.kernels.ddp_forward_remat import forward_remat_supported
from nmpc_tpu_torch.kernels.tileval import TileEvalError
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.solvers import ddp, stages

torch.set_num_threads(1)

DT = 0.01
NX, NU = 4, 1


def _lane_inputs(B, dtype, seed=0, nx=NX, nu=NU):
    """(t [B], x [nx, B], u [nu, B]) and the program's named inputs."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(np.array([0.1, np.pi, 0.2, -0.3])[:nx, None]
                        + rng.normal(size=(nx, B)), dtype=dtype)
    u = torch.as_tensor(rng.normal(size=(nu, B)), dtype=dtype)
    t = torch.full((B,), 0.3, dtype=dtype)
    named = {"t": t, **{f"x_{a}": x[a] for a in range(nx)},
             **{f"u_{a}": u[a] for a in range(nu)}}
    return t, x, u, named


def _reference(problem, kind, t, x, u, dtype):
    """What the generated function computes, by torch.func per lane."""
    t0 = t[0]
    if kind == "fields":
        cfg = DDPConfig(horizon_steps=1)
        D = ddp._lanes(lambda tt, xx, uu: stages._stage_derivs(
            problem, cfg, tt, xx, uu), 2)(t0, x, u)
        return [a.reshape(-1, a.shape[-1]) for a in D[:7]]
    if kind == "step":
        xn, c = ddp._step_lanes(problem)(t0, x, u)
        return [xn.to(dtype), c.to(dtype)[None]]
    return [ddp._lanes(problem.terminal_cost, 1)(t0, x).to(dtype)[None]]


def _generated(problem, kind, named, like, dtype):
    unit = tileval.generate(problem, "remat" if kind == "fields"
                            else "forward", NX, NU, dtype)
    prog, outs = unit.functions[kind]
    return torch.stack(prog.evaluate(outs, named, like))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["fields", "step", "term"])
def test_generator_matches_torch_func(kind, dtype):
    """The scalar programs (dyn / cost / term, and the Fx...Lxu columns
    folded from the jvp groups) through the torch evaluator vs the
    callables and ``_stage_derivs``: within 1e-12 at fp64.  The program
    keeps the traced ops and their order, so at fp32 it agrees to the
    last bit as well (tolerance 0)."""
    p = make_cartpole_problem(DT)
    t, x, u, named = _lane_inputs(64, dtype)
    got = _generated(p, kind, named, t, dtype)
    ref = torch.cat(_reference(p, kind, t, x, u, dtype))
    tol = 1e-12 if dtype == torch.float64 else 0.0
    assert got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=tol)


def test_fx_columns_fold_to_literals():
    """Mirror of test_tileval.py::test_jvp_onehot_seed_folds_to_analytic_
    columns: the cart-pole Jacobian's constant entries (the identity plus
    dt structure of the Euler step) fold to Python literals, at the
    dtype's rounding of dt."""
    p = make_cartpole_problem(DT)
    for dtype in (torch.float32, torch.float64):
        prog, outs = tileval.generate(p, "remat", NX, NU, dtype).functions[
            "fields"]
        Fx = [outs[r * NX:(r + 1) * NX] for r in range(NX)]
        dt_lit = torch.tensor(DT, dtype=dtype).item()
        assert Fx[0] == [1.0, 0.0, dt_lit, 0.0]
        assert Fx[1] == [0.0, 1.0, 0.0, dt_lit]
        n_lit = sum(not isinstance(e, tileval.Var) for e in outs)
        assert n_lit >= NX
        # CSE: the five jvp columns share one primal sin and cos of theta
        ops = [v.op for v in prog.live(outs)]
        assert ops.count("sin") == 1 and ops.count("cos") == 1


def _linear_problem(A, Bm, analytic):
    """x' = A x + B u, cost 0.5|x|^2 + 0.5|u|^2, optionally with analytic
    derivative callables."""
    A_t, B_t = torch.as_tensor(A), torch.as_tensor(Bm)

    def dynamics(t, x, u):
        return A_t.to(x.dtype) @ x + B_t.to(x.dtype) @ u

    def running_cost(t, x, u):
        return 0.5 * torch.sum(x * x) + 0.5 * torch.sum(u * u)

    def terminal_cost(t, x):
        return 0.5 * torch.sum(x * x)

    extra = {}
    if analytic:
        extra = dict(
            dynamics_derivs=lambda t, x, u: (A_t.to(x.dtype),
                                             B_t.to(x.dtype)),
            running_cost_derivs=lambda t, x, u: (
                x, u, torch.eye(x.shape[0], dtype=x.dtype),
                torch.eye(u.shape[0], dtype=x.dtype),
                torch.zeros((x.shape[0], u.shape[0]), dtype=x.dtype)))
    return Problem(dt=0.1, state_dim=A.shape[0], input_dim=Bm.shape[1],
                   dynamics=dynamics, running_cost=running_cost,
                   terminal_cost=terminal_cost, **extra)


@pytest.mark.parametrize("analytic", [False, True])
def test_linear_problem_fields_and_analytic_derivs(analytic):
    """A matrix-vector problem (``mv`` in the trace) and the analytic
    ``dynamics_derivs`` / ``running_cost_derivs`` groups: the generated
    fields equal ``_stage_derivs`` exactly, and a constant Jacobian folds
    entirely to literals."""
    rng = np.random.default_rng(3)
    A, Bm = rng.normal(size=(4, 4)), rng.normal(size=(4, 1))
    p = _linear_problem(A, Bm, analytic)
    t, x, u, named = _lane_inputs(16, torch.float64)
    got = _generated(p, "fields", named, t, torch.float64)
    ref = torch.cat(_reference(p, "fields", t, x, u, torch.float64))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-12)
    _, outs = tileval.generate(p, "remat", 4, 1, torch.float64).functions[
        "fields"]
    assert all(not isinstance(e, tileval.Var) for e in outs[:20])


def _gathering_problem():
    """Cart-pole whose dynamics index x with a data-dependent index."""
    p = make_cartpole_problem(DT)

    def dynamics(t, x, u):
        return p.dynamics(t, x, u) * x[torch.argmax(x)]
    return dataclasses.replace(p, dynamics=dynamics)


def test_unsupported_op_gates_every_option():
    """A data-dependent index: the generator refuses it, ``auto`` picks
    the sweep-fed kernel (K1) and the plain rollouts on CUDA, and an
    explicit remat or fused raises TileEvalError instead of running a
    plain version."""
    p = _gathering_problem()
    for dtype in (torch.float32, torch.float64):
        assert not remat_supported(p, NX, NU, dtype)
        assert not forward_remat_supported(p, NX, NU, dtype)
        with pytest.raises(TileEvalError):
            tileval.generate(p, "remat", NX, NU, dtype)
    cuda = torch.device("cuda")
    auto = DDPConfig()
    assert ddp._resolve_backward_impl(auto, p, torch.float32, cuda,
                                      False, False) == "pallas"
    assert ddp._resolve_forward_impl(auto, p, torch.float32, cuda,
                                     torch.float32) == "scan"
    x0s = torch.zeros((2, 4), dtype=torch.float64)
    us0 = torch.zeros((2, 10, 1), dtype=torch.float64)
    for change in ({"backward_impl": "remat"}, {"forward_impl": "fused"}):
        solver = DDPSolver(p, DDPConfig(horizon_steps=10, max_iter=2,
                                        **change))
        with pytest.raises(TileEvalError):
            solver.solve_batch(0.0, x0s, us0)


def test_python_branch_on_a_value_is_rejected():
    """Fake-tensor tracing: a Python ``if`` on a state value cannot be
    baked into the program along one branch; it is refused."""
    p = make_cartpole_problem(DT)

    def dynamics(t, x, u):
        return p.dynamics(t, x, u) if x[0] > 0 else -p.dynamics(t, x, u)
    q = dataclasses.replace(p, dynamics=dynamics)
    assert not forward_remat_supported(q, NX, NU, torch.float32)
    assert not remat_supported(q, NX, NU, torch.float32)


def test_big_constant_gated():
    """A captured constant of more than MAX_ELEMS elements is refused."""
    p = make_cartpole_problem(DT)
    table = torch.zeros(1000, dtype=torch.float64)

    def terminal_cost(t, x):
        return p.terminal_cost(t, x) + torch.sum(table.to(x.dtype))
    q = dataclasses.replace(p, terminal_cost=terminal_cost)
    assert not forward_remat_supported(q, NX, NU, torch.float64)
    assert remat_supported(q, NX, NU, torch.float64)


def test_trace_is_cached_across_solvers():
    """Generation is keyed on (problem, kind, nx, nu, dtype): solvers
    rebuilt for the same problem (the tick loop rebuilds one) reuse it."""
    p = make_cartpole_problem(DT)
    a = tileval.generate(p, "forward", NX, NU, torch.float32)
    hits = tileval._trace.cache_info().hits
    assert tileval.generate(p, "forward", NX, NU, torch.float32) is a
    cfg = DDPConfig(horizon_steps=5, max_iter=1, forward_impl="fused")
    x0s = torch.zeros((2, 4))
    for _ in range(2):
        DDPSolver(p, cfg).solve_batch(0.0, x0s, torch.zeros((2, 5, 1)))
    assert tileval.generate(p, "forward", NX, NU, torch.float32) is a
    assert tileval._trace.cache_info().hits == hits


_HARNESS = """
extern "C" void run_{name}(int B, const double* t, const double* x,
                           const double* u, double* out) {{
  for (int b = 0; b < B; ++b) {{
    double xb[{nx}], ub[{nu}];
    for (int a = 0; a < {nx}; ++a) xb[a] = x[a * B + b];
    for (int a = 0; a < {nu}; ++a) ub[a] = u[a * B + b];
    double o[{nout}];
    gen_{name}<double>(t[b], xb, {uarg}o);
    for (int k = 0; k < {nout}; ++k) out[k * B + b] = o[k];
  }}
}}
"""


def _many_ops_problem():
    """Cart-pole whose terminal cost runs many of the generator's ops:
    transpose, mv, slice, cat, comparison and where, stack, sum over a
    dim, tanh, exp, abs, sqrt, reciprocal, rsub."""
    p = make_cartpole_problem(DT)
    M = torch.as_tensor(np.random.default_rng(6).normal(size=(4, 4)))

    def terminal_cost(t, x):
        y = M.to(x.dtype).t() @ x
        z = torch.cat([x[1:3], y[:2]])
        w = torch.where(z > 0, z, 0.5 * z)
        s = torch.sum(torch.stack([w, z]), dim=0)
        v = (torch.tanh(s) + torch.exp(-torch.abs(s))
             + torch.sqrt(1.0 + s**2) + 1.0 / (2.0 + s * s))
        return torch.sum(v * (1 - x)) + 0.1 * t
    return dataclasses.replace(p, terminal_cost=terminal_cost)


def test_op_table_matches_torch():
    """The many-ops terminal cost through the evaluator vs torch at fp64,
    within 1e-12."""
    p = _many_ops_problem()
    t, x, u, named = _lane_inputs(64, torch.float64, seed=4)
    got = _generated(p, "term", named, t, torch.float64)
    ref = torch.cat(_reference(p, "term", t, x, u, torch.float64))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["fields", "step", "term", "many_ops"])
def test_emitted_cpp_matches_evaluator_on_host(kind, tmp_path):
    """The emitted C++ (``NMPC_FN`` is plain ``inline`` outside nvcc),
    compiled by g++ as host code at fp64, against the torch evaluator:
    within 1e-12."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ on PATH")
    p = make_cartpole_problem(DT)
    if kind == "many_ops":
        p, kind = _many_ops_problem(), "term"
    dtype = torch.float64
    unit = tileval.generate(p, "remat" if kind == "fields" else "forward",
                            NX, NU, dtype)
    prog, outs = unit.functions[kind]
    src = tmp_path / "gen.cpp"
    src.write_text(unit.cpp + _HARNESS.format(
        name=kind, nx=NX, nu=NU, nout=len(outs),
        uarg="" if kind == "term" else "ub, "))
    lib = tmp_path / "libgen.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    t, x, u, named = _lane_inputs(32, dtype, seed=5)
    out = torch.empty((len(outs), 32), dtype=dtype)
    ptr = lambda a: ctypes.c_void_p(a.contiguous().data_ptr())
    ctypes.CDLL(str(lib))[f"run_{kind}"](32, ptr(t), ptr(x), ptr(u), ptr(out))
    want = torch.stack(prog.evaluate(outs, named, t))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=1e-12)


def test_output_shapes_are_checked():
    """Callables whose outputs do not have the declared state and input
    sizes are refused, not indexed past their end."""
    p = make_cartpole_problem(DT)
    short = dataclasses.replace(
        p, dynamics=lambda t, x, u: p.dynamics(t, x, u)[:3])
    assert not forward_remat_supported(short, NX, NU, torch.float64)
    assert not remat_supported(short, NX, NU, torch.float64)
    vector_cost = dataclasses.replace(
        p, terminal_cost=lambda t, x: x * x)
    assert not forward_remat_supported(vector_cost, NX, NU, torch.float64)
