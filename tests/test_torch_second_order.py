"""Second-order (full) DDP solves of the port against the JAX package's,
and the port's trace dumps (``utils/trace.py``), fp64 on the CPU.

``use_state_eq_second_derivative=True`` adds the dynamics' second
derivatives (the D2 term; the reference declares it but leaves it
unimplemented, ``DDPSolver.hpp:391-414``) and runs the plain backward,
whatever ``backward_impl`` asks (an explicit kernel raises).  The cases
of ``tests/test_centroidal_and_utils.py:77-138`` on the nonlinear
cart-pole, each against JAX's solve (statuses and iterations equal, u
within 1e-8) and against the port's first-order optimum (cost within
1e-5 relative, u within 1e-3): a single solve (N = 60), a batch of three
(N = 40) also against its own single solves, and a boxed batch (force
limits +-15) inside its box.  The dumps of a port DDP and FMPC result
are the text JAX's dump functions write from the same numbers.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu import DDPConfig as JaxConfig
from nmpc_tpu import DDPSolver as JaxSolver
from nmpc_tpu.models.cartpole import make_cartpole_problem as jax_cartpole
from nmpc_tpu.utils import trace as jax_trace
from nmpc_tpu_torch import (DDPConfig, DDPSolver, DDPStatus, FmpcConfig,
                            FmpcSolver, fmpc_variable_reset)
from nmpc_tpu_torch.convert import ddp_config_from_reference
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.models.oscillator import make_oscillator_problem
from nmpc_tpu_torch.solvers.ddp import _resolve_backward_impl
from nmpc_tpu_torch.utils import trace

torch.set_num_threads(1)

DT = 0.01
HANG = [0.0, np.pi, 0.0, 0.0]


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _hold_jax(jr, res):
    np.testing.assert_array_equal(np.asarray(jr.status), res.status.numpy())
    np.testing.assert_array_equal(np.asarray(jr.iters), res.iters.numpy())
    np.testing.assert_allclose(res.us.numpy(), np.asarray(jr.us), rtol=0,
                               atol=1e-8)


def test_second_order_single_matches_jax_and_first_order():
    """One hanging cart-pole, N = 60, 100 iterations: the full DDP solve
    succeeds as JAX's does (same iterations, u within 1e-8) and reaches
    the first-order solve's optimum (cost 1e-5 relative, u 1e-3)."""
    N = 60
    jc = JaxConfig(horizon_steps=N, max_iter=100,
                   use_state_eq_second_derivative=True)
    x0, us0 = np.asarray(HANG), np.zeros((N, 1))
    jr = JaxSolver(jax_cartpole(DT), jc).solve(0.0, jnp.asarray(x0),
                                               jnp.asarray(us0))
    problem = make_cartpole_problem(DT)
    full = DDPSolver(problem, ddp_config_from_reference(jc)).solve(
        0.0, _t(x0), _t(us0))
    first = DDPSolver(problem, DDPConfig(horizon_steps=N, max_iter=100)
                      ).solve(0.0, _t(x0), _t(us0))
    _hold_jax(jr, full)
    assert int(full.status) == int(first.status) == DDPStatus.SUCCEEDED
    c1, c2 = float(first.costs.sum()), float(full.costs.sum())
    assert abs(c1 - c2) / c1 < 1e-5
    np.testing.assert_allclose(full.us.numpy(), first.us.numpy(), atol=1e-3)


def test_second_order_batch_matches_jax_and_single():
    """Three cart-poles, N = 40, 60 iterations: ``solve_batch`` as JAX's
    (statuses, iterations, u within 1e-8) and as the port's own single
    solves per lane (1e-8)."""
    N = 40
    jc = JaxConfig(horizon_steps=N, max_iter=60,
                   use_state_eq_second_derivative=True)
    x0s = np.array([HANG, [0.1, np.pi - 0.2, 0.0, 0.1],
                    [-0.1, np.pi + 0.1, 0.2, 0.0]])
    us0 = np.zeros((3, N, 1))
    jr = JaxSolver(jax_cartpole(DT), jc).solve_batch(
        0.0, jnp.asarray(x0s), jnp.asarray(us0))
    solver = DDPSolver(make_cartpole_problem(DT),
                       ddp_config_from_reference(jc))
    res = solver.solve_batch(0.0, _t(x0s), _t(us0))
    _hold_jax(jr, res)
    for i in range(3):
        single = solver.solve(0.0, _t(x0s[i]), _t(us0[i]))
        assert int(single.status) == int(res.status[i])
        assert int(single.iters) == int(res.iters[i])
        np.testing.assert_allclose(single.us.numpy(), res.us[i].numpy(),
                                   rtol=0, atol=1e-8)


def test_second_order_boxed_matches_jax():
    """Second order and the box together (force limits +-15), two
    cart-poles, N = 40, 100 iterations: as JAX's solve, every u inside
    the box and finite."""
    N = 40
    jc = JaxConfig(horizon_steps=N, max_iter=100,
                   use_state_eq_second_derivative=True,
                   with_input_constraint=True)
    x0s = np.array([HANG, [0.0, np.pi - 0.3, 0.0, 0.0]])
    us0 = np.zeros((2, N, 1))
    jr = JaxSolver(jax_cartpole(DT, input_limits=(-15.0, 15.0)),
                   jc).solve_batch(0.0, jnp.asarray(x0s), jnp.asarray(us0))
    res = DDPSolver(make_cartpole_problem(DT, input_limits=(-15.0, 15.0)),
                    ddp_config_from_reference(jc)).solve_batch(
        0.0, _t(x0s), _t(us0))
    _hold_jax(jr, res)
    assert torch.isfinite(res.us).all()
    assert res.us.min() >= -15.0 - 1e-9 and res.us.max() <= 15.0 + 1e-9


def test_second_order_takes_the_plain_backward():
    """``auto`` resolves a second-order solve to the plain backward on a
    CUDA device too; an explicit kernel raises rather than running the
    plain version in its place."""
    problem = make_cartpole_problem(DT)
    cuda = torch.device("cuda")
    assert _resolve_backward_impl(DDPConfig(), problem, torch.float64, cuda,
                                  False, True) == "stacked"
    for impl in ("pallas", "remat"):
        with pytest.raises(NotImplementedError, match="second-order"):
            _resolve_backward_impl(DDPConfig(backward_impl=impl), problem,
                                   torch.float64, cuda, False, True)


def _numpy_like(res, nested):
    """A namespace of numpy copies of ``res``'s fields (and of the
    ``nested`` dataclass fields), for JAX's dump functions."""
    out = {f.name: getattr(res, f.name).numpy()
           for f in dataclasses.fields(res) if f.name not in nested}
    for name in nested:
        sub = getattr(res, name)
        out[name] = SimpleNamespace(**{f.name: getattr(sub, f.name).numpy()
                                       for f in dataclasses.fields(sub)})
    return SimpleNamespace(**out)


def test_trace_dumps_match_jax(tmp_path):
    """A port DDP solve's and FMPC solve's trace tables, with and without
    durations, are the text JAX's dump functions write from the same
    numbers, and read back as their columns."""
    N = 30
    ddp_res = DDPSolver(make_cartpole_problem(DT),
                        DDPConfig(horizon_steps=N, max_iter=20)).solve(
        0.0, _t(HANG), torch.zeros((N, 1), dtype=torch.float64))
    osc = make_oscillator_problem(0.05)
    fmpc_res = FmpcSolver(osc, FmpcConfig(horizon_steps=20, max_iter=10)
                          ).solve(0.0, _t([0.5, -0.3]), fmpc_variable_reset(
                              20, 2, 1, osc.ineq_dim, dtype=torch.float64))
    n_ddp, n_fmpc = int(ddp_res.iters) + 1, int(fmpc_res.iters) + 1
    cases = (
        (trace.dump_ddp_trace, jax_trace.dump_ddp_trace, ddp_res, ("trace",),
         {"backward": np.linspace(0.1, 2.0, n_ddp)}),
        (trace.dump_fmpc_trace, jax_trace.dump_fmpc_trace, fmpc_res,
         ("variable", "trace"), {"coeff": np.linspace(0.5, 1.5, n_fmpc)}),
    )
    for port_dump, jax_dump, res, nested, durations in cases:
        for dur in (None, durations):
            a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
            port_dump(res, str(a), durations=dur)
            jax_dump(_numpy_like(res, nested), str(b), durations=dur)
            assert a.read_text() == b.read_text()
            table, ref = trace.load_trace(str(a)), jax_trace.load_trace(
                str(b))
            assert list(table) == list(ref)
            for name in ref:
                np.testing.assert_array_equal(table[name], ref[name])
    table = trace.load_trace(str(tmp_path / "port.txt"))
    np.testing.assert_array_equal(table["iter"], np.arange(1, n_fmpc))
