"""The port's batched FMPC solve end to end against the NumPy golden FMPC
and the JAX ``solve_batch``, on the same numpy inputs (CPU tensors, so the
K8 and K11 entries run their plain versions)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden.fmpc_numpy import GoldenFmpc, GoldenFmpcConfig, OscillatorGolden
from nmpc_tpu.core.types import FmpcConfig as JaxFmpcConfig
from nmpc_tpu.core.types import fmpc_variable_reset as jax_reset
from nmpc_tpu.models.oscillator import make_oscillator_problem as jax_osc
from nmpc_tpu.solvers.fmpc import FmpcSolver as JaxFmpcSolver
from nmpc_tpu_torch import (FmpcConfig, FmpcSolver, FmpcStatus,
                            fmpc_variable_reset)
from nmpc_tpu_torch.convert import (fmpc_config_from_reference,
                                    fmpc_result_to_numpy,
                                    fmpc_variable_from_numpy)
from nmpc_tpu_torch.kernels.fmpc_backward import backward_fmpc_fused
from nmpc_tpu_torch.kernels.fmpc_forward import forward_fmpc_deltas_fused
from nmpc_tpu_torch.models.cartpole import (make_cartpole_fmpc_problem,
                                            make_cartpole_problem)
from nmpc_tpu_torch.models.oscillator import make_oscillator_problem
from nmpc_tpu_torch.solvers.fmpc import _resolve_impls

from test_fmpc import _CartPoleFmpcGolden

torch.set_num_threads(1)

DT = 0.01
VARIABLE = ("xs", "us", "lambdas", "ss", "nus")


def _golden_variable(var):
    return {k: getattr(var, k).numpy() for k in VARIABLE}


def test_oscillator_solve_matches_golden():
    """fp64 ``solve`` (N=100, 10 iterations) vs the NumPy golden: status,
    iterations, every variable within 1e-8, the KKT trace rtol 1e-8 and
    the final barrier eps rtol 1e-10 (port of
    ``test_oscillator_single_solve_matches_golden``)."""
    N = 100
    solver = FmpcSolver(make_oscillator_problem(DT),
                        FmpcConfig(horizon_steps=N, max_iter=10))
    golden = GoldenFmpc(OscillatorGolden(DT),
                        GoldenFmpcConfig(horizon_steps=N, max_iter=10))
    var = fmpc_variable_reset(N, 2, 1, 3, dtype=torch.float64)
    x0 = torch.tensor([0.0, 1.0], dtype=torch.float64)
    res = solver.solve(0.0, x0, var)
    g = golden.solve(0.0, x0.numpy(), _golden_variable(var))
    assert int(res.iters) == g["iters"] and int(res.status) == g["status"]
    for k in ("xs", "us", "ss", "nus"):
        np.testing.assert_allclose(getattr(res.variable, k).numpy(), g[k],
                                   atol=1e-8, err_msg=k)
    np.testing.assert_allclose(float(res.barrier_eps), g["barrier_eps"],
                               rtol=1e-10)
    kkt = np.asarray(g["kkt_trace"])
    np.testing.assert_allclose(res.trace.kkt_error[1:len(kkt) + 1].numpy(),
                               kkt, rtol=1e-8)
    assert solver.host_syncs == 10


def test_cartpole_solve_matches_golden():
    """fp64 cart-pole ``solve`` from hanging (N=100, 5 iterations) vs the
    NumPy golden: iterations equal, us and ss within 1e-7 (port of
    ``test_cartpole_fmpc_matches_golden``)."""
    N = 100
    solver = FmpcSolver(make_cartpole_fmpc_problem(DT),
                        FmpcConfig(horizon_steps=N, max_iter=5))
    golden = GoldenFmpc(_CartPoleFmpcGolden(DT),
                        GoldenFmpcConfig(horizon_steps=N, max_iter=5))
    var = fmpc_variable_reset(N, 4, 1, 4, dtype=torch.float64)
    x0 = torch.tensor([0.0, np.pi, 0.0, 0.0], dtype=torch.float64)
    res = solver.solve(0.0, x0, var)
    g = golden.solve(0.0, x0.numpy(), _golden_variable(var))
    assert int(res.iters) == g["iters"]
    for k in ("us", "ss"):
        np.testing.assert_allclose(getattr(res.variable, k).numpy(), g[k],
                                   atol=1e-7, err_msg=k)


def _masked_problems():
    """The oscillator with a time-varying inequality mask (the state bound
    is inactive from t = 0.095 s on) in both packages."""
    jp, pp = jax_osc(DT), make_oscillator_problem(DT)
    jmask = lambda t: jnp.stack([t < 0.095, t >= 0.0, t >= 0.0])
    pmask = lambda t: torch.stack([t < 0.095, t >= 0.0, t >= 0.0])
    return (dataclasses.replace(jp, ineq_mask=jmask),
            dataclasses.replace(pp, ineq_mask=pmask))


CASES = {
    "default": {},
    "line_search": {"enable_line_search": True},
    "line_search_lagrange": {
        "enable_line_search": True,
        "merit_const_scale_from_lagrange_multipliers": True},
    "init_complementary": {"init_complementary_variable": True},
    "break_if_llt_fails": {"break_if_llt_fails": True},
    "ineq_mask": {},
    "nan_lane": {},
    "negative_s_lane": {},
}


def _jax_numpy(res):
    out = {k: np.asarray(getattr(res, k)) for k in
           ("status", "iters", "kkt_error", "ks", "Ks", "barrier_eps")}
    out["variable"] = {k: np.asarray(getattr(res.variable, k))
                       for k in VARIABLE}
    out["trace"] = {"iter": np.asarray(res.trace.iter),
                    "kkt_error": np.asarray(res.trace.kkt_error)}
    return out


def _batch_inputs(B, N, dtype, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    x0s = (np.tile([0.0, 1.0], (B, 1))
           + scale * rng.normal(size=(B, 2))).astype(dtype)
    var = {k: np.ascontiguousarray(np.broadcast_to(
        np.asarray(getattr(jax_reset(N, 2, 1, 3, dtype=dtype), k)),
        (B,) + np.asarray(getattr(jax_reset(N, 2, 1, 3, dtype=dtype),
                                  k)).shape)) for k in VARIABLE}
    return x0s, var, np.full((B,), 1e-4, dtype)


def _solve_both(jp, pp, jc, x0s, var, eps):
    jr = JaxFmpcSolver(jp, jc).solve_batch(
        jnp.asarray(0.0, x0s.dtype), jnp.asarray(x0s),
        type(jax_reset(1, 1, 1, 1))(**{k: jnp.asarray(v)
                                       for k, v in var.items()}),
        jnp.asarray(eps))
    dtype = torch.float64 if x0s.dtype == np.float64 else torch.float32
    solver = FmpcSolver(pp, fmpc_config_from_reference(jc))
    pr = solver.solve_batch(0.0, torch.as_tensor(x0s),
                            fmpc_variable_from_numpy("cpu", dtype, **var),
                            torch.as_tensor(eps))
    return _jax_numpy(jr), fmpc_result_to_numpy(pr), solver


@pytest.mark.parametrize("case", list(CASES))
def test_solve_batch_matches_jax_fp64(case):
    """fp64 ``solve_batch`` (oscillator, B=8, N=20, 6 iterations) vs JAX's:
    statuses, iterations and the trace's iteration rows exactly; the KKT
    trace, KKT error and barrier eps rtol 1e-10 (inf and NaN in the same
    places); every variable and the gains within 1e-10.  The cases cover
    the line search (both merit scales), ``init_complementary_variable``,
    ``break_if_llt_fails``, a time-varying inequality mask, a NaN lane
    (x0: ERROR_IN_FORWARD, its variable kept) and a lane with a negative
    s (UNINITIALIZED, untouched)."""
    B, N = 8, 20
    jp, pp = (_masked_problems() if case == "ineq_mask"
              else (jax_osc(DT), make_oscillator_problem(DT)))
    x0s, var, eps = _batch_inputs(B, N, np.float64)
    if case == "nan_lane":
        x0s[3, 1] = np.nan
    if case == "negative_s_lane":
        var["ss"][2, 4, 0] = -0.5
    jc = JaxFmpcConfig(horizon_steps=N, max_iter=6, **CASES[case])
    want, got, solver = _solve_both(jp, pp, jc, x0s, var, eps)
    for k in ("status", "iters"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["trace"]["iter"], want["trace"]["iter"])
    for k, a, b in (("kkt trace", want["trace"]["kkt_error"],
                     got["trace"]["kkt_error"]),
                    ("kkt", want["kkt_error"], got["kkt_error"]),
                    ("eps", want["barrier_eps"], got["barrier_eps"])):
        np.testing.assert_allclose(b, a, rtol=1e-10, err_msg=k)
    for k in VARIABLE:
        np.testing.assert_allclose(got["variable"][k], want["variable"][k],
                                   atol=1e-10, err_msg=k)
    for k in ("ks", "Ks"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-10, err_msg=k)
    status = got["status"]
    if case == "nan_lane":
        # a NaN x0 enters through dx0 = x0 - xs[0]: the forward pass
        assert status[3] == FmpcStatus.ERROR_IN_FORWARD
        assert not np.isnan(got["variable"]["xs"][3]).any()
    if case == "negative_s_lane":
        assert status[2] == FmpcStatus.UNINITIALIZED
        assert got["iters"][2] == 0 and np.isinf(got["kkt_error"][2])
        np.testing.assert_array_equal(got["variable"]["us"][2],
                                      var["us"][2])
    if case == "ineq_mask":
        assert (got["variable"]["ss"][:, 10:, 0] == 1.0).all()
        assert (got["variable"]["nus"][:, 10:, 0] == 0.0).all()
    if "line_search" in case:
        assert solver.host_syncs > int(got["iters"].max())


def _fp32_both(max_iter, x0_scale, seed=2, B=128, N=20):
    """JAX's stacked path and the port at fp32, the population of
    ``tests/test_pallas_kernels.py::_fmpc_solve_both`` (x0 ~ scale·N(0,1),
    ``init_complementary_variable``)."""
    rng = np.random.default_rng(seed)
    x0s = (rng.normal(size=(B, 2)) * x0_scale).astype(np.float32)
    _, var, eps = _batch_inputs(B, N, np.float32)
    jc = JaxFmpcConfig(horizon_steps=N, max_iter=max_iter,
                       backward_impl="stacked",
                       init_complementary_variable=True)
    return _solve_both(jax_osc(DT), make_oscillator_problem(DT), jc, x0s,
                       var, eps)[:2]


def test_solve_batch_fp32_converged_lanes_match_jax():
    """fp32, 20 iterations (``test_pallas_fmpc_solve_batch_end_to_end``'s
    contract): the set of converged lanes equal, at least 32 of 128, us
    within 1e-5 and the KKT error within 1e-4 on them.  Diverging lanes
    are chaotic at fp32 and are not compared."""
    a, b = _fp32_both(max_iter=20, x0_scale=0.3)
    conv = a["status"] == FmpcStatus.SUCCEEDED
    np.testing.assert_array_equal(conv, b["status"] == FmpcStatus.SUCCEEDED)
    assert conv.sum() >= 32
    np.testing.assert_allclose(b["variable"]["us"][conv],
                               a["variable"]["us"][conv], atol=1e-5)
    np.testing.assert_allclose(b["kkt_error"][conv], a["kkt_error"][conv],
                               atol=1e-4)


def test_solve_batch_fp32_pre_chaos_matches_jax():
    """fp32, 2 iterations, x0 scale 0.5: every lane's status and
    iterations equal, us within 1e-5 (``..._pre_chaos_parity``)."""
    a, b = _fp32_both(max_iter=2, x0_scale=0.5)
    np.testing.assert_array_equal(b["status"], a["status"])
    np.testing.assert_array_equal(b["iters"], a["iters"])
    np.testing.assert_allclose(b["variable"]["us"], a["variable"]["us"],
                               atol=1e-5)


def test_batch_matches_single():
    """Each lane of a ``solve_batch`` equals ``solve`` on that lane alone
    (N=50, 5 iterations, fp64)."""
    N, B = 50, 3
    solver = FmpcSolver(make_oscillator_problem(DT),
                        FmpcConfig(horizon_steps=N, max_iter=5))
    x0s = torch.tensor([[0.0, 1.0], [0.2, 0.8], [-0.1, 0.9]],
                       dtype=torch.float64)
    var1 = fmpc_variable_reset(N, 2, 1, 3, dtype=torch.float64)
    batch = solver.solve_batch(0.0, x0s, dataclasses.replace(var1, **{
        k: getattr(var1, k).expand(B, *getattr(var1, k).shape)
        for k in VARIABLE}), torch.full((B,), 1e-4, dtype=torch.float64))
    for i in range(B):
        single = solver.solve(0.0, x0s[i], var1)
        assert int(batch.status[i]) == int(single.status)
        assert int(batch.iters[i]) == int(single.iters)
        np.testing.assert_allclose(batch.variable.us[i].numpy(),
                                   single.variable.us.numpy(), atol=1e-12)


def test_impl_rules():
    """``auto`` takes K8 and K11 on CUDA tensors where the kernels take the
    shape and dtype (past (8, 4, 16) their wide units, up to (16, 16,
    64)), the plain versions on CPU tensors; an explicit kernel on a shape
    past the ceiling raises, naming it; an explicit kernel on CPU tensors
    runs the plain version, launches nothing and equals ``auto``."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    osc = make_oscillator_problem(DT)
    auto = FmpcConfig()
    for dtype in (torch.float32, torch.float64):
        assert _resolve_impls(auto, osc, dtype, cuda) == ("pallas", "fused")
        assert _resolve_impls(auto, osc, dtype, cpu) == ("stacked", "scan")
    assert _resolve_impls(auto, osc, torch.float16, cuda) == ("stacked",
                                                             "scan")
    wide = dataclasses.replace(osc, input_dim=5)
    assert _resolve_impls(auto, wide, torch.float32, cuda) == ("pallas",
                                                              "fused")
    past = dataclasses.replace(osc, input_dim=17)
    assert _resolve_impls(auto, past, torch.float32, cuda) == ("stacked",
                                                              "scan")
    for kw in ({"backward_impl": "pallas"}, {"forward_impl": "fused"}):
        with pytest.raises(ValueError, match=r"up to \(16, 16"):
            _resolve_impls(FmpcConfig(**kw), past, torch.float32, cpu)

    N, B = 20, 4
    x0s = torch.tensor([[0.0, 1.0]] * B, dtype=torch.float64)
    var = fmpc_variable_reset(N, 2, 1, 3, dtype=torch.float64)
    var = dataclasses.replace(var, **{k: getattr(var, k).expand(
        B, *getattr(var, k).shape).contiguous() for k in VARIABLE})
    eps = torch.full((B,), 1e-4, dtype=torch.float64)
    counts = (backward_fmpc_fused.launches, forward_fmpc_deltas_fused.launches)
    out = [FmpcSolver(osc, FmpcConfig(horizon_steps=N, max_iter=4, **kw))
           .solve_batch(0.0, x0s, var, eps)
           for kw in ({}, {"backward_impl": "pallas",
                           "forward_impl": "fused"})]
    assert counts == (backward_fmpc_fused.launches,
                      forward_fmpc_deltas_fused.launches)
    assert torch.equal(out[0].status, out[1].status)
    assert torch.equal(out[0].variable.us, out[1].variable.us)


def test_solver_checks_its_inputs():
    """A problem without inequalities is refused; a warm start of the
    wrong shape raises, naming the field."""
    with pytest.raises(ValueError, match="inequality"):
        FmpcSolver(make_cartpole_problem(DT))
    solver = FmpcSolver(make_oscillator_problem(DT),
                        FmpcConfig(horizon_steps=10))
    var = fmpc_variable_reset(11, 2, 1, 3)
    with pytest.raises(ValueError, match="xs"):
        solver.solve(0.0, torch.zeros(2), var)
