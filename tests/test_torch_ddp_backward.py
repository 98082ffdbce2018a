"""DDP backward of the PyTorch port: the plain twin ``backward_stacked``
vs the JAX ``backward_stacked`` and the Pallas ``backward_pallas`` (run in
interpret mode, as tests/test_pallas_kernels.py runs it), and the fused
kernel wrapper's CPU contract.  Both packages get the same cart-pole
derivative data as numpy."""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import nmpc_tpu.kernels.ddp_backward as JB
import nmpc_tpu.kernels.ddp_backward_pallas as JP
from nmpc_tpu.core.types import DDPConfig as JaxConfig
from nmpc_tpu_torch import DDPConfig, DDPSolver
from nmpc_tpu_torch.convert import ddp_config_from_reference
from nmpc_tpu_torch.kernels.ddp_backward import (StackedDerivs, StackedSecond,
                                                 backward_stacked)
from nmpc_tpu_torch.kernels.ddp_backward_fused import backward_fused
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.solvers import ddp

torch.set_num_threads(1)

DT = 0.01
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Luu", "Lxu")
SECOND = ("Fxx", "Fuu", "Fxu")


@pytest.fixture()
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _case(B, N, dtype, seed, reg_type=1, second=False):
    """(JAX config, numpy inputs dict) from a cart-pole rollout of inputs
    made with numpy: the stage derivatives batch-minor [N, ..., B],
    Vx_T [nx, B], Vxx_T [nx, nx, B].  The port's eager rollout and
    derivative sweep make the data (tests/test_torch_ddp_solve.py holds
    them against JAX); both backward passes then get the same numpy."""
    c = JaxConfig(horizon_steps=N, max_iter=10, reg_type=reg_type,
                  use_state_eq_second_derivative=second)
    cfg = ddp_config_from_reference(c)
    rng = np.random.default_rng(seed)
    x0s = (np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
           + 0.05 * rng.normal(size=(B, 4))).astype(dtype)
    us = (rng.normal(size=(B, N, 1)) * 0.2).astype(dtype)
    p = make_cartpole_problem(DT)
    t0 = torch.zeros((), dtype=torch.from_numpy(x0s).dtype)
    us_t = torch.from_numpy(us).permute(1, 2, 0).contiguous()
    xs, _ = ddp._rollout_lanes(p, cfg, t0, torch.from_numpy(x0s.T.copy()),
                               us_t)
    D, VxT, VxxT = ddp._derivative_sweep_lanes(p, cfg, t0, xs, us_t)
    data = dict(zip(FIELDS + (SECOND if second else ()),
                    (a.numpy() for a in D)))
    data["VxT"], data["VxxT"] = VxT.numpy(), VxxT.numpy()
    return c, data


def _run_jax(fn, c, data, lam, second=False):
    D = JB.StackedDerivs(*(jnp.asarray(data[f]) for f in FIELDS))
    kw = {}
    if second:
        kw["D2"] = JB.StackedSecond(*(jnp.asarray(data[f]) for f in SECOND))
    out = fn(c, D, jnp.asarray(data["VxT"]), jnp.asarray(data["VxxT"]),
             jnp.asarray(lam), **kw)
    return [np.asarray(a) for a in out]


def _port_inputs(data, lam):
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    D = StackedDerivs(*(as_t(data[f]) for f in FIELDS))
    return D, as_t(data["VxT"]), as_t(data["VxxT"]), as_t(lam)


def _run_port(c, data, lam, second=False):
    D, VxT, VxxT, lam_t = _port_inputs(data, lam)
    D2 = None
    if second:
        D2 = StackedSecond(*(torch.as_tensor(data[f]) for f in SECOND))
    out = backward_stacked(ddp_config_from_reference(c), D, VxT, VxxT, lam_t,
                           D2=D2)
    return [a.numpy() for a in out]


@pytest.mark.parametrize("reg_type", [1, 2])
def test_twin_matches_jax_stacked_fp64(reg_type):
    """Plain twin vs JAX backward_stacked, fp64 (B=16, N=12): rtol 1e-12,
    ok masks equal.  Elements near zero get an absolute floor of
    1e-14 * max|ref|: the two packages reassociate the small contractions
    differently, which moves an output by a few ulp of its scale."""
    c, data = _case(16, 12, np.float64, seed=3, reg_type=reg_type)
    lam = np.full((16,), 1e-4 if reg_type == 1 else 0.5)
    ref = _run_jax(JB.backward_stacked, c, data, lam)
    got = _run_port(c, data, lam)
    assert got[3].dtype == np.bool_
    np.testing.assert_array_equal(got[3], ref[3])
    assert got[3].all()
    for name, a, b in zip(("ks", "Ks", "dV"), got[:3], ref[:3]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-14 * np.abs(b).max(), err_msg=name)


def test_twin_matches_pallas_interpret(interpret_pallas):
    """Plain twin vs the Pallas kernel in interpret mode, fp32 (B=256,
    N=12, lambda=1e-4): ks/Ks atol 2e-5, dV atol 2e-4, ok equal, as
    tests/test_pallas_kernels.py:42-50."""
    c, data = _case(256, 12, np.float32, seed=0)
    lam = np.full((256,), 1e-4, np.float32)
    ref = _run_jax(JP.backward_pallas, c, data, lam)
    got = _run_port(c, data, lam)
    np.testing.assert_allclose(got[0], ref[0], atol=2e-5)
    np.testing.assert_allclose(got[1], ref[1], atol=2e-5)
    np.testing.assert_allclose(got[2], ref[2], atol=2e-4)
    np.testing.assert_array_equal(got[3], ref[3].astype(bool))


def test_twin_matches_pallas_interpret_reg_type2(interpret_pallas):
    """The same for reg_type=2 (B=128, N=6, lambda=0.5), as
    tests/test_pallas_kernels.py:775-800."""
    c, data = _case(128, 6, np.float32, seed=1, reg_type=2)
    lam = np.full((128,), 0.5, np.float32)
    ref = _run_jax(JP.backward_pallas, c, data, lam)
    got = _run_port(c, data, lam)
    np.testing.assert_allclose(got[0], ref[0], atol=2e-5)
    np.testing.assert_allclose(got[1], ref[1], atol=2e-5)
    np.testing.assert_allclose(got[2], ref[2], atol=2e-4)
    np.testing.assert_array_equal(got[3], ref[3].astype(bool))


@pytest.mark.parametrize("reg_type", [1, 2])
def test_failed_lanes_are_isolated(reg_type):
    """Lane 3 made non-PD (Luu = -10) and lane 5 NaN-poisoned: both fail
    in the port as in JAX, and every other lane is bit-identical to the
    clean run."""
    c, clean = _case(16, 12, np.float64, seed=4, reg_type=reg_type)
    lam = np.full((16,), 1e-4 if reg_type == 1 else 0.5)
    bad = {k: v.copy() for k, v in clean.items()}
    bad["Luu"][:, :, :, 3] = -10.0
    bad["Fx"][6, 1, 2, 5] = np.nan
    ref = _run_jax(JB.backward_stacked, c, bad, lam)
    got = _run_port(c, bad, lam)
    base = _run_port(c, clean, lam)
    np.testing.assert_array_equal(got[3], ref[3])
    assert not got[3][3] and not got[3][5]
    keep = np.ones(16, bool)
    keep[[3, 5]] = False
    assert got[3][keep].all()
    for a, b in zip(got[:3], base[:3]):
        np.testing.assert_array_equal(a[..., keep], b[..., keep])


@pytest.mark.parametrize("reg_type", [1, 2])
def test_second_order_term_matches_jax(reg_type):
    """The D2 (full-DDP Vx . F'' curvature) term vs JAX at fp64."""
    c, data = _case(8, 10, np.float64, seed=5, reg_type=reg_type,
                    second=True)
    lam = np.full((8,), 1e-4 if reg_type == 1 else 0.5)
    ref = _run_jax(JB.backward_stacked, c, data, lam, second=True)
    got = _run_port(c, data, lam, second=True)
    first = _run_port(c, data, lam)
    np.testing.assert_array_equal(got[3], ref[3])
    for name, a, b in zip(("ks", "Ks", "dV"), got[:3], ref[:3]):
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-14 * np.abs(b).max(), err_msg=name)
    # the term is not vacuous
    assert np.abs(got[1] - first[1]).max() > 1e-9


def test_fused_wrapper_on_cpu_is_the_twin():
    """On CPU tensors the fused wrapper runs the plain twin (same bits)
    and does not count a launch."""
    c, data = _case(16, 12, np.float64, seed=6)
    lam = np.full((16,), 1e-4)
    D, VxT, VxxT, lam_t = _port_inputs(data, lam)
    cfg = ddp_config_from_reference(c)
    before = backward_fused.launches
    got = backward_fused(cfg, D, VxT, VxxT, lam_t)
    ref = backward_stacked(cfg, D, VxT, VxxT, lam_t)
    assert backward_fused.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_pallas_impl_on_cpu_runs_twin_without_launch():
    """backward_impl="pallas" on CPU tensors solves through the plain twin:
    the same result as "stacked", and the launch counter stays 0."""
    p = make_cartpole_problem(DT)
    rng = np.random.default_rng(7)
    x0s = torch.as_tensor(np.tile([0.0, np.pi, 0.0, 0.0], (4, 1))
                          + 0.05 * rng.normal(size=(4, 4)))
    us0 = torch.zeros((4, 20, 1), dtype=torch.float64)
    backward_fused.launches = 0
    res = {impl: DDPSolver(p, DDPConfig(horizon_steps=20, max_iter=5,
                                        backward_impl=impl)).solve_batch(
                                            0.0, x0s, us0)
           for impl in ("pallas", "stacked", "auto")}
    assert backward_fused.launches == 0
    for impl in ("pallas", "auto"):
        assert torch.equal(res[impl].us, res["stacked"].us)
        assert torch.equal(res[impl].iters, res["stacked"].iters)


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguity"])
def test_fused_wrapper_rejects_bad_inputs(bad):
    """The wrapper checks shape, dtype and contiguity and raises."""
    N, nx, nu, B = 6, 4, 1, 8
    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape: torch.rand(shape, generator=gen,
                                     dtype=torch.float64)
    D = StackedDerivs(rand(N, nx, nx, B), rand(N, nx, nu, B), rand(N, nx, B),
                      rand(N, nu, B), rand(N, nx, nx, B), rand(N, nu, nu, B),
                      rand(N, nx, nu, B))
    VxT, VxxT, lam = rand(nx, B), rand(nx, nx, B), rand(B)
    if bad == "shape":
        lam = lam[:7]
    elif bad == "dtype":
        VxxT = VxxT.float()
    else:
        D = D._replace(Fx=D.Fx.transpose(1, 2))
    with pytest.raises(ValueError, match=bad if bad != "contiguity"
                       else "contiguous"):
        backward_fused(DDPConfig(horizon_steps=N), D, VxT, VxxT, lam)


def test_kernel_module_imports_without_nvcc_or_gpu(tmp_path):
    """Importing the kernel wrapper builds and loads nothing: it needs
    neither nvcc nor a card until the first CUDA call."""
    code = ("import shutil, torch\n"
            "import nmpc_tpu_torch.kernels.ddp_backward_fused as m\n"
            "assert shutil.which('nvcc') is None\n"
            "assert not torch.cuda.is_available()\n"
            "assert m.launcher.cache_info().currsize == 0\n"
            "assert m.backward_fused.launches == 0\n")
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "no-cuda"),
               CUDA_VISIBLE_DEVICES="",
               PATH=os.pathsep.join([os.path.dirname(sys.executable),
                                     "/usr/bin", "/bin"]))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=300)
