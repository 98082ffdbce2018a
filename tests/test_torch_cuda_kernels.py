"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card.  Every test here is marked ``cuda`` and skips without a card; the
file imports no JAX, so on the GPU machine it runs without the JAX
package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from nmpc_tpu_torch import DDPConfig, DDPSolver
from nmpc_tpu_torch.kernels.ddp_backward import StackedDerivs, backward_stacked
from nmpc_tpu_torch.kernels.ddp_backward_fused import backward_fused
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.solvers import ddp

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

DT = 0.01
# normalized max|a-b| / (1 + max|a|) (benchmarks/parity_gate.py:61)
TOL = {torch.float32: 2e-4, torch.float64: 1e-10}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _derivs(B, N, dtype, device):
    rng = np.random.default_rng(0)
    x0s = np.tile([0.0, np.pi, 0.0, 0.0], (B, 1)) + 0.05 * rng.normal(
        size=(B, 4))
    us = 0.2 * rng.normal(size=(N, 1, B))
    t0 = torch.zeros((), dtype=dtype, device=device)
    cfg = DDPConfig(horizon_steps=N)
    p = make_cartpole_problem(DT)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    xs, _ = ddp._rollout_lanes(p, cfg, t0, as_t(x0s.T.copy()), as_t(us))
    D, VxT, VxxT = ddp._derivative_sweep_lanes(p, cfg, t0, xs, as_t(us))
    return StackedDerivs(*D[:7]), VxT, VxxT


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("reg_type", [1, 2])
def test_kernel_matches_twin(card, dtype, reg_type):
    """A ragged batch (B=300, not a multiple of the 32-thread block), one
    non-PD lane and one NaN lane: ok masks equal, the rest within TOL."""
    B, N = 300, 17
    D, VxT, VxxT = _derivs(B, N, dtype, card)
    D.Luu[:, :, :, 7] = -10.0
    D.Fx[3, 2, 1, 299] = float("nan")
    cfg = DDPConfig(horizon_steps=N, reg_type=reg_type)
    lam = torch.full((B,), 1e-4 if reg_type == 1 else 0.5, dtype=dtype,
                     device=card)
    before = backward_fused.launches
    out = backward_fused(cfg, D, VxT, VxxT, lam)
    torch.cuda.synchronize()
    assert backward_fused.launches == before + 1
    ref = backward_stacked(cfg, D, VxT, VxxT, lam)
    assert out[3].dtype == torch.bool
    assert torch.equal(out[3], ref[3])
    assert not out[3][7] and not out[3][299] and int(out[3].sum()) == B - 2
    lanes = ref[3]
    for a, b in zip(ref[:3], out[:3]):
        a, b = a[..., lanes].double(), b[..., lanes].double()
        err = ((a - b).abs().max() / (1.0 + a.abs().max())).item()
        assert err <= TOL[dtype]


def test_unbuilt_shape_raises(card):
    """(nx, nu) = (3, 1) was not instantiated: the wrapper raises."""
    N, nx, nu, B = 4, 3, 1, 32
    r = lambda *shape: torch.rand(shape, device=card)
    D = StackedDerivs(r(N, nx, nx, B), r(N, nx, nu, B), r(N, nx, B),
                      r(N, nu, B), r(N, nx, nx, B), r(N, nu, nu, B),
                      r(N, nx, nu, B))
    with pytest.raises(ValueError, match="built for"):
        backward_fused(DDPConfig(horizon_steps=N), D, r(nx, B),
                       r(nx, nx, B), r(B))


def test_solve_batch_goes_through_kernel(card):
    """fp64 solve_batch with backward_impl="auto" launches the kernel and
    agrees with "stacked" on the card: same status and iters, us 1e-10."""
    B, N = 64, 30
    rng = np.random.default_rng(1)
    x0s = torch.as_tensor(np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                          + 0.05 * rng.normal(size=(B, 4)), device=card)
    us0 = torch.zeros((B, N, 1), dtype=torch.float64, device=card)
    cfg = DDPConfig(horizon_steps=N, max_iter=20)
    before = backward_fused.launches
    res = DDPSolver(make_cartpole_problem(DT), cfg).solve_batch(0.0, x0s, us0)
    assert backward_fused.launches > before
    ref = DDPSolver(make_cartpole_problem(DT), dataclasses.replace(
        cfg, backward_impl="stacked")).solve_batch(0.0, x0s, us0)
    assert torch.equal(res.status, ref.status)
    assert torch.equal(res.iters, ref.iters)
    assert (res.us - ref.us).abs().max().item() <= 1e-10
