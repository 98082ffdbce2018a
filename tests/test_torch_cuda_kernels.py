"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: the sweep-fed backward (K1) and its boxed variant (K4), the remat
backward (K5, unboxed and boxed), the fused rollouts (K6, K7), and FMPC's
condensed Riccati backward (K8) and Δx/Δu recursion (K11), and the
layout variants that must equal their parents bit for bit: the chunked
and packed DDP backward (K2, K3) against K1, the resident and packed FMPC
backward (K9, K10) against K8, with the solver keywords that select them;
the group kernels (K1, K2, K3, K5 unboxed, K8, K10) at every group size
against one thread per lane, the forward recursions (K6, K11) at every
chunk of their ring, feed and group size against the one-stage build,
and K1, K3, K8, K10 and K11 where TMA does not take a field or buffer as
it is.
Every test
here is marked ``cuda`` and skips without a card; the file imports no JAX,
so on the GPU machine it runs without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from nmpc_tpu_torch import (BoxQPConfig, DDPConfig, DDPSolver, FmpcConfig,
                            FmpcSolver, FmpcVariable, fmpc_variable_reset)
from nmpc_tpu_torch.kernels.ddp_backward import (StackedBounds, StackedDerivs,
                                                 backward_stacked,
                                                 backward_stacked_boxed)
from nmpc_tpu_torch.kernels.ddp_backward_boxed import backward_fused_boxed
from nmpc_tpu_torch.kernels import ddp_backward_fused as fused
from nmpc_tpu_torch.kernels import ddp_backward_remat as remat
from nmpc_tpu_torch.kernels.ddp_backward_fused import (backward_fused,
                                                       backward_packed,
                                                       chunk_stages,
                                                       pack_derivs)
from nmpc_tpu_torch.kernels.ddp_backward_remat import (backward_remat,
                                                       backward_remat_plain)
from nmpc_tpu_torch.kernels import ddp_forward_remat as fwd
from nmpc_tpu_torch.kernels.ddp_forward_remat import (forward_costs_remat,
                                                      forward_selected_remat)
from nmpc_tpu_torch.kernels import fmpc_backward
from nmpc_tpu_torch.kernels.fmpc_backward import (backward_fmpc_fused,
                                                  backward_fmpc_packed)
from nmpc_tpu_torch.kernels import fmpc_forward
from nmpc_tpu_torch.kernels.fmpc_forward import (forward_fmpc_deltas_fused,
                                                 forward_fmpc_deltas_plain)
from nmpc_tpu_torch.kernels.tileval import TileEvalError
from nmpc_tpu_torch.core.problem import Problem
from nmpc_tpu_torch.models.cartpole import (CartPoleCostWeight,
                                            CartPoleParam, cartpole_xdot,
                                            make_cartpole_fmpc_problem,
                                            make_cartpole_problem)
from nmpc_tpu_torch.models.bipedal import (example_omega2_func,
                                           example_ref_zmp_func,
                                           make_bipedal_problem)
from nmpc_tpu_torch.models.oscillator import make_oscillator_problem
from nmpc_tpu_torch.models.vertical import make_vertical_problem
from nmpc_tpu_torch.solvers import ddp
from nmpc_tpu_torch.solvers import fmpc

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
    """(nx, nu) = (10, 1) and (9, 17) are past every mode's limits (nx <=
    9, nu <= 16): the wrapper raises, naming the shape."""
    r = lambda *shape: torch.rand(shape, device=card)

    def derivs(N, nx, nu, B):
        return StackedDerivs(r(N, nx, nx, B), r(N, nx, nu, B), r(N, nx, B),
                             r(N, nu, B), r(N, nx, nx, B), r(N, nu, nu, B),
                             r(N, nx, nu, B))

    N, B = 4, 32
    for nx, nu in ((10, 1), (9, 17)):
        for dma in fused.DMA_MODES:
            with pytest.raises(ValueError, match=rf"built for.*\({nx}, "
                               rf"{nu}\)"):
                backward_fused(DDPConfig(horizon_steps=N),
                               derivs(N, nx, nu, B), r(nx, B), r(nx, nx, B),
                               r(B), dma=dma)


def _exact_sqrt(a):
    return torch.from_numpy(np.sqrt(a.numpy()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("reg_type", [1, 2])
def test_k1_wide_matches_plain(card, monkeypatch, dtype, reg_type):
    """K1 at the centroidal model's (9, 16) on the stage fields of a
    centroidal rollout across the flight phase (B=256, N=30), one non-PD
    and one NaN lane: its launch counted as ``wide_launches``, the ok
    masks equal and every ok lane bit for bit equal to
    ``backward_stacked`` on the CPU with a correctly rounded sqrt (there
    it sums in the kernel's order; the plain version on the card reorders
    its sums, which Quu's conditioning at fp32 makes visible)."""
    from nmpc_tpu_torch.models.centroidal import make_centroidal_problem
    B, N = 256, 30
    p = make_centroidal_problem(0.03)
    cfg = DDPConfig(horizon_steps=N, reg_type=reg_type)
    rng = np.random.default_rng(3)
    x0 = np.concatenate([[0.0, 0.0, 1.0], np.zeros(6)])
    x0s = torch.as_tensor((np.tile(x0, (B, 1))
                           + 0.02 * rng.normal(size=(B, 9))).T,
                          dtype=dtype, device=card).contiguous()
    us = torch.as_tensor(60.0 + 5.0 * rng.normal(size=(N, 16, B)),
                         dtype=dtype, device=card)
    t0 = torch.tensor(1.3, dtype=dtype, device=card)
    xs, _ = ddp._rollout_lanes(p, cfg, t0, x0s, us)
    D, VxT, VxxT = ddp._derivative_sweep_lanes(p, cfg, t0, xs, us)
    D = StackedDerivs(*(a.contiguous() for a in D[:7]))
    D.Luu[:, :, :, 5] = -10.0
    D.Fx[N // 2, 0, 0, 200] = float("nan")
    lam = torch.full((B,), 1e-6 if reg_type == 1 else 0.5, dtype=dtype,
                     device=card)
    before = (backward_fused.launches, backward_fused.wide_launches)
    out = backward_fused(cfg, D, VxT, VxxT, lam)
    torch.cuda.synchronize()
    assert (backward_fused.launches,
            backward_fused.wide_launches) == (before[0], before[1] + 1)
    cpu = lambda a: a.cpu()
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", _exact_sqrt)
        ref = backward_stacked(cfg, StackedDerivs(*map(cpu, D)), cpu(VxT),
                               cpu(VxxT), cpu(lam))
    ok = ref[3]
    assert torch.equal(out[3].cpu(), ok)
    assert not ok[5] and not ok[200] and int(ok.sum()) == B - 2
    for a, b in zip(ref[:3], out[:3]):
        assert torch.equal(a[..., ok].contiguous().view(torch.uint8),
                           b.cpu()[..., ok].contiguous().view(torch.uint8))


def test_solve_batch_goes_through_kernel(card):
    """fp64 solve_batch on the sweep-fed path (backward_impl="pallas"; on
    the card ``auto`` now takes the remat kernel) launches the kernel and
    agrees with "stacked" on the card: same status and iters, us 1e-10."""
    B, N = 64, 30
    rng = np.random.default_rng(1)
    x0s = torch.as_tensor(np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                          + 0.05 * rng.normal(size=(B, 4)), device=card)
    us0 = torch.zeros((B, N, 1), dtype=torch.float64, device=card)
    cfg = DDPConfig(horizon_steps=N, max_iter=20, backward_impl="pallas")
    before = backward_fused.launches
    res = DDPSolver(make_cartpole_problem(DT), cfg).solve_batch(0.0, x0s, us0)
    assert backward_fused.launches > before
    ref = DDPSolver(make_cartpole_problem(DT), dataclasses.replace(
        cfg, backward_impl="stacked")).solve_batch(0.0, x0s, us0)
    assert torch.equal(res.status, ref.status)
    assert torch.equal(res.iters, ref.iters)
    assert (res.us - ref.us).abs().max().item() <= 1e-10


def _trajectory(B, N, dtype, device, seed=2):
    """A cart-pole rollout (xs, us), its terminal expansion and t0=0.3,
    batch-minor on ``device``."""
    rng = np.random.default_rng(seed)
    p, cfg = make_cartpole_problem(DT), DDPConfig(horizon_steps=N)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    x0s = np.tile([0.0, np.pi, 0.0, 0.0], (B, 1)) + 0.05 * rng.normal(
        size=(B, 4))
    us = as_t(0.2 * rng.normal(size=(N, 1, B)))
    t0 = as_t(0.3)
    xs, _ = ddp._rollout_lanes(p, cfg, t0, as_t(x0s.T.copy()), us)
    VxT, VxxT = (a.contiguous() for a in ddp._terminal_quad_lanes(
        p, cfg, t0, xs))
    return p, t0, xs, us, VxT, VxxT


def _norm_err(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / (1.0 + a.abs().max())).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("reg_type", [1, 2])
def test_remat_backward_matches_plain(card, dtype, reg_type):
    """K5 vs its plain version (derivative sweep + backward_stacked) on a
    ragged batch, with a NaN lane (a NaN state) and a non-PD lane (a
    negative definite terminal Vxx): ok masks equal, the rest within
    TOL."""
    B, N = 300, 17
    p, t0, xs, us, VxT, VxxT = _trajectory(B, N, dtype, card)
    xs[5, 1, 299] = float("nan")
    VxxT[:, :, 7] = -1e6 * torch.eye(4, dtype=dtype, device=card)
    cfg = DDPConfig(horizon_steps=N, reg_type=reg_type)
    lam = torch.full((B,), 1e-4 if reg_type == 1 else 0.5, dtype=dtype,
                     device=card)
    before = backward_remat.launches
    out = backward_remat(p, cfg, t0, xs, us, VxT, VxxT, lam)
    torch.cuda.synchronize()
    assert backward_remat.launches == before + 1
    ref = backward_remat_plain(p, cfg, t0, xs, us, VxT, VxxT, lam)
    assert torch.equal(out[3], ref[3])
    assert not out[3][7] and not out[3][299] and int(out[3].sum()) == B - 2
    for a, b in zip(ref[:3], out[:3]):
        assert _norm_err(a[..., ref[3]], b[..., ref[3]]) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_rollouts_match_plain(card, dtype):
    """K6 and K7 vs their plain versions, with gains from a real backward
    pass; K7's column for an alpha equals K6's sum at that alpha."""
    B, N = 300, 40
    p, t0, xs, us, VxT, VxxT = _trajectory(B, N, dtype, card)
    cfg = DDPConfig(horizon_steps=N)
    lam = torch.full((B,), 1e-4, dtype=dtype, device=card)
    ks, Ks, _, ok = backward_remat_plain(p, cfg, t0, xs, us, VxT, VxxT, lam)
    assert bool(ok.all())
    alpha = torch.as_tensor(np.random.default_rng(3).uniform(0.1, 1.0, B),
                            dtype=dtype, device=card)
    counts = (forward_selected_remat.launches, forward_costs_remat.launches)
    sel = forward_selected_remat(p, cfg, t0, xs, us, ks, Ks, alpha)
    alphas = torch.tensor(cfg.alpha_list, dtype=dtype, device=card)
    sums = forward_costs_remat(p, cfg, t0, xs, us, ks, Ks, alphas)
    torch.cuda.synchronize()
    assert (forward_selected_remat.launches,
            forward_costs_remat.launches) == (counts[0] + 1, counts[1] + 1)
    ref = ddp._forward_selected_lanes(p, cfg, t0, xs, us, ks, Ks, alpha,
                                      dtype)
    for a, b in zip(ref, sel):
        assert _norm_err(a, b) <= TOL[dtype]
    ref = ddp._forward_costs_lanes(p, cfg, t0, xs, us, ks, Ks, alphas, dtype)
    assert _norm_err(ref, sums) <= TOL[dtype]
    at3 = forward_selected_remat(p, cfg, t0, xs, us, ks, Ks,
                                 alphas[3].expand(B).contiguous())[3]
    assert torch.equal(sums[3], at3)


def test_solve_batch_goes_through_remat_kernels(card):
    """fp64 solve_batch with backward_impl="remat", forward_impl="fused"
    launches K5, K6 and K7 and agrees with the plain path on the card:
    same status and iters, us 1e-10."""
    B, N = 64, 30
    rng = np.random.default_rng(1)
    x0s = torch.as_tensor(np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                          + 0.05 * rng.normal(size=(B, 4)), device=card)
    us0 = torch.zeros((B, N, 1), dtype=torch.float64, device=card)
    cfg = DDPConfig(horizon_steps=N, max_iter=20, ls_mode="sweep",
                    backward_impl="remat", forward_impl="fused")
    kernels = (backward_remat, forward_selected_remat, forward_costs_remat)
    before = [k.launches for k in kernels]
    res = DDPSolver(make_cartpole_problem(DT), cfg).solve_batch(0.0, x0s, us0)
    assert all(k.launches > b for k, b in zip(kernels, before))
    ref = DDPSolver(make_cartpole_problem(DT), dataclasses.replace(
        cfg, backward_impl="stacked", forward_impl="scan")).solve_batch(
            0.0, x0s, us0)
    assert torch.equal(res.status, ref.status)
    assert torch.equal(res.iters, ref.iters)
    assert (res.us - ref.us).abs().max().item() <= 1e-10


def test_explicit_remat_on_rejected_problem_raises(card):
    """A problem the generator rejects (a data-dependent index) raises
    TileEvalError on CUDA tensors too, for remat and for fused."""
    p = make_cartpole_problem(DT)
    q = dataclasses.replace(p, dynamics=lambda t, x, u: p.dynamics(
        t, x, u) * x[torch.argmax(x)])
    x0s = torch.zeros((4, 4), device=card)
    us0 = torch.zeros((4, 10, 1), device=card)
    for change in ({"backward_impl": "remat"}, {"forward_impl": "fused"}):
        solver = DDPSolver(q, DDPConfig(horizon_steps=10, max_iter=2,
                                        **change))
        with pytest.raises(TileEvalError):
            solver.solve_batch(0.0, x0s, us0)


def _vertical_trajectory(B, N, dtype, device, seed=5):
    """A boxed vertical-model rollout from t0=1.9 (the horizon crosses the
    switch to two contacts), batch-minor on ``device``."""
    rng = np.random.default_rng(seed)
    p = make_vertical_problem(DT)
    cfg = DDPConfig(horizon_steps=N, with_input_constraint=True)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    x0s = np.tile([1.2, 0.0], (B, 1)) + 0.05 * rng.normal(size=(B, 2))
    us = as_t(0.02 * rng.normal(size=(N, 2, B)))
    t0 = as_t(1.9)
    xs, _ = ddp._rollout_lanes(p, cfg, t0, as_t(x0s.T.copy()), us)
    VxT, VxxT = (a.contiguous() for a in ddp._terminal_quad_lanes(
        p, cfg, t0, xs))
    return p, cfg, t0, xs, us, VxT, VxxT


# The cases each boxed kernel is held to its plain version on: the planted
# lanes at B=300; the same at B=303, so that the last block holds fewer
# lanes than a block's 32 / kQpGroup (csrc/boxqp.cuh); B=1; and a lane made
# NaN under min_step = 0 (see _exhausted), whose QPs run the whole
# 105-candidate Armijo schedule.
BOXED_CASES = ("planted", "ragged", "one", "exhausted")


def _boxed_case(case):
    """(B, the BoxQPConfig of the case)."""
    B = {"planted": 300, "ragged": 303, "one": 1, "exhausted": 300}[case]
    qp = BoxQPConfig(min_step=0.0) if case == "exhausted" else BoxQPConfig()
    return B, qp


def _hold_boxed(ref, out, stats, case, planted, B):
    """The kernel's (ks, Ks, dV, ok) equal the plain version's bit for bit
    on the ok lanes with finite gains, the ok masks equal; the planted
    lanes fail (non-PD, NaN); the exhausted case's NaN lane (4) visits all
    105 candidates in one QP iteration and ends ok with NaN gains in
    both."""
    assert torch.equal(out[3], ref[3])
    fails = planted if B > max(planted) else ()
    assert all(not out[3][lane] for lane in fails)
    assert int(out[3].sum()) == B - len(fails)
    finite = lambda ks: torch.isfinite(ks).flatten(0, -2).all(0)
    lanes = ref[3] & finite(ref[0])
    assert torch.equal(lanes, out[3] & finite(out[0]))
    for a, b in zip(ref[:3], out[:3]):
        assert torch.equal(a[..., lanes], b[..., lanes])
    if case == "exhausted":
        assert int(stats["ls_candidates"][:, 4].max()) == 105
        assert bool(out[3][4]) and not bool(lanes[4])
    else:
        assert torch.equal(lanes, out[3])


@pytest.mark.parametrize("case", BOXED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("reg_type", [1, 2])
def test_boxed_kernel_matches_plain(card, dtype, reg_type, case):
    """K4 vs ``backward_stacked_boxed`` on vertical data (N=17, the B of
    BOXED_CASES), with a non-PD lane (Luu = -10), a NaN lane (a NaN Fx)
    and a lane whose last stage holds a QP of 5 iterations where B allows
    them, and in the exhausted case a NaN lower bound in lane 4's last
    stage: bit for bit (the boxed units are built without FMA
    contraction)."""
    B, qp = _boxed_case(case)
    N = 17
    p, cfg, t0, xs, us, VxT, VxxT = _vertical_trajectory(B, N, dtype, card)
    D = ddp._derivative_sweep_lanes(p, cfg, t0, xs, us)[0]
    D, bnd = StackedDerivs(*D[:7]), StackedBounds(*D[-3:])
    planted = (7, 299)
    if B > 299:
        D.Luu[:, :, :, 7] = -10.0
        D.Fx[3, 0, 0, 299] = float("nan")
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=card)
        D.Fu[N - 1, :, :, 11] = 0.0
        D.Luu[N - 1, :, :, 11] = as_t([[2.38, 5.0], [5.0, 10.65]])
        D.Lu[N - 1, :, 11] = as_t([-1.58, -2.98])
        bnd.lower[N - 1, :, 11] = as_t([-0.11, -0.99])
        bnd.upper[N - 1, :, 11] = as_t([1.22, 0.96])
        bnd.u[N - 1, :, 11] = 0.0
    if case == "exhausted":
        bnd.lower[N - 1, 0, 4] = float("nan")
    cfg = DDPConfig(horizon_steps=N, reg_type=reg_type,
                    with_input_constraint=True, boxqp=qp)
    lam = torch.full((B,), 1e-6 if reg_type == 1 else 0.5, dtype=dtype,
                     device=card)
    before = backward_fused_boxed.launches
    out = backward_fused_boxed(cfg, D, bnd, VxT, VxxT, lam)
    torch.cuda.synchronize()
    assert backward_fused_boxed.launches == before + 1
    stats = {}
    ref = backward_stacked_boxed(cfg, D, bnd, VxT, VxxT, lam, stats=stats)
    if B > 299:
        assert int(stats["qp_iters"][N - 1, 11]) > 4
    _hold_boxed(ref, out, stats, case, planted, B)


@pytest.mark.parametrize("case", BOXED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("reg_type", [1, 2])
def test_remat_boxed_kernel_matches_plain(card, dtype, reg_type, case):
    """K5 boxed vs its plain version (the sweep with bounds and
    ``backward_stacked_boxed``) on vertical data (N=17, the B of
    BOXED_CASES), with a non-PD lane (a negative definite terminal Vxx
    under interior forces) and a NaN lane (a NaN terminal Vxx) where B
    allows them, and in the exhausted case a NaN state in lane 4 (Quu stays
    finite): bit for bit."""
    B, qp = _boxed_case(case)
    N = 17
    p, cfg, t0, xs, us, VxT, VxxT = _vertical_trajectory(B, N, dtype, card)
    planted = (7, 299)
    if B > 299:
        us[:, :, 7] = 5.0
        VxxT[:, :, 7] = -1e6 * torch.eye(2, dtype=dtype, device=card)
        VxxT[1, 1, 299] = float("nan")
    if case == "exhausted":
        xs[N // 2, 0, 4] = float("nan")
    cfg = DDPConfig(horizon_steps=N, reg_type=reg_type,
                    with_input_constraint=True, boxqp=qp)
    lam = torch.full((B,), 1e-6 if reg_type == 1 else 0.5, dtype=dtype,
                     device=card)
    before = backward_remat.boxed_launches
    out = backward_remat(p, cfg, t0, xs, us, VxT, VxxT, lam, boxed=True)
    torch.cuda.synchronize()
    assert backward_remat.boxed_launches == before + 1
    stats = {}
    D = ddp._derivative_sweep_lanes(p, cfg, t0, xs, us)[0]
    ref = backward_stacked_boxed(cfg, StackedDerivs(*D[:7]),
                                 StackedBounds(*D[-3:]), VxT, VxxT, lam,
                                 stats=stats)
    _hold_boxed(ref, out, stats, case, planted, B)


@pytest.mark.parametrize("impls,counter", [
    (("pallas", "scan"), "K4"), (("auto", "auto"), "K5")])
def test_boxed_solve_batch_goes_through_kernels(card, impls, counter):
    """fp64 boxed vertical solve_batch (B=64, N=30, from t0=1.9) through
    K4 (``backward_impl="pallas"``) and through ``auto`` (K5 boxed and the
    fused rollouts) launches its kernels and agrees with the plain path on
    the card: same status and iters, us 1e-10, the first-stage u inside
    [0, 30]."""
    B, N = 64, 30
    rng = np.random.default_rng(1)
    x0s = torch.as_tensor(np.tile([1.2, 0.0], (B, 1))
                          + 0.05 * rng.normal(size=(B, 2)), device=card)
    us0 = torch.zeros((B, N, 2), dtype=torch.float64, device=card)
    cfg = DDPConfig(horizon_steps=N, max_iter=3, initial_lambda=1e-6,
                    with_input_constraint=True)
    p = make_vertical_problem(DT)
    count = {"K4": lambda: backward_fused_boxed.launches,
             "K5": lambda: backward_remat.boxed_launches}[counter]
    before = count()
    res = DDPSolver(p, dataclasses.replace(
        cfg, backward_impl=impls[0], forward_impl=impls[1])).solve_batch(
            1.9, x0s, us0)
    assert count() > before
    ref = DDPSolver(p, dataclasses.replace(
        cfg, backward_impl="stacked", forward_impl="scan")).solve_batch(
            1.9, x0s, us0)
    assert torch.equal(res.status, ref.status)
    assert torch.equal(res.iters, ref.iters)
    assert (res.us - ref.us).abs().max().item() <= 1e-10
    assert res.us[:, 0].min().item() >= 0.0
    assert res.us[:, 0].max().item() <= 30.0


def _fmpc_case(B, N, dtype, device, seed=4):
    """Cart-pole FMPC first-iteration data on ``device``: a random
    batch-minor iterate (s, nu in [0.2, 1.2)), its coefficients, masks and
    eps, with lane 7 NaN-poisoned (a NaN A) and lane 11 non-PD (Luu = -1e4
    on every stage)."""
    p = make_cartpole_fmpc_problem(DT)
    rng = np.random.default_rng(seed)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    var = FmpcVariable(
        xs=as_t(0.3 * rng.normal(size=(N + 1, 4, B))),
        us=as_t(0.3 * rng.normal(size=(N, 1, B))),
        lambdas=as_t(0.3 * rng.normal(size=(N + 1, 4, B))),
        ss=as_t(0.2 + rng.uniform(size=(N, 4, B))),
        nus=as_t(0.2 + rng.uniform(size=(N, 4, B))))
    t0 = torch.zeros((), dtype=dtype, device=device)
    co = fmpc._coeffs_bm(p, FmpcConfig(horizon_steps=N), t0, var)
    co.A[3, 0, 1, 7] = float("nan")
    co.Luu[:, :, :, 11] = -1e4
    gms = fmpc._ineq_masks(p, t0 + DT * torch.arange(
        N, dtype=dtype, device=device), dtype)
    eps = torch.full((B,), 1e-4, dtype=dtype, device=device)
    return p, co, var, gms, eps


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("break_if_llt_fails", [False, True])
def test_fmpc_backward_kernel_matches_plain(card, dtype, break_if_llt_fails):
    """K8 vs ``_backward_bm`` on a ragged batch (B=300, N=17): ok and finite
    masks equal (the NaN lane not finite; the non-PD lane takes the
    Gauss-Jordan fallback, or fails with ``break_if_llt_fails``), the
    outputs within TOL on the finite lanes."""
    B, N = 300, 17
    p, co, var, gms, eps = _fmpc_case(B, N, dtype, card)
    cfg = FmpcConfig(horizon_steps=N, break_if_llt_fails=break_if_llt_fails)
    before = backward_fmpc_fused.launches
    out = backward_fmpc_fused(p, cfg, co, var.ss, var.nus, gms, eps)
    torch.cuda.synchronize()
    assert backward_fmpc_fused.launches == before + 1
    ref = fmpc._backward_bm(p, cfg, co, var.ss, var.nus, gms, eps)
    assert torch.equal(out[4], ref[4]) and torch.equal(out[5], ref[5])
    assert not out[5][7] and int(out[5].sum()) == B - 1
    assert bool(out[4][11]) != break_if_llt_fails
    for a, b in zip(ref[:4], out[:4]):
        assert _norm_err(a[..., ref[5]], b[..., ref[5]]) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fmpc_forward_kernel_matches_plain(card, dtype):
    """K11 vs its plain recursion with gains from K8's plain version
    (B=300, N=17, the NaN lane left out): within TOL, one launch."""
    B, N = 300, 17
    p, co, var, gms, eps = _fmpc_case(B, N, dtype, card)
    ks, Ks, *_, finite = fmpc._backward_bm(
        p, FmpcConfig(horizon_steps=N), co, var.ss, var.nus, gms, eps)
    dx0 = (0.1 * torch.ones((4, B), dtype=dtype, device=card)).contiguous()
    args = (co.A, co.B, co.x_bar, ks, Ks, dx0)
    before = forward_fmpc_deltas_fused.launches
    out = forward_fmpc_deltas_fused(*args)
    torch.cuda.synchronize()
    assert forward_fmpc_deltas_fused.launches == before + 1
    for a, b in zip(forward_fmpc_deltas_plain(*args), out):
        assert _norm_err(a[..., finite], b[..., finite]) <= TOL[dtype]


def test_fmpc_auto_goes_through_kernels(card):
    """fp64 cart-pole ``solve_batch`` (B=64, N=30, 5 iterations,
    ``init_complementary_variable``) through ``auto`` launches K8 and K11
    and agrees with the plain path on the card: statuses and iterations
    equal, every variable within 1e-10."""
    B, N = 64, 30
    p = make_cartpole_fmpc_problem(DT)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(0.15 * rng.normal(size=(B, 4)), device=card)
    v1 = fmpc_variable_reset(N, 4, 1, 4, dtype=torch.float64, device=card)
    var = FmpcVariable(**{f: getattr(v1, f).expand(
        B, *getattr(v1, f).shape).contiguous()
        for f in ("xs", "us", "lambdas", "ss", "nus")})
    eps = torch.full((B,), 1e-4, dtype=torch.float64, device=card)
    cfg = FmpcConfig(horizon_steps=N, max_iter=5,
                     init_complementary_variable=True)
    counts = (backward_fmpc_fused.launches,
              forward_fmpc_deltas_fused.launches)
    res = FmpcSolver(p, cfg).solve_batch(0.0, x0s, var, eps)
    assert backward_fmpc_fused.launches > counts[0]
    assert forward_fmpc_deltas_fused.launches > counts[1]
    ref = FmpcSolver(p, dataclasses.replace(
        cfg, backward_impl="stacked", forward_impl="scan")).solve_batch(
            0.0, x0s, var, eps)
    assert torch.equal(res.status, ref.status)
    assert torch.equal(res.iters, ref.iters)
    for f in ("xs", "us", "lambdas", "ss", "nus"):
        assert _norm_err(getattr(ref.variable, f),
                         getattr(res.variable, f)) <= 1e-10


def _equal_on(ref, out, lanes):
    """Every output equal bit for bit on ``lanes`` (NaN where NaN)."""
    return all(torch.equal(a[..., lanes], b[..., lanes])
               for a, b in zip(ref, out))


def _wide_derivs(B, N, dtype, device, nx=8, nu=4):
    """Stage fields of a random linear-quadratic problem at (nx, nu), the
    kernels' largest: Fx near the identity, positive definite Lxx, Luu
    and Vxx_T (K1's ring and K2's slots hold the fewest stages there)."""
    rng = np.random.default_rng(9)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)

    def spd(n, scale):
        M = rng.normal(size=(N, B, n, n))
        return np.moveaxis(M @ np.swapaxes(M, -1, -2) / n
                           + scale * np.eye(n), 1, -1)

    D = StackedDerivs(*(as_t(a).contiguous() for a in (
        np.eye(nx)[None, :, :, None] + 0.05 * rng.normal(
            size=(N, nx, nx, B)),
        0.1 * rng.normal(size=(N, nx, nu, B)),
        0.1 * rng.normal(size=(N, nx, B)), 0.1 * rng.normal(size=(N, nu, B)),
        spd(nx, 0.1), spd(nu, 1.0), 0.01 * rng.normal(size=(N, nx, nu, B)))))
    return (D, as_t(0.1 * rng.normal(size=(nx, B))),
            as_t(spd(nx, 1.0)[0]).contiguous())


# inputs of the sweep-fed kernels' checks: B=300 (not a multiple of a
# warp's lanes, a lane stride TMA takes), B=1023 (one it does not: K1
# copies its seven fields, K3 its buffer, K2 nothing), B=4100 (blocks of
# four warps at (4, 1), the last with one warp that has lanes), Lxx at a
# 4-byte offset (K1 copies that field alone), the widest shape (8, 4)
SWEEP_CASES = {"B300": (300, 0, 0), "B1023": (1023, 7, 1),
               "B4100": (4100, 0, 0), "offset": (1024, 1, 0),
               "wide": (1023, 7, 1)}


@pytest.mark.parametrize("case", list(SWEEP_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [17, 100])
def test_chunked_and_packed_equal_k1(card, dtype, N, case):
    """K1 against the plain version (ok masks equal, the rest within TOL)
    and K2 and K3 against K1 (bit-equal on every lane K1 calls ok, ok masks
    equal), one launch each, with a non-PD and a NaN lane, at each
    SWEEP_CASES input, each copy to a padded lane stride counted; each of
    the three built at one thread per lane equal to its kRowGroup build
    bit for bit.  N=17 and 100 are multiples of no ring depth or chunk
    (K2 at (4, 1) fp32: C=8, a shorter last chunk)."""
    B, k1_copies, k3_copies = SWEEP_CASES[case]
    if case == "wide":
        D, VxT, VxxT = _wide_derivs(B, N, dtype, card)
    else:
        D, VxT, VxxT = _derivs(B, N, dtype, card)
    if case == "offset":
        flat = torch.empty(D.Lxx.numel() + 1, dtype=dtype, device=card)
        view = flat[1:].view(D.Lxx.shape)
        view.copy_(D.Lxx)
        D = D._replace(Lxx=view)
    nx, nu = D.Fx.shape[1], D.Fu.shape[2]
    D.Luu[:, :, :, 7] = -10.0 * torch.eye(nu, dtype=dtype, device=card)
    D.Fx[3, 2, 1, 299] = float("nan")
    cfg = DDPConfig(horizon_steps=N)
    lam = torch.full((B,), 1e-4, dtype=dtype, device=card)
    before = (backward_fused.launches, backward_fused.chunked_launches,
              backward_packed.launches, backward_fused.padded_copies,
              backward_packed.padded_copies)
    k1 = backward_fused(cfg, D, VxT, VxxT, lam)
    k2 = backward_fused(cfg, D, VxT, VxxT, lam, dma="chunked")
    k3 = backward_fused(cfg, D, VxT, VxxT, lam, dma="packed")
    fields, ld1 = fused.tma_fields(D)
    P, ld3 = fused.padded_packed(pack_derivs(D))
    one = {dma: fused.launch(fused.launcher(nx, nu, dtype, dma, 1), dma, cfg,
                             N, nx, nu, x, VxT, VxxT, lam, ld)
           for dma, x, ld in (("stage", fields, ld1), ("chunked", D, 0),
                              ("packed", (P,), ld3))}
    torch.cuda.synchronize()
    after = (backward_fused.launches, backward_fused.chunked_launches,
             backward_packed.launches, backward_fused.padded_copies,
             backward_packed.padded_copies)
    assert tuple(a - b for a, b in zip(after, before)) == (
        1, 1, 1, 2 * k1_copies, 2 * k3_copies)
    if dtype == torch.float32 and N == 100 and case != "wide":
        assert N % chunk_stages(4, 1, N, dtype) != 0
    ref = backward_stacked(cfg, D, VxT, VxxT, lam)
    assert torch.equal(k1[3], ref[3])
    assert not k1[3][7] and not k1[3][299] and int(k1[3].sum()) == B - 2
    for a, b in zip(ref[:3], k1[:3]):
        assert _norm_err(a[..., ref[3]], b[..., ref[3]]) <= TOL[dtype]
    for out in (k2, k3):
        assert torch.equal(out[3], k1[3])
        assert _equal_on(k1[:3], out[:3], k1[3])
    for dma, out in zip(fused.DMA_MODES, (k1, k2, k3)):
        for a, b in zip(one[dma], out):
            assert torch.equal(_bits(a), _bits(b)), dma


def _bits(a):
    """``a``'s bit pattern (the card makes one canonical NaN)."""
    if not a.is_floating_point():
        return a
    return a.contiguous().view({torch.float32: torch.int32,
                                torch.float64: torch.int64}[a.dtype])


# the group sizes of riccati_stage_group measured on the card, per nx
ROW_GROUPS = {4: (1, 2, 4, 8), 2: (1, 2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("reg_type", [1, 2])
def test_remat_groups_equal_one_thread(card, dtype, reg_type):
    """K5 built at every group size on a ragged batch (B=300, N=17, a
    short last round at G = 2, 4, 8) with a NaN state and a non-PD lane,
    and at G = 0 (one thread per lane, the fields in registers): every
    output equal to G = 1's bit for bit, NaN lanes included."""
    B, N = 300, 17
    p, t0, xs, us, VxT, VxxT = _trajectory(B, N, dtype, card)
    xs[5, 1, 299] = float("nan")
    VxxT[:, :, 7] = -1e6 * torch.eye(4, dtype=dtype, device=card)
    cfg = DDPConfig(horizon_steps=N, reg_type=reg_type)
    lam = torch.full((B,), 1e-4 if reg_type == 1 else 0.5, dtype=dtype,
                     device=card)
    outs = {g: remat.launch(remat.launcher(p, 4, 1, dtype, False, g), p, cfg,
                            t0, xs, us, VxT, VxxT, lam)
            for g in (0,) + ROW_GROUPS[4]}
    torch.cuda.synchronize()
    assert not outs[1][3][7] and not outs[1][3][299]
    for g, out in outs.items():
        for a, b in zip(outs[1], out):
            assert torch.equal(_bits(a), _bits(b)), g


def _pair_problem():
    """Two cart-poles (pole lengths 2 m and 1 m) on one force, each with the
    cart-pole's weights about the origin: nx = 8,
    nu = 1, F = 154 fields a stage, whose K5 slab at fp64 holds 16 lanes a
    block instead of 32."""
    a, b = CartPoleParam(), CartPoleParam(pole_length=1.0)
    w = CartPoleCostWeight()

    def dynamics(t, x, u):
        # each pole's state by element (the kernel generator takes select
        # and stack, not slices)
        xa = torch.stack([x[0], x[1], x[2], x[3]])
        xb = torch.stack([x[4], x[5], x[6], x[7]])
        return torch.cat([xa + DT * cartpole_xdot(a, xa, u),
                          xb + DT * cartpole_xdot(b, xb, u)])

    def running_cost(t, x, u):
        wx = torch.tensor(w.running_x * 2, dtype=x.dtype, device=x.device)
        return (0.5 * torch.sum(wx * x**2)
                + 0.5 * w.running_u[0] * torch.sum(u**2))

    def terminal_cost(t, x):
        wx = torch.tensor(w.terminal_x * 2, dtype=x.dtype, device=x.device)
        return 0.5 * torch.sum(wx * x**2)

    return Problem(dt=DT, state_dim=8, input_dim=1, dynamics=dynamics,
                   running_cost=running_cost, terminal_cost=terminal_cost)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_remat_wide_state_fits_shared_memory(card, dtype):
    """K5 at nx = 8 (:func:`_pair_problem`), B=4096, through the wrapper:
    the launch sizes its blocks to the field slab (fp64: 16 lanes of 8
    threads), ok masks equal to the plain version's and the rest within
    TOL, and every output equal bit for bit to G = 0's (one thread per
    lane, the fields in registers)."""
    B, N = 4096, 12
    p = _pair_problem()
    rng = np.random.default_rng(8)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=card)
    cfg = DDPConfig(horizon_steps=N)
    x0s = (np.tile([0.0, np.pi, 0.0, 0.0], (B, 2))
           + 0.05 * rng.normal(size=(B, 8)))
    us = as_t(0.2 * rng.normal(size=(N, 1, B)))
    t0 = as_t(0.3)
    xs, _ = ddp._rollout_lanes(p, cfg, t0, as_t(x0s.T.copy()), us)
    VxT, VxxT = (a.contiguous() for a in ddp._terminal_quad_lanes(
        p, cfg, t0, xs))
    lam = torch.full((B,), 1e-4, dtype=dtype, device=card)
    before = backward_remat.launches
    out = backward_remat(p, cfg, t0, xs, us, VxT, VxxT, lam)
    one = remat.launch(remat.launcher(p, 8, 1, dtype, False, 0), p, cfg, t0,
                       xs, us, VxT, VxxT, lam)
    torch.cuda.synchronize()
    assert backward_remat.launches == before + 1
    ref = backward_remat_plain(p, cfg, t0, xs, us, VxT, VxxT, lam)
    assert torch.equal(out[3], ref[3]) and int(out[3].sum()) == B
    for a, b in zip(ref[:3], out[:3]):
        assert _norm_err(a, b) <= TOL[dtype]
    for a, b in zip(one, out):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx", [4, 2])
def test_packed_groups_equal_k1(card, dtype, nx):
    """K1, K2 and K3 built at every group size (cart-pole fields, or the
    cart-pole's first two states' block as a (2, 1) case) on a ragged
    batch (B=300, N=23, rings and chunks cut short at the horizon's start)
    with a non-PD and a NaN lane: bit-equal to K1 (its default build) on
    K1's ok lanes with the same ok mask, and to the same kernel at G = 1
    everywhere."""
    B, N = 300, 23
    D, VxT, VxxT = _derivs(B, N, dtype, card)
    if nx == 2:
        D = StackedDerivs(D.Fx[:, :2, :2].contiguous(),
                          D.Fu[:, :2].contiguous(), D.Lx[:, :2].contiguous(),
                          D.Lu, D.Lxx[:, :2, :2].contiguous(), D.Luu,
                          D.Lxu[:, :2].contiguous())
        VxT, VxxT = VxT[:2].contiguous(), VxxT[:2, :2].contiguous()
    D.Luu[:, :, :, 7] = -10.0
    D.Fx[3, 1, 1, 299] = float("nan")
    cfg = DDPConfig(horizon_steps=N)
    lam = torch.full((B,), 1e-4, dtype=dtype, device=card)
    k1 = backward_fused(cfg, D, VxT, VxxT, lam)
    fields, ld = fused.tma_fields(D)
    data = {"stage": fields, "chunked": D, "packed": (pack_derivs(D),)}
    outs = {(dma, g): fused.launch(fused.launcher(nx, 1, dtype, dma, g), dma,
                                   cfg, N, nx, 1, data[dma], VxT, VxxT, lam,
                                   ld)
            for dma in fused.DMA_MODES for g in ROW_GROUPS[nx]}
    torch.cuda.synchronize()
    assert not k1[3][7] and not k1[3][299]
    for (dma, g), out in outs.items():
        assert torch.equal(out[3], k1[3]), (dma, g)
        assert _equal_on(k1[:3], out[:3], k1[3]), (dma, g)
        for a, b in zip(outs[dma, 1], out):
            assert torch.equal(_bits(a), _bits(b)), (dma, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_packed_ragged_lane_stride(card, dtype):
    """K3 at B=1023, whose lane stride TMA does not take: the wrapper
    copies P once into a padded buffer (counted) and the result equals
    K1's bit for bit on K1's ok lanes, with the same ok mask."""
    B, N = 1023, 30
    D, VxT, VxxT = _derivs(B, N, dtype, card)
    D.Luu[:, :, :, 1022] = -10.0
    cfg = DDPConfig(horizon_steps=N)
    lam = torch.full((B,), 1e-4, dtype=dtype, device=card)
    k1 = backward_fused(cfg, D, VxT, VxxT, lam)
    before = (backward_packed.padded_copies, backward_packed.launches)
    k3 = backward_fused(cfg, D, VxT, VxxT, lam, dma="packed")
    torch.cuda.synchronize()
    assert (backward_packed.padded_copies, backward_packed.launches) == (
        before[0] + 1, before[1] + 1)
    assert not k1[3][1022] and int(k1[3].sum()) == B - 1
    assert torch.equal(k3[3], k1[3])
    assert _equal_on(k1[:3], k3[:3], k1[3])


def _osc_case(B, N, dtype, device, seed=6):
    """Oscillator FMPC first-iteration data, lane 3 NaN, lane 9 non-PD."""
    p = make_oscillator_problem(DT)
    rng = np.random.default_rng(seed)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    var = FmpcVariable(
        xs=as_t(0.3 * rng.normal(size=(N + 1, 2, B))),
        us=as_t(0.3 * rng.normal(size=(N, 1, B))),
        lambdas=as_t(0.3 * rng.normal(size=(N + 1, 2, B))),
        ss=as_t(0.2 + rng.uniform(size=(N, 3, B))),
        nus=as_t(0.2 + rng.uniform(size=(N, 3, B))))
    t0 = torch.zeros((), dtype=dtype, device=device)
    co = fmpc._coeffs_bm(p, FmpcConfig(horizon_steps=N), t0, var)
    co.A[N // 2, 0, 1, 3] = float("nan")
    co.Luu[:, :, :, 9] = -1e4
    gms = fmpc._ineq_masks(p, t0 + DT * torch.arange(
        N, dtype=dtype, device=device), dtype)
    return p, co, var, gms, torch.full((B,), 1e-4, dtype=dtype,
                                       device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("break_if_llt_fails", [False, True])
@pytest.mark.parametrize("model", ["oscillator", "cart-pole"])
def test_resident_and_packed_equal_k8(card, dtype, break_if_llt_fails,
                                      model):
    """K9 and K10 vs K8 (ragged B=300, N=11 so that the cart-pole fits K9
    at fp64 too): ok and finite masks equal, every output bit-equal on the
    finite lanes, one launch each."""
    B, N = 300, 11
    p, co, var, gms, eps = (_osc_case if model == "oscillator"
                            else _fmpc_case)(B, N, dtype, card)
    cfg = FmpcConfig(horizon_steps=N, break_if_llt_fails=break_if_llt_fails)
    k8 = backward_fmpc_fused(p, cfg, co, var.ss, var.nus, gms, eps)
    before = (backward_fmpc_fused.resident_launches,
              backward_fmpc_packed.launches)
    k9 = backward_fmpc_fused(p, cfg, co, var.ss, var.nus, gms, eps,
                             variant="resident")
    k10 = backward_fmpc_fused(p, cfg, co, var.ss, var.nus, gms, eps,
                              variant="packed")
    torch.cuda.synchronize()
    assert (backward_fmpc_fused.resident_launches,
            backward_fmpc_packed.launches) == (before[0] + 1, before[1] + 1)
    for out in (k9, k10):
        assert torch.equal(out[4], k8[4]) and torch.equal(out[5], k8[5])
        assert _equal_on(k8[:4], out[:4], k8[5])


# the group sizes of fmpc_stage_group measured on the card, per model
FMPC_GROUPS = {"cart-pole": (1, 2, 4, 8), "oscillator": (1, 2, 4)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("break_if_llt_fails", [False, True])
@pytest.mark.parametrize("model", ["oscillator", "cart-pole"])
def test_fmpc_groups_equal_one_thread(card, dtype, break_if_llt_fails,
                                      model):
    """K8 and K10 built at every group size (and at G = 4 with every
    thread computing every row of P A, P B and P x_bar) on a ragged batch
    (B=300, N=17) with a non-PD and a NaN lane: every output equal to the
    same kernel's at G = 1 bit for bit, K8 at G = 1 equal to the wrapper's
    K8 bit for bit, and K10 equal to K8 on its finite lanes with the same
    masks."""
    B, N = 300, 17
    p, co, var, gms, eps = (_osc_case if model == "oscillator"
                            else _fmpc_case)(B, N, dtype, card)
    nx, nu, ng = p.state_dim, p.input_dim, p.ineq_dim
    cfg = FmpcConfig(horizon_steps=N, break_if_llt_fails=break_if_llt_fails)
    k8 = backward_fmpc_fused(p, cfg, co, var.ss, var.nus, gms, eps)
    nu_s, tilde = fmpc_backward.condensation(co, var.ss, var.nus, gms, eps)
    P, ld = fmpc_backward.padded_lanes(
        fmpc_backward.pack_fmpc_inputs(co, nu_s, tilde))
    groups = FMPC_GROUPS[model]
    variants = [(g, True) for g in groups] + [(4, False)]
    outs = {}
    for g, share in variants:
        fn = fmpc_backward.launcher(nx, nu, ng, dtype, "stream", g, share)
        outs["K8", g, share] = fmpc_backward.launch_stream(
            fn, p, cfg, co, var.ss, var.nus, gms, eps)
        fn = fmpc_backward.launcher(nx, nu, ng, dtype, "packed", g, share)
        out, ok, finite = fmpc_backward.launch_packed(
            fn, p, cfg, P, ld, -co.Lx_bar_term, co.Lxx_term, nx, nu, ng)
        o = fmpc_backward.unpack_fields(out, fmpc_backward._out_shapes(nx,
                                                                        nu))
        outs["K10", g, share] = (o["k"], o["K"], o["svec"], o["P"], ok,
                                 finite)
    torch.cuda.synchronize()
    for (kernel, g, share), out in outs.items():
        for a, b in zip(outs[kernel, 1, True], out):
            assert torch.equal(_bits(a), _bits(b)), (kernel, g, share)
    for a, b in zip(k8, outs["K8", 1, True]):
        assert torch.equal(_bits(a), _bits(b))
    k10 = outs["K10", 1, True]
    assert torch.equal(k10[4], k8[4]) and torch.equal(k10[5], k8[5])
    assert _equal_on(k8[:2] + tuple(a[:N] for a in k8[2:4]), k10[:4], k8[5])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fmpc_ragged_lane_stride(card, dtype):
    """K8 and K10 at B=1023, whose lane stride TMA does not take:
    K8's 13 fields and K10's buffer are copied once to a padded stride
    (counted), K8 holds to ``_backward_bm`` within TOL with the same
    masks and K10 equals K8 bit for bit on its finite lanes."""
    B, N = 1023, 30
    p, co, var, gms, eps = _fmpc_case(B, N, dtype, card)
    cfg = FmpcConfig(horizon_steps=N)
    before = (backward_fmpc_fused.padded_copies,
              backward_fmpc_packed.padded_copies)
    k8 = backward_fmpc_fused(p, cfg, co, var.ss, var.nus, gms, eps)
    k10 = backward_fmpc_fused(p, cfg, co, var.ss, var.nus, gms, eps,
                              variant="packed")
    torch.cuda.synchronize()
    assert (backward_fmpc_fused.padded_copies,
            backward_fmpc_packed.padded_copies) == (before[0] + 13,
                                                    before[1] + 1)
    ref = fmpc._backward_bm(p, cfg, co, var.ss, var.nus, gms, eps)
    assert torch.equal(k8[4], ref[4]) and torch.equal(k8[5], ref[5])
    for a, b in zip(ref[:4], k8[:4]):
        assert _norm_err(a[..., ref[5]], b[..., ref[5]]) <= TOL[dtype]
    assert torch.equal(k10[4], k8[4]) and torch.equal(k10[5], k8[5])
    assert _equal_on(k8[:4], k10[:4], k8[5])


def test_resident_raises_where_it_does_not_fit(card):
    """The cart-pole at N=33, fp32, is past K9's 32 stages: the wrapper
    asked for K9 raises (the solver's "resident" takes K8 there:
    ``test_fmpc_variant_reaches_its_kernel``)."""
    B, N = 64, 33
    p, co, var, gms, eps = _fmpc_case(B, N, torch.float32, card)
    cfg = FmpcConfig(horizon_steps=N)
    with pytest.raises(ValueError, match="resident"):
        backward_fmpc_fused(p, cfg, co, var.ss, var.nus, gms, eps,
                            variant="resident")


@pytest.mark.parametrize("model", ["bipedal", "cart-pole deriv64"])
@pytest.mark.parametrize("dma,counter", [
    ("stage", lambda: backward_fused.launches),
    ("chunked", lambda: backward_fused.chunked_launches),
    ("packed", lambda: backward_packed.launches)])
def test_bipedal_solve_reaches_each_dma_kernel(card, dma, counter, model):
    """``solve_batch`` (B=64, N=60, 10 iterations) through ``auto`` with
    each ``backward_dma`` launches that kernel and agrees with the plain
    path: statuses and iterations equal, u within 1e-8.  The bipedal model
    at fp64 (K1, K2 or K3 at (2, 1): the generator rejects the model); the
    cart-pole at fp32 with ``deriv_dtype="float64"`` (the kernels at (4,
    1) fp64, the generator's path being refused: its derivatives are at
    the solve dtype)."""
    B, N = 64, 60
    rng = np.random.default_rng(2)
    if model == "bipedal":
        p = make_bipedal_problem(DT, example_ref_zmp_func(20.0),
                                 example_omega2_func())
        t0, dtype = 1.2, torch.float64
        x0s = torch.as_tensor(0.05 * rng.normal(size=(B, 2)), device=card)
        cfg = DDPConfig(horizon_steps=N, max_iter=10)
    else:
        p, t0, dtype = make_cartpole_problem(DT), 0.0, torch.float32
        x0s = torch.as_tensor(np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                              + 0.05 * rng.normal(size=(B, 4)), dtype=dtype,
                              device=card)
        cfg = DDPConfig(horizon_steps=N, max_iter=10, deriv_dtype="float64")
    us0 = torch.zeros((B, N, 1), dtype=dtype, device=card)
    before = counter()
    res = DDPSolver(p, cfg, backward_dma=dma).solve_batch(t0, x0s, us0)
    assert counter() > before
    ref = DDPSolver(p, dataclasses.replace(
        cfg, backward_impl="stacked", forward_impl="scan")).solve_batch(
            t0, x0s, us0)
    assert torch.equal(res.status, ref.status)
    assert torch.equal(res.iters, ref.iters)
    assert (res.us - ref.us).abs().max().item() <= 1e-8


@pytest.mark.parametrize("variant,N,counter", [
    ("stream", 20, lambda: backward_fmpc_fused.launches),
    ("resident", 20, lambda: backward_fmpc_fused.resident_launches),
    ("resident", 40, lambda: backward_fmpc_fused.launches),
    ("packed", 20, lambda: backward_fmpc_packed.launches)])
def test_fmpc_variant_reaches_its_kernel(card, variant, N, counter):
    """An oscillator ``solve_batch`` (B=128, fp32, 3 iterations) with each
    ``backward_variant`` launches its kernel once per iteration
    ("resident" at N=40 does not fit K9 and takes K8) and equals the
    default solve bit for bit."""
    B = 128
    p = make_oscillator_problem(DT)
    rng = np.random.default_rng(1)
    x0s = torch.as_tensor(np.tile([0.0, 1.0], (B, 1))
                          + 0.05 * rng.normal(size=(B, 2)),
                          dtype=torch.float32, device=card)
    v1 = fmpc_variable_reset(N, 2, 1, 3, dtype=torch.float32, device=card)
    var = FmpcVariable(**{f: getattr(v1, f).expand(
        B, *getattr(v1, f).shape).contiguous()
        for f in ("xs", "us", "lambdas", "ss", "nus")})
    eps = torch.full((B,), 1e-4, dtype=torch.float32, device=card)
    cfg = FmpcConfig(horizon_steps=N, max_iter=3, kkt_error_thre=0.0)
    ref = FmpcSolver(p, cfg).solve_batch(0.0, x0s, var, eps)
    before = counter()
    res = FmpcSolver(p, cfg, backward_variant=variant).solve_batch(
        0.0, x0s, var, eps)
    assert counter() == before + 3
    assert torch.equal(res.status, ref.status)
    for f in ("xs", "us", "lambdas", "ss", "nus"):
        assert torch.equal(getattr(ref.variable, f),
                           getattr(res.variable, f))


# the chunks of stages of the forward recursions' ring (csrc/fwd_ring.cuh;
# K6 at 0: its one-stage register prefetch) and K11's group sizes, as
# measured on the card
FWD_CHUNKS = (1, 2, 4, 8)
FWD_GROUPS = (1, 2, 4)


def _fmpc_forward_args(B, N, dtype, device):
    """(A, Bm, x_bar, ks, Ks, dx0) of ``_fmpc_case`` (lane 7 NaN) with the
    plain backward's gains, and the plain result's finite lanes."""
    p, co, var, gms, eps = _fmpc_case(B, N, dtype, device)
    ks, Ks, *_ = fmpc._backward_bm(p, FmpcConfig(horizon_steps=N), co,
                                   var.ss, var.nus, gms, eps)
    dx0 = torch.as_tensor(np.random.default_rng(5).normal(size=(4, B)),
                          dtype=dtype, device=device)
    args = (co.A, co.B, co.x_bar, ks, Ks, dx0)
    plain = forward_fmpc_deltas_plain(*args)
    finite = fmpc._finite(plain[0]) & fmpc._finite(plain[1])
    return args, plain, finite


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_forward_rings_equal_one_stage(card, dtype):
    """K6 and K7 built at every chunk C of their TMA ring, and K11 at every
    (C, G), on a ragged batch (B=300, N=17: a last chunk shorter than C)
    with a NaN lane (K6, K7: a NaN state; K11: a NaN A): every output
    equal bit for bit to the one-stage build (K6, K7: the register
    prefetch, C = 0; K11: C = 1, G = 1), NaN lanes included; K11's equal to
    the plain version on its finite lanes."""
    B, N = 300, 17
    p, t0, xs, us, VxT, VxxT = _trajectory(B, N, dtype, card)
    cfg = DDPConfig(horizon_steps=N)
    lam = torch.full((B,), 1e-4, dtype=dtype, device=card)
    ks, Ks, _, ok = backward_remat_plain(p, cfg, t0, xs, us, VxT, VxxT, lam)
    assert bool(ok.all())
    xs[5, 1, 299] = float("nan")
    alpha = torch.as_tensor(np.random.default_rng(3).uniform(0.1, 1.0, B),
                            dtype=dtype, device=card)
    refs = fused.padded_fields((xs, us, ks, Ks))[0]
    alphas = torch.tensor(cfg.alpha_list, dtype=dtype, device=card)
    units = {c: fwd.launchers(p, 4, 1, dtype, c, c)
             for c in (0,) + FWD_CHUNKS}
    outs = {c: fwd.launch_selected(units[c], p, t0,
                                   *(refs if c else (xs, us, ks, Ks)), alpha)
            for c in units}
    sums = {c: fwd.launch_costs(units[c], p, t0,
                                *(refs if c else (xs, us, ks, Ks)), alphas, B)
            for c in units}
    torch.cuda.synchronize()
    ref = outs[0]
    assert bool(torch.isnan(ref[3][299])) and bool(
        torch.isfinite(ref[3][:299]).all())
    for key, out in outs.items():
        for a, b in zip(ref, out):
            assert torch.equal(_bits(a), _bits(b)), key
        assert torch.equal(_bits(sums[0]), _bits(sums[key])), key
    args, plain, finite = _fmpc_forward_args(B, N, dtype, card)
    fields = fused.padded_fields(args[:5])[0]
    outs = {(g, c): fmpc_forward.launch(
        fmpc_forward.launcher(4, 1, dtype, g, c), *fields, args[5])
        for g in FWD_GROUPS for c in FWD_CHUNKS}
    torch.cuda.synchronize()
    ref = outs[1, 1]
    assert not finite[7] and int(finite.sum()) == B - 1
    assert _equal_on(plain, ref, finite)
    for key, out in outs.items():
        for a, b in zip(ref, out):
            assert torch.equal(_bits(a), _bits(b)), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fmpc_forward_ragged_lane_stride(card, dtype):
    """K11 through its wrapper at B=1023, whose lane stride TMA does not
    take, and at B=1024 with A a view at a one-value offset: the wrapper
    copies each such field once (all five at B=1023, A alone for the
    view), launches once, and its
    result equals bit for bit the one-stage build's (G = 1, C = 1) on the
    same copies and the plain version's on the finite lanes."""
    for B in (1023, 1024):
        args, plain, finite = _fmpc_forward_args(B, 30, dtype, card)
        if B == 1024:
            A = torch.empty(args[0].numel() + 1, dtype=dtype, device=card)
            A = A[1:].view(args[0].shape)
            A.copy_(args[0])
            assert A.data_ptr() % 16 != 0
            args = (A,) + args[1:]
        copies = 1 if B == 1024 else 5
        fields = fused.padded_fields(args[:5])[0]
        ref = fmpc_forward.launch(fmpc_forward.launcher(4, 1, dtype, 1, 1),
                                  *fields, args[5])
        before = (forward_fmpc_deltas_fused.launches,
                  forward_fmpc_deltas_fused.padded_copies)
        out = forward_fmpc_deltas_fused(*args)
        torch.cuda.synchronize()
        assert (forward_fmpc_deltas_fused.launches,
                forward_fmpc_deltas_fused.padded_copies) == (
                    before[0] + 1, before[1] + copies), B
        assert _equal_on(plain, out, finite)
        for a, b in zip(ref, out):
            assert torch.equal(_bits(a), _bits(b)), B
