"""The port's C/GMRES solver (``solvers/cgmres.py``) and its problem layer
against the JAX package's and the NumPy golden, fp64 on the CPU, on the
same seeded numpy inputs: the integrators; ``ContinuousProblem``'s
derivatives on the damper (autodiff against analytic, and against JAX's);
the batch-minor horizon sweep (including t = 0, a zero-length horizon);
``setup``; fleet control steps, finite differences and exact JVPs, and the
single ``control_step`` against JAX's single-controller path; the first
30 closed-loop steps against ``tests/golden/cgmres_numpy.py``; ``run``'s
dumps and progress lines; the device rule; and a JAX ``CgmresState``
carried across.  The simulations are in ``test_torch_cgmres_sim.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden.cgmres_numpy import DamperGolden, GoldenCgmres
from nmpc_tpu.core import integrators as jax_integrators
from nmpc_tpu.models.damper import make_damper_problem as jax_damper
from nmpc_tpu.solvers import cgmres as jax_cgmres
from nmpc_tpu_torch import CgmresConfig, CgmresSolver, CgmresState
from nmpc_tpu_torch.convert import (cgmres_config_from_reference,
                                    cgmres_state_from_numpy,
                                    cgmres_state_to_numpy,
                                    damper_problem_from_reference)
from nmpc_tpu_torch.core.integrators import INTEGRATORS
from nmpc_tpu_torch.models.damper import make_damper_problem
from nmpc_tpu_torch.solvers.cgmres import _calc_dhdu_list_bm
from nmpc_tpu_torch.utils.trace import load_cgmres_data

torch.set_num_threads(1)

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _fleet(B, seed=2):
    """(x, next_x) of B damper controllers about x_initial, from a seed."""
    rng = np.random.default_rng(seed)
    xs = np.tile([2.0, 0.0], (B, 1)) + 0.1 * rng.normal(size=(B, 2))
    return xs, xs + 0.001 * rng.normal(size=(B, 2))


def _batched(state, B):
    return CgmresState(*(a[None].expand(B, *a.shape).contiguous()
                         for a in state))


def _jax_batched(state, B):
    return jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), state)


def _max_diff(ref, got):
    return float(np.abs(np.asarray(ref) - got.cpu().numpy()).max())


@pytest.mark.parametrize("name", ["euler", "rk4"])
def test_integrators_match_jax(name):
    """euler / rk4 on a nonlinear field, one controller and a batch on the
    trailing axis, against JAX's to 1e-15."""
    rng = np.random.default_rng(0)
    x, u = rng.normal(size=(3, 4)), rng.normal(size=(2, 4))
    f_j = lambda t, x, u: jnp.stack([jnp.sin(x[1]) * u[0], x[2] * t,
                                     u[1] - x[0] ** 2])
    f_t = lambda t, x, u: torch.stack([torch.sin(x[1]) * u[0], x[2] * t,
                                       u[1] - x[0] ** 2])
    ref = jax_integrators.INTEGRATORS[name](f_j, 0.3, jnp.asarray(x),
                                            jnp.asarray(u), 0.01)
    got = INTEGRATORS[name](f_t, 0.3, _t(x), _t(u), 0.01)
    assert _max_diff(ref, got) <= 1e-15


def test_damper_derivatives_autodiff_analytic_and_jax():
    """The Hamiltonian's autodiff costate, dH/du and dphi/dx equal the
    reference's hand-derived ones to 1e-12, and JAX's of the same problem
    (both derivations) at random points."""
    rng = np.random.default_rng(2)
    ports = {a: make_damper_problem(analytic=a) for a in (False, True)}
    refs = {a: jax_damper(analytic=a) for a in (False, True)}
    for _ in range(10):
        t = float(rng.uniform(0, 1))
        x, lmd = rng.normal(size=2), rng.normal(size=2)
        uc = rng.uniform(0.1, 0.9, size=3)
        got = {a: (p.costate_eq_at(_t(t), _t(lmd), _t(x), _t(uc)),
                   p.dh_du_at(_t(t), _t(x), _t(uc), _t(lmd)),
                   p.dphi_dx_at(_t(t), _t(x))) for a, p in ports.items()}
        for a, p in refs.items():
            ref = (p.costate_eq_at(t, jnp.asarray(lmd), jnp.asarray(x),
                                   jnp.asarray(uc)),
                   p.dh_du_at(t, jnp.asarray(x), jnp.asarray(uc),
                              jnp.asarray(lmd)),
                   p.dphi_dx_at(t, jnp.asarray(x)))
            for r, g_auto, g in zip(ref, got[False], got[a]):
                assert _max_diff(r, g) <= 1e-12
                assert _max_diff(r, g_auto) <= 1e-12


@pytest.mark.parametrize("analytic", [False, True])
@pytest.mark.parametrize("t", [0.0, 0.37])
def test_dhdu_sweep_matches_jax(analytic, t):
    """The batch-minor horizon sweep per lane against JAX's to 1e-12, at
    t = 0 (zero-length horizon: every value finite) and within the
    growing horizon."""
    B, N = 4, CgmresConfig().horizon_divide_num
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, B))
    ul = 0.5 + 0.2 * rng.normal(size=(N, 3, B))
    ref = jax_cgmres._calc_dhdu_list_bm(
        jax_damper(analytic), jax_cgmres.CgmresConfig(),
        jnp.asarray(t, jnp.float64), jnp.asarray(x), jnp.asarray(ul))
    got = _calc_dhdu_list_bm(make_damper_problem(analytic), CgmresConfig(),
                             torch.tensor(t, dtype=F64), _t(x), _t(ul))
    assert torch.isfinite(got).all()
    assert _max_diff(ref, got) <= 1e-12


@pytest.mark.parametrize("analytic", [False, True])
def test_setup_matches_jax(analytic):
    """Newton + GMRES on dH/du = 0 from the problem's initial values,
    against JAX's setup (1e-10), on the CPU as asked, with its host reads
    counted."""
    ref = jax_cgmres.CgmresSolver(jax_damper(analytic)).setup()
    solver = CgmresSolver(make_damper_problem(analytic), device="cpu")
    got = solver.setup()
    for name in CgmresState._fields:
        assert _max_diff(getattr(ref, name), getattr(got, name)) <= 1e-10
    assert got.u.device.type == "cpu" and got.u.dtype == F64
    assert got.u_list.shape == (25, 3) and got.delta_u_vec.shape == (75,)
    assert solver.host_syncs > 0


@pytest.mark.parametrize("use_jvp", [False, True], ids=["fd", "jvp"])
def test_control_step_batch_matches_jax(use_jvp):
    """Five chained fleet steps (B = 5), finite differences and exact
    JVPs, against JAX's ``control_step_batch``: u_list within 1e-9, the
    other fields within 1e-9 relative to their size (the warm start
    delta_u_vec carries the FD quotients' 1/dlt = 500 amplification of
    rounding)."""
    B = 5
    ref_solver = jax_cgmres.CgmresSolver(
        jax_damper(), jax_cgmres.CgmresConfig(use_jvp=use_jvp))
    solver = CgmresSolver(make_damper_problem(),
                          CgmresConfig(use_jvp=use_jvp), device="cpu")
    st_j = _jax_batched(ref_solver.setup(), B)
    st_t = _batched(solver.setup(), B)
    xs, next_xs = _fleet(B)
    t = 0.1
    for _ in range(5):
        st_j = ref_solver.control_step_batch(t, jnp.asarray(xs),
                                             jnp.asarray(next_xs), st_j)
        st_t = solver.control_step_batch(t, _t(xs), _t(next_xs), st_t)
        t += 0.001
    assert solver.host_syncs == 0
    assert _max_diff(st_j.u_list, st_t.u_list) <= 1e-9
    for name in CgmresState._fields:
        ref = np.asarray(getattr(st_j, name))
        assert _max_diff(ref, getattr(st_t, name)) <= 1e-9 * max(
            1.0, np.abs(ref).max()), name


def test_control_step_matches_jax_single():
    """The single ``control_step`` (the fleet path at B = 1) against JAX's
    single-controller ``_control_step`` (a scalar GMRES with its early
    exit), five chained steps: u_list within 1e-9."""
    ref_solver = jax_cgmres.CgmresSolver(jax_damper())
    solver = CgmresSolver(make_damper_problem(), device="cpu")
    st_j, st_t = ref_solver.setup(), solver.setup()
    xs, next_xs = _fleet(1, seed=5)
    t = 0.2
    for _ in range(5):
        st_j = ref_solver.control_step(t, jnp.asarray(xs[0]),
                                       jnp.asarray(next_xs[0]), st_j)
        st_t = solver.control_step(t, _t(xs[0]), _t(next_xs[0]), st_t)
        t += 0.001
    assert st_t.u_list.shape == (25, 3) and st_t.err.shape == ()
    assert _max_diff(st_j.u_list, st_t.u_list) <= 1e-9
    assert _max_diff(st_j.u, st_t.u) <= 1e-9


def test_damper_control_steps_match_golden():
    """The first 30 closed-loop control steps of the analytic damper (RK4
    plant) against the independent NumPy C/GMRES (a least-squares GMRES):
    setup within 1e-8, u within 1e-7 at every step."""
    config = CgmresConfig(sim_ode_solver="rk4")
    solver = CgmresSolver(make_damper_problem(analytic=True), config,
                          device="cpu")
    gp = DamperGolden()
    golden = GoldenCgmres(gp)
    state = solver.setup()
    u_g = golden.setup(0.0, gp.x_initial.copy(), gp.u_initial.copy())
    np.testing.assert_allclose(state.u.numpy(), u_g, atol=1e-8)

    def rk4(t, x, u, h):
        f = lambda tt, xx: gp.state_eq(tt, xx, u[:2])
        k1 = f(t, x)
        k2 = f(t + h / 2, x + h / 2 * k1)
        k3 = f(t + h / 2, x + h / 2 * k2)
        k4 = f(t + h, x + h * k3)
        return x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

    xg, t = gp.x_initial.copy(), 0.0
    for step in range(30):
        next_xg = rk4(t, xg, state.u.numpy(), config.dt)
        state = solver.control_step(t, _t(xg), _t(next_xg), state)
        ug, _ = golden.control_step(t, xg, next_xg)
        np.testing.assert_allclose(state.u.numpy(), ug, atol=1e-7,
                                   err_msg=f"step {step}")
        xg, t = next_xg, t + config.dt


def test_run_dumps_and_print_gate(tmp_path, capsys):
    """``run(dump_prefix=)`` writes the reference's four files, which the
    port's ``load_cgmres_data`` reads back as the run's history (every
    dump_step-th row); progress lines only at ``print_level >= 3``; the
    callback sees every step; the history equals ``simulate``'s."""
    config = CgmresConfig(sim_duration=0.006, dump_step=2, print_level=3)
    solver = CgmresSolver(make_damper_problem(analytic=True), config,
                          device="cpu")
    seen = []
    prefix = str(tmp_path / "cgmres")
    ts, xs, us, errs = solver.run(callback=lambda t, x, s: seen.append(t),
                                  dump_prefix=prefix)
    assert len(ts) == len(seen) == 7 and xs.shape == (7, 2)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all(ln.startswith("[CGMRES] t ")
                                   for ln in lines)
    ts_d, xs_d, us_d, errs_d = load_cgmres_data(prefix)
    np.testing.assert_array_equal(ts_d, ts[::2])
    np.testing.assert_array_equal(xs_d, xs[::2])
    np.testing.assert_array_equal(us_d, us[::2])
    np.testing.assert_array_equal(errs_d, errs[::2])
    assert (tmp_path / "cgmres_param.dat").read_text().strip().startswith("{")
    sim = solver.simulate(n_steps=7)
    np.testing.assert_allclose(sim[2].numpy(), us, atol=1e-12)
    np.testing.assert_allclose(sim[1].numpy(), xs, atol=1e-12)
    quiet = CgmresSolver(make_damper_problem(analytic=True),
                         dataclasses.replace(config, print_level=2),
                         device="cpu")
    quiet.run()
    assert capsys.readouterr().out == ""


def test_device_rule():
    """Without a card the solver refuses the default device (it never
    carries on on the CPU); with ``device="cpu"`` the initial state is a
    float64 CPU tensor; given tensors, it runs on their device and
    dtype."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CgmresSolver(make_damper_problem())
    solver = CgmresSolver(make_damper_problem(), device="cpu")
    assert solver.device == torch.device("cpu")
    st = solver.setup(x0=torch.tensor([2.0, 0.0], dtype=torch.float32))
    assert st.u.dtype == torch.float32 and st.u_list.dtype == torch.float32


def test_config_and_state_carry_across():
    """``CgmresConfig`` field for field with JAX's (names, order,
    defaults); a JAX fleet state carried across (``delta_u_vec`` in its
    row-major (N, dim_uc) layout) steps as JAX's does, and comes back as
    numpy with JAX's field names."""
    ref = jax_cgmres.CgmresConfig(k_max=4, use_jvp=True)
    got = cgmres_config_from_reference(ref)
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(ref)])
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(CgmresConfig()) == dataclasses.asdict(
        jax_cgmres.CgmresConfig())
    B = 3
    ref_solver = jax_cgmres.CgmresSolver(jax_damper())
    xs, next_xs = _fleet(B, seed=9)
    st_j = ref_solver.control_step_batch(
        0.1, jnp.asarray(xs), jnp.asarray(next_xs),
        _jax_batched(ref_solver.setup(), B))
    st_t = cgmres_state_from_numpy(
        "cpu", F64, **{k: np.asarray(v) for k, v in st_j._asdict().items()})
    assert st_t.delta_u_vec.shape == (B, 75)
    solver = CgmresSolver(damper_problem_from_reference(), device="cpu")
    st_j = ref_solver.control_step_batch(0.101, jnp.asarray(xs),
                                         jnp.asarray(next_xs), st_j)
    st_t = solver.control_step_batch(0.101, _t(xs), _t(next_xs), st_t)
    back = cgmres_state_to_numpy(st_t)
    assert set(back) == set(jax_cgmres.CgmresState._fields)
    np.testing.assert_allclose(back["u_list"], np.asarray(st_j.u_list),
                               atol=1e-9)
