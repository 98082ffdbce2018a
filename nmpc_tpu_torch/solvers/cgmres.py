"""C/GMRES real-time NMPC solver (Ohtsuka's continuation method), in torch.

Port of ``nmpc_tpu/solvers/cgmres.py`` (reference
``nmpc_cgmres/src/CgmresSolver.cpp``; Ohtsuka, Automatica 2004):

  * setup: the initial input from Newton iterations with GMRES on
    dH/du = 0 (``CgmresSolver.cpp:8-64``);
  * a horizon that grows to its steady length, T(t) = T_s (1 - e^{-alpha
    t}) (``CgmresSolver.cpp:151``);
  * per control step: the forward state rollout over the horizon, the
    backward costate integration and dH/du per division
    (``CgmresSolver.cpp:146-183``); the continuation system b = ((1 -
    zeta dlt) DhDu - DhDu(t + dlt)) / dlt solved matrix-free by GMRES with
    finite-difference directional products (or exact JVPs,
    ``use_jvp``), warm-started from the previous step's solution
    (``CgmresSolver.cpp:111-143, 186-202``); u̇ integrated into the input
    trajectory (``CgmresSolver.cpp:137-140``).

Every entry point runs the batch-minor fleet path of the JAX package
(``gmres_bm``, ``_calc_dhdu_list_bm``, ``_control_step_bm_core``): the
controllers on the trailing axis, the problem's per-controller callables
batched with ``torch.func.vmap`` (``solvers/stages.py::_lanes``).  The
single-controller entry points (:meth:`CgmresSolver.control_step`,
:meth:`CgmresSolver.simulate`, :meth:`CgmresSolver.run`) are that path at
B = 1, as ``FmpcSolver.solve`` is ``solve_batch`` at B = 1; they agree
with the JAX package's single path (``_control_step``, a scalar GMRES)
to rounding.

GMRES's early exit (the JAX ``while_loop`` stops once no lane has rho >
eps ||b||) becomes ``k_max`` fixed trips: a trip in which a lane has
converged leaves its basis, Hessenberg, rotations, residual and freeze
iteration as they were, so the results equal the early exit's and a
control step reads no device value on the host.  Only :meth:`setup`'s
Newton loop and its GMRES read device values (``host_syncs``).  There is
no Pallas kernel on this path in the JAX package (``while_loop`` and
``scan`` only), so it is plain torch ops here too.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import func

from nmpc_tpu_torch.core.integrators import INTEGRATORS
from nmpc_tpu_torch.core.problem import ContinuousProblem
from nmpc_tpu_torch.solvers.gmres import gmres
from nmpc_tpu_torch.solvers.stages import _lanes


@dataclasses.dataclass(frozen=True)
class CgmresConfig:
    """Parameters of the C/GMRES method, defaults matching the reference
    (``CgmresSolver.h:66-79``) and the JAX package field for field."""

    sim_duration: float = 10.0
    steady_horizon_duration: float = 1.0
    horizon_divide_num: int = 25
    horizon_increase_ratio: float = 0.5
    dt: float = 0.001
    eq_zeta: float = 1000.0
    k_max: int = 5
    finite_diff_delta: float = 0.002
    ode_solver: str = "euler"        # horizon integration (reference: Euler)
    sim_ode_solver: str = "rk4"      # plant simulation (tests use RK4)
    use_jvp: bool = False            # exact JVPs instead of finite differences
    setup_newton_iters: int = 100    # CgmresSolver.cpp:31
    setup_tol: float = 1e-6
    # run()'s progress lines (print_level >= 3, every dump_step-th step)
    # and its dumps (dump_prefix; CgmresSolver.cpp:66-103)
    print_level: int = 0
    dump_step: int = 1


class CgmresState(NamedTuple):
    """The carry across control steps (the reference's mutable members);
    a batch of controllers carries a leading batch axis on every field."""

    u_list: torch.Tensor       # [N, dim_uc] input trajectory over horizon
    delta_u_vec: torch.Tensor  # [N * dim_uc] GMRES warm start, row-major
    u: torch.Tensor            # [dim_uc] current input
    err: torch.Tensor          # ||dH/du|| optimality error


def _solver_device(device) -> torch.device:
    """``device`` (default ``"cuda"``) as a torch device; raises for a
    CUDA device without a card rather than carrying on on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CgmresSolver places its initial state on the CUDA card by "
            "default and no card is available; pass device='cpu' to run "
            "on the CPU")
    return device


class CgmresSolver:
    """Problem + config bound into the C/GMRES entry points.

    The solver runs on the device of the tensors it is given; where it is
    given none (:meth:`setup`, :meth:`simulate` and :meth:`run` without
    ``x0``), the problem's ``x_initial`` / ``u_initial`` go to ``device``
    as float64.  ``host_syncs`` counts the device values the last call
    read on the host; ``gmres_iters`` holds each controller's GMRES
    iterations ([B] int32) of the last :meth:`control_step_batch`."""

    def __init__(self, problem: ContinuousProblem,
                 config: CgmresConfig = CgmresConfig(), device=None):
        self.problem = problem
        self.config = config
        self.device = _solver_device(device)
        self.host_syncs = 0
        self.gmres_iters = None

    def _host(self, flag) -> bool:
        self.host_syncs += 1
        return bool(flag)

    def _initial(self, value, like=None):
        if isinstance(value, torch.Tensor):
            return value
        if like is not None:
            return torch.as_tensor(value, dtype=like.dtype,
                                   device=like.device)
        return torch.as_tensor(value, dtype=torch.float64,
                               device=self.device)

    def setup(self, t0=0.0, x0=None, u0=None) -> CgmresState:
        """The initial input by Newton + GMRES on dH/du = 0
        (``CgmresSolver::setup``, ``CgmresSolver.cpp:8-64``)."""
        self.host_syncs = 0
        x0 = self._initial(self.problem.x_initial if x0 is None else x0)
        u0 = self._initial(self.problem.u_initial if u0 is None else u0, x0)
        return _setup(self.problem, self.config,
                      torch.as_tensor(t0, dtype=x0.dtype, device=x0.device),
                      x0, u0, self._host)

    def control_step_batch(self, t, xs, next_xs, states: CgmresState
                           ) -> CgmresState:
        """Continuation updates of a fleet of controllers (xs [B, dim_x]
        and the states' fields with a leading batch axis): the
        batch-minor path, one transpose at each boundary."""
        self.host_syncs = 0
        bm = lambda a: torch.movedim(a, 0, -1).contiguous()
        t = torch.as_tensor(t, dtype=xs.dtype, device=xs.device)
        u_list, du, err, self.gmres_iters = _control_step_bm_core(
            self.problem, self.config, t, bm(xs), bm(next_xs),
            bm(states.u_list), bm(states.delta_u_vec))
        bf = lambda a: torch.movedim(a, -1, 0).contiguous()
        return CgmresState(u_list=bf(u_list), delta_u_vec=bf(du),
                           u=bf(u_list[0]), err=err)

    def control_step(self, t, x, next_x, state: CgmresState) -> CgmresState:
        """One ``calcControlInput`` (``CgmresSolver.cpp:111-143``): the
        fleet path at B = 1."""
        out = self.control_step_batch(
            t, x[None], next_x[None],
            CgmresState(*(a[None] for a in state)))
        return CgmresState(*(a[0] for a in out))

    def simulate_batch(self, t0, x0s, states: CgmresState, n_steps: int):
        """Closed-loop simulations of a fleet (``CgmresSolver::run`` at
        fleet scale): the batch-minor state held across steps, the plant
        integrated with ``sim_ode_solver``.  Returns batch-first (ts [B,
        n], xs [B, n, dim_x], us [B, n, dim_uc], errs [B, n])."""
        self.host_syncs = 0
        return _simulate_bm(self.problem, self.config,
                            torch.as_tensor(t0, dtype=x0s.dtype,
                                            device=x0s.device),
                            x0s, states, n_steps)

    def simulate(self, t0=0.0, x0=None, n_steps: Optional[int] = None):
        """One closed-loop simulation from :meth:`setup` (``CgmresSolver::
        run``, ``CgmresSolver.cpp:66-109``): :meth:`simulate_batch` at B
        = 1.  Returns (ts [n], xs [n, dim_x], us [n, dim_uc], errs [n])."""
        x0 = self._initial(self.problem.x_initial if x0 is None else x0)
        if n_steps is None:
            n_steps = int(round(self.config.sim_duration / self.config.dt)) + 1
        state = self.setup(t0, x0)
        syncs = self.host_syncs
        out = self.simulate_batch(t0, x0[None],
                                  CgmresState(*(a[None] for a in state)),
                                  n_steps)
        self.host_syncs += syncs
        return tuple(a[0] for a in out)

    def run(self, t0=0.0, x0=None, callback: Optional[Callable] = None,
            dump_prefix: Optional[str] = None):
        """The host loop of :meth:`simulate` with a per-step ``callback(t,
        x, state)``, progress lines at ``print_level >= 3`` and, with
        ``dump_prefix``, ``{prefix}_{x,u,err,param}.dat`` in the
        reference's format (``CgmresSolver::run``,
        ``CgmresSolver.cpp:68-103``).  Returns numpy (ts, xs, us, errs)."""
        cfg, problem = self.config, self.problem
        x = self._initial(problem.x_initial if x0 is None else x0)
        state = self.setup(t0, x)
        syncs = self.host_syncs
        sim_f = INTEGRATORS[cfg.sim_ode_solver]
        f = lambda t, x, u: problem.state_eq(t, x, u[: problem.dim_u])
        ts, xs, us, errs = [], [], [], []
        t = t0
        n = int(round(cfg.sim_duration / cfg.dt)) + 1
        for i in range(n):
            next_x = sim_f(f, t, x, state.u, cfg.dt)
            state = self.control_step(t, x, next_x, state)
            ts.append(t)
            xs.append(x.cpu().numpy())
            us.append(state.u.cpu().numpy())
            errs.append(float(state.err))
            syncs += 3
            if cfg.print_level >= 3 and i % max(cfg.dump_step, 1) == 0:
                print(f"[CGMRES] t {t:.4f}: err {errs[-1]:.6e}")
            if callback is not None:
                callback(t, x, state)
            x = next_x
            t += cfg.dt
        self.host_syncs = syncs
        out = (np.asarray(ts), np.stack(xs), np.stack(us), np.asarray(errs))
        if dump_prefix is not None:
            from nmpc_tpu_torch.utils.trace import dump_cgmres_data

            dump_cgmres_data(*out, prefix=dump_prefix,
                             dump_step=cfg.dump_step,
                             log_dt=cfg.dt * cfg.dump_step)
        return out


# --------------------------------------------------------------------------


def _setup(problem: ContinuousProblem, config: CgmresConfig, t0, x0, u0,
           host=bool) -> CgmresState:
    """The initial input by Newton + GMRES (``CgmresSolver.cpp:8-64``); the
    loop's test reads one device value a pass through ``host``."""
    N = config.horizon_divide_num
    dlt = config.finite_diff_delta
    lmd0 = problem.dphi_dx_at(t0, x0)
    u = u0.to(x0.dtype)
    err = torch.linalg.norm(problem.dh_du_at(t0, x0, u, lmd0))
    it = 0
    while it < config.setup_newton_iters and host(err > config.setup_tol):
        dhdu = problem.dh_du_at(t0, x0, u, lmd0)

        def Amul(v, u=u, dhdu=dhdu):
            return (problem.dh_du_at(t0, x0, u + dlt * v, lmd0) - dhdu) / dlt

        sol = gmres(Amul, -dhdu, torch.zeros_like(u), k_max=problem.dim_uc,
                    eps=1e-10, host=host)
        u = u + sol.x
        err = torch.linalg.norm(problem.dh_du_at(t0, x0, u, lmd0))
        it += 1
    return CgmresState(
        u_list=u[None].repeat(N, 1),
        delta_u_vec=torch.zeros((N * problem.dim_uc,), dtype=x0.dtype,
                                device=x0.device),
        u=u, err=err)


# --------------------------------------------------------------------------
# the batch-minor fleet path: the controllers on the trailing axis, so that
# every per-lane scalar of the GMRES recurrences (Givens coefficients, MGS
# dot products, residuals) is a [B] vector
# --------------------------------------------------------------------------


def gmres_bm(Amul, b, x0, k_max: int, eps: float = 1e-10):
    """Batch-minor GMRES (Givens mode, reorthogonalization on): ``b`` and
    ``x0`` are [n, B], ``Amul`` maps [n, B] -> [n, B] (every lane at once).

    Each lane freezes its Arnoldi state once it has converged and its
    back-substitution truncates at its OWN freeze iteration ``k_lane``: a
    lane that converges at k = 1 in a batch whose slowest lane runs to
    k_max leaves zero Hessenberg diagonals past its freeze point, and
    dividing by them gave NaN for exactly the early-converging lanes a
    real fleet has.  ``k_max`` trips run whatever the residuals (module
    docstring): a trip in which no lane is active changes nothing.
    Returns (x [n, B], iterations per lane [B] int32, rho [B])."""
    n, B = b.shape
    dtype, device = b.dtype, b.device
    k_max = min(k_max, n)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)

    r = b - Amul(x0)
    rho = torch.linalg.norm(r, dim=0)                  # [B]
    thre = eps * torch.linalg.norm(b, dim=0)

    V = zeros(k_max + 1, n, B)
    V[0] = torch.where(rho > 0, r / rho, r)
    H = zeros(k_max + 1, k_max, B)
    g = zeros(k_max + 1, B)
    g[0] = rho
    cs, sn = zeros(k_max, B), zeros(k_max, B)
    k_lane = torch.zeros((B,), dtype=torch.int32, device=device)

    for k in range(k_max):
        act = rho > thre                               # [B]
        w = Amul(V[k])                                 # [n, B]
        Avk_norm = torch.linalg.norm(w, dim=0)
        hcol = zeros(k_max + 1, B)
        for j in range(k + 1):
            h = torch.sum(w * V[j], dim=0)
            w = w - h[None, :] * V[j]
            hcol[j] = h
        new_norm = torch.linalg.norm(w, dim=0)
        # conditional reorthogonalization, per lane (Gmres.h:117-130)
        need = (Avk_norm + 1e-3 * new_norm) == Avk_norm
        for j in range(k + 1):
            h = torch.where(need, torch.sum(w * V[j], dim=0), 0.0)
            w = w - h[None, :] * V[j]
            hcol[j] = hcol[j] + h
        new_norm = torch.where(need, torch.linalg.norm(w, dim=0), new_norm)
        hcol[k + 1] = new_norm
        v_new = torch.where(new_norm > 0, w / new_norm, w)
        V[k + 1] = torch.where(act, v_new, V[k + 1])

        for j in range(k):
            h0, h1 = hcol[j].clone(), hcol[j + 1].clone()
            hcol[j] = cs[j] * h0 - sn[j] * h1
            hcol[j + 1] = sn[j] * h0 + cs[j] * h1
        nu = torch.sqrt(hcol[k] ** 2 + hcol[k + 1] ** 2)
        ck = torch.where(nu > 0, hcol[k] / nu, 1.0)
        sk = torch.where(nu > 0, -hcol[k + 1] / nu, 0.0)
        hcol[k] = ck * hcol[k] - sk * hcol[k + 1]
        hcol[k + 1] = 0.0

        g0, g1 = g[k].clone(), g[k + 1].clone()
        g[k] = torch.where(act, ck * g0 - sk * g1, g0)
        g[k + 1] = torch.where(act, sk * g0 + ck * g1, g1)
        rho = torch.where(act, torch.abs(g[k + 1]), rho)
        k_lane = torch.where(act, k + 1, k_lane)
        H[:, k] = torch.where(act, hcol, H[:, k])
        cs[k] = torch.where(act, ck, cs[k])
        sn[k] = torch.where(act, sk, sn[k])

    # Each lane's back-substitution over its own first k_lane rows, rows
    # past it with a unit diagonal and zero right side (y = 0): the single
    # solver's masked back-substitution, lane by lane, unrolled over the
    # small k_max.
    rhs = torch.where(torch.arange(k_max, device=device)[:, None]
                      < k_lane[None, :], g[:k_max], 0.0)
    y = [None] * k_max
    for i in reversed(range(k_max)):
        s = rhs[i]
        for j in range(i + 1, k_max):
            s = s - H[i, j] * y[j]
        on = i < k_lane
        diag = torch.where(on, H[i, i], 1.0)
        y[i] = torch.where(on, s / diag, torch.zeros_like(s))
    y = torch.stack(y, dim=0)                          # [k_max, B]
    x = x0 + torch.sum(V[:k_max] * y[:, None, :], dim=0)
    return x, k_lane, rho


def _calc_dhdu_list_bm(problem: ContinuousProblem, config: CgmresConfig,
                       t, x, u_list):
    """Batch-minor horizon sweep (``CgmresSolver.cpp:146-183``): x [dim_x,
    B], u_list [N, dim_uc, B] -> dH/du [N, dim_uc, B].  The horizon T and
    its step h are in the state's dtype, from ``t`` (a tensor of it); at t
    = 0 the horizon is zero-length and every value stays finite."""
    N = config.horizon_divide_num
    dtype = x.dtype
    ode = INTEGRATORS[config.ode_solver]
    dim_x, dim_u = problem.dim_x, problem.dim_u
    f_bm = _lanes(lambda tau, xx, uc: problem.state_eq(tau, xx, uc[:dim_u]),
                  2)

    T = config.steady_horizon_duration * (
        1.0 - torch.exp(-config.horizon_increase_ratio * t))
    h = T / N
    steps = torch.arange(N, dtype=dtype, device=x.device)
    taus = t + h * steps

    xs = [x]
    for i in range(N):
        xs.append(ode(f_bm, taus[i], xs[-1], u_list[i], h))
    lmd = _lanes(problem.dphi_dx_at, 1)(t + T, xs[N])

    # backward costate integration at tau_{i+1}, step -h, with (x_i, u_i)
    # (CgmresSolver.cpp:171-179); lambda_{i+1} kept for dH/du_i
    costate_bm = _lanes(lambda tau, lmd_, xu: problem.costate_eq_at(
        tau, lmd_, xu[:dim_x], xu[dim_x:]), 2)
    taus_next = t + h * (1.0 + steps)
    lmd_next = [None] * N
    for i in reversed(range(N)):
        lmd_next[i] = lmd
        xu = torch.cat([xs[i], u_list[i]], dim=0)
        lmd = ode(costate_bm, taus_next[i], lmd, xu, -h)

    # DhDu_i at (tau_i, x_i, u_i, lambda_{i+1}) (CgmresSolver.cpp:182)
    dh = func.vmap(_lanes(problem.dh_du_at, 3))
    return dh(taus, torch.stack(xs[:-1]), u_list, torch.stack(lmd_next))


def _control_step_bm_core(problem: ContinuousProblem, config: CgmresConfig,
                          t, x, next_x, u_list, du_warm):
    """The batch-minor continuation update: x / next_x [dim_x, B], u_list
    [N, dim_uc, B], du_warm [N * dim_uc, B]; returns (u_list_new, du,
    err [B]) in the same layout and the GMRES iterations per lane."""
    N = config.horizon_divide_num
    dlt = config.finite_diff_delta
    dt = config.dt
    nuc = problem.dim_uc
    B = x.shape[-1]
    flat = lambda a: a.reshape(N * nuc, B)

    dhdu = _calc_dhdu_list_bm(problem, config, t, x, u_list)
    t_wd = t + dlt
    x_wd = (1.0 - dlt / dt) * x + (dlt / dt) * next_x
    dhdu_wd = _calc_dhdu_list_bm(problem, config, t_wd, x_wd, u_list)
    b = ((1.0 - config.eq_zeta * dlt) * flat(dhdu) - flat(dhdu_wd)) / dlt

    if config.use_jvp:
        def F(ul):
            return flat(_calc_dhdu_list_bm(problem, config, t_wd, x_wd, ul))

        def Amul(v):
            return func.jvp(F, (u_list,), (v.reshape(N, nuc, B),))[1]
    else:
        def Amul(v):
            ul = u_list + dlt * v.reshape(N, nuc, B)
            dh = _calc_dhdu_list_bm(problem, config, t_wd, x_wd, ul)
            return (flat(dh) - flat(dhdu_wd)) / dlt

    du, iters, _ = gmres_bm(Amul, b, du_warm, k_max=config.k_max, eps=1e-10)
    u_list_new = u_list + dt * du.reshape(N, nuc, B)
    err = torch.sqrt(torch.sum(dhdu**2, dim=(0, 1)))
    return u_list_new, du, err, iters


def _simulate_bm(problem: ContinuousProblem, config: CgmresConfig, t0, x0s,
                 states: CgmresState, n_steps: int):
    """Closed-loop simulations on the batch-minor path, the state held
    batch-minor across steps (one transpose at each end).  Returns
    batch-first (ts [B, n], xs [B, n, dim_x], us [B, n, dim_uc], errs [B,
    n]).  On CUDA tensors the steps replay one captured CUDA graph
    (:func:`_replay_steps`); on the CPU they run eagerly."""
    sim_f = INTEGRATORS[config.sim_ode_solver]
    dim_u = problem.dim_u
    f_bm = _lanes(lambda t, xx, u: problem.state_eq(t, xx, u[:dim_u]), 2)
    bm = lambda a: torch.movedim(a, 0, -1).contiguous()
    B = x0s.shape[0]

    def step(t, x, u_list, du, u):
        """One plant step and control step: the next carry and err."""
        next_x = sim_f(f_bm, t, x, u, config.dt)
        u_list, du, err, _ = _control_step_bm_core(problem, config, t, x,
                                                   next_x, u_list, du)
        return (t + config.dt, next_x, u_list, du, u_list[0]), err

    carry = (t0, bm(x0s), bm(states.u_list), bm(states.delta_u_vec),
             bm(states.u))
    if x0s.device.type == "cuda":
        ts, xs, us, errs = _replay_steps(step, carry, n_steps)
    else:
        hist = []
        for _ in range(n_steps):
            nxt, err = step(*carry)
            hist.append((carry[0], carry[1], nxt[4], err))
            carry = nxt
        ts, xs, us, errs = (torch.stack(h) for h in zip(*hist))
    return (ts[None, :].expand(B, n_steps), xs.permute(2, 0, 1),
            us.permute(2, 0, 1), errs.T)


def _replay_steps(step, carry, n_steps):
    """``n_steps`` of ``step`` (carry -> (next carry, err)) as one CUDA
    graph replayed ``n_steps`` times: a control step reads no device
    value on the host (GMRES runs its ``k_max`` trips), so it captures
    whole, and each replay launches its ~14,000 small kernels without
    the host's Python and ``vmap`` work between them.  Each replay
    records (t, x) and (u, err) at the step's row of the history, then
    writes the next carry over the captured inputs.  The kernels are the
    eager steps' own, so the results are too.  Returns the histories
    (ts [n], xs [n, dim_x, B], us [n, dim_uc, B], errs [n, B])."""
    device = carry[1].device
    static = [a.clone() for a in carry]
    # warm up on a side stream (lazy initialization, the models' constant
    # caches), as capture requires; the step does not write its inputs
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        nxt, err = step(*static)
    torch.cuda.current_stream(device).wait_stream(side)
    hist = [torch.empty((n_steps, *a.shape), dtype=a.dtype, device=device)
            for a in (static[0], static[1], nxt[4], err)]
    row = torch.zeros((1,), dtype=torch.long, device=device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        nxt, err = step(*static)
        for h, a in zip(hist, (static[0], static[1], nxt[4], err)):
            h.index_copy_(0, row, a[None])
        for dst, src in zip(static, nxt):
            dst.copy_(src)
        row.add_(1)
    # capture ran nothing: the inputs and the row are as they were
    for _ in range(n_steps):
        graph.replay()
    return hist
