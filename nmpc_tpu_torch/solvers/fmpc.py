"""FMPC: direct multiple shooting + primal-dual interior point + condensed
Riccati recursion, batched, in PyTorch.

Port of the batched path of ``nmpc_tpu/solvers/fmpc.py`` (``_solve_batched``;
reference ``nmpc_fmpc/include/nmpc_fmpc/FmpcSolver.hpp``, Katayama's thesis
§2.2): the linearized-KKT coefficients of every stage (``:401-440``), the
barrier update eps = clamp(0.5 avg(s nu)) (``:377-399``), the KKT error with
the complementarity residual max(s nu - eps, 0) (``:443-448, 495-521``), the
condensed backward Riccati recursion with the LLT -> LU fallback
(``:524-665``), the forward recursion for (Δx, Δu, Δλ, Δs, Δν)
(``:667-708``), fraction-to-boundary step sizes (``:713-750``) and the
optional l1-merit Armijo line search (``:752-793, 836-982``), with per-lane
``FmpcStatus`` and NaN/Inf detection.  Masked inequality rows are pinned to
g = -1, s = 1, nu = 0 with zeroed Jacobian rows, which makes them exact
no-ops; masked inputs get zero columns and a unit diagonal.

Layout: every internal quantity is batch-minor, ``[..., B]``, as in the
JAX package; the public layout is batch-first.

Host control flow: the JAX ``lax.while_loop``s become Python loops that
read one device flag (one host sync) per trip: the iteration loop's
any-lane-running test and, with ``enable_line_search``, each Armijo
halving.  ``FmpcSolver.host_syncs`` holds the count for the last solve.
The ``print_level`` diagnostics of the JAX single solve
(``nmpc_tpu/solvers/fmpc.py:623-635``) come from ``FmpcSolver.solve``
only; a message read counts as a host sync, and level 0 reads nothing.
The reference's negativity clamp after a step is a no-op (it clamps at
``lowest()``, ``FmpcSolver.hpp:813-829``), so slightly negative s or nu
are kept, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import func

from nmpc_tpu_torch.core.problem import Problem
from nmpc_tpu_torch.core.types import (FmpcConfig, FmpcResult, FmpcStatus,
                                        FmpcTrace, FmpcVariable)
from nmpc_tpu_torch.kernels.ddp_backward import (_chol_bl, _chol_solve_bl,
                                                 _mm, _mT, _mv)
from nmpc_tpu_torch.kernels.fmpc_backward import (MAX_NG, MAX_NU, MAX_NX,
                                                  VARIANTS,
                                                  backward_fmpc_fused,
                                                  condensation,
                                                  kernel_supports,
                                                  resident_fits)
from nmpc_tpu_torch.kernels.fmpc_forward import (forward_fmpc_deltas_fused,
                                                 forward_fmpc_deltas_plain,
                                                 forward_kernel_supports)
from nmpc_tpu_torch.kernels.linalg import _inv_bl
from nmpc_tpu_torch.solvers.ddp import HostReads
from nmpc_tpu_torch.solvers.stages import _lanes, _stage_times
from nmpc_tpu_torch.utils.logging import log, log_when
from nmpc_tpu_torch.utils.timing import phase

_BARRIER_EPS_INIT = 1e-4   # FmpcSolver.h:414
_BARRIER_EPS_MIN = 1e-8    # FmpcSolver.hpp:396
_BARRIER_EPS_MAX = 1e6     # FmpcSolver.hpp:397
_SIGMA = 0.5               # FmpcSolver.hpp:392
_FTB_MARGIN = 0.995        # fraction-to-boundary margin, FmpcSolver.hpp:719

_CONTINUED = int(FmpcStatus.ITERATION_CONTINUED)


class FmpcSolver:
    """Problem + config bound into batched solve functions.

    ``backward_variant`` picks the CUDA backward where the resolved
    backward is ``"pallas"``: ``"stream"`` (K8), ``"resident"`` (K9 where
    ``resident_fits`` holds, K8 otherwise, as the JAX rule at
    ``nmpc_tpu/kernels/fmpc_backward_pallas.py:747-751``) or ``"packed"``
    (K10, between a pack and an unpack); the JAX package's
    ``NMPC_FMPC_PALLAS`` and ``NMPC_PALLAS_PACKED`` switches.  The three
    compute the same numbers."""

    def __init__(self, problem: Problem, config: FmpcConfig = FmpcConfig(),
                 backward_variant: str = "stream"):
        if problem.ineq_const is None or problem.ineq_dim <= 0:
            raise ValueError("FMPC requires a problem with inequality "
                             "constraints (ineq_const, ineq_dim > 0)")
        if backward_variant not in VARIANTS:
            raise ValueError(f"backward_variant must be one of {VARIANTS}, "
                             f"got {backward_variant!r}")
        self.problem = problem
        self.config = config
        self.backward_variant = backward_variant
        self.host_syncs = 0   # host reads of device values, last solve

    def solve_batch(self, t0, x0s, variables: FmpcVariable,
                    barrier_epss) -> FmpcResult:
        """Batched solve: x0s [B, nx], ``variables`` the warm starts with a
        leading batch axis, barrier_epss [B]; the result carries a leading
        batch axis."""
        return self._run(t0, x0s, variables, barrier_epss)

    def _run(self, t0, x0s, variables, barrier_epss, timer=None,
             single=False):
        host = HostReads()
        res = _solve_batched(self.problem, self.config, t0, x0s, variables,
                             barrier_epss, self.backward_variant, host=host,
                             timer=timer, single=single)
        self.host_syncs = host.n
        return res

    def solve(self, t0, x0, variable: FmpcVariable,
              barrier_eps=_BARRIER_EPS_INIT, timer=None) -> FmpcResult:
        """One solve (reference ``FmpcSolver::solve``,
        ``FmpcSolver.hpp:158-257``): ``solve_batch`` at B=1, squeezed,
        with the ``print_level`` diagnostics; ``timer``
        (``utils/timing.py::PhaseTimer``) records its phases.  The JAX
        ``_solve`` takes an LU solve where the batched path takes the
        Gauss-Jordan inverse on a non-PD stage; both solve G x = r."""
        eps = torch.as_tensor(barrier_eps, dtype=x0.dtype,
                              device=x0.device).reshape(1)
        res = self._run(t0, x0[None], _map(lambda a: a[None], variable),
                        eps, timer=timer, single=True)
        first = lambda a: a[0]
        return FmpcResult(
            status=first(res.status), iters=first(res.iters),
            variable=_map(first, res.variable),
            kkt_error=first(res.kkt_error), ks=first(res.ks),
            Ks=first(res.Ks), barrier_eps=first(res.barrier_eps),
            trace=FmpcTrace(iter=first(res.trace.iter),
                            kkt_error=first(res.trace.kkt_error)))


def _map(fn, *variables: FmpcVariable) -> FmpcVariable:
    """``fn`` applied field by field to one or more variables."""
    return FmpcVariable(**{
        f.name: fn(*(getattr(v, f.name) for v in variables))
        for f in dataclasses.fields(FmpcVariable)})


class _StCoeffs(NamedTuple):
    """Linearized-KKT coefficients, batch-minor: stage axis leading, batch
    axis trailing on every field, contiguous."""

    A: torch.Tensor        # [N, nx, nx, B]
    B: torch.Tensor        # [N, nx, nu, B]
    C: torch.Tensor        # [N, ng, nx, B]
    D: torch.Tensor        # [N, ng, nu, B]
    Lx: torch.Tensor       # [N, nx, B]
    Lu: torch.Tensor       # [N, nu, B]
    Lxx: torch.Tensor      # [N, nx, nx, B]
    Luu: torch.Tensor      # [N, nu, nu, B]
    Lxu: torch.Tensor      # [N, nx, nu, B]
    x_bar: torch.Tensor    # [N, nx, B]
    g_bar: torch.Tensor    # [N, ng, B]
    Lx_bar: torch.Tensor   # [N, nx, B]
    Lu_bar: torch.Tensor   # [N, nu, B]
    Lx_term: torch.Tensor      # [nx, B]
    Lxx_term: torch.Tensor     # [nx, nx, B]
    Lx_bar_term: torch.Tensor  # [nx, B]


def _ineq_masks(problem, ts, dtype):
    """The active-inequality mask of each stage, [N, ng] at ``dtype``
    (masks are the same in every lane)."""
    return func.vmap(lambda t: problem.ineq_mask_at(t).to(dtype))(ts)


def _coeffs_bm(problem: Problem, config: FmpcConfig, t0,
               var: FmpcVariable) -> _StCoeffs:
    """Batch-minor coefficient sweep (``FmpcSolver.hpp:401-440``): the
    per-lane stage function batched over the lanes (``_lanes``) and then
    over the stages, with the masked-dimension embedding."""
    N = config.horizon_steps
    dt = problem.dt
    dtype = var.xs.dtype
    ts = _stage_times(problem, t0, N)

    def one(t, x, x_next, u, lam, lam_next, s, nu):
        im = problem.input_mask_at(t).to(dtype)
        gm = problem.ineq_mask_at(t).to(dtype)
        # cast at the boundary: a derivative that does not depend on an
        # argument can come back from torch.func promoted to float64
        A, B = (a.to(dtype) for a in problem.linearize_dynamics(t, x, u))
        C, D = (a.to(dtype) for a in problem.linearize_ineq(t, x, u))
        Lx, Lu, Lxx, Luu, Lxu = (
            a.to(dtype) for a in problem.quadraticize_running_cost(t, x, u))

        B = B * im[None, :]
        Lu = Lu * im
        Luu = Luu * (im[:, None] * im[None, :]) + torch.diag_embed(1.0 - im)
        Lxu = Lxu * im[None, :]
        C = C * gm[:, None]
        D = D * (gm[:, None] * im[None, :])

        g = torch.where(gm > 0, problem.ineq_const(t, x, u), -1.0)
        x_bar = problem.dynamics(t, x, u) - x_next            # (2.23c)
        g_bar = torch.where(gm > 0, g + s, 0.0)               # (2.23d)
        Lx_bar = -lam + dt * Lx + A.T @ lam_next + C.T @ nu   # (2.25b)
        Lu_bar = dt * Lu + B.T @ lam_next + D.T @ nu          # (2.25c)
        return (A, B, C, D, Lx, Lu, Lxx, Luu, Lxu,
                x_bar, g_bar, Lx_bar, Lu_bar)

    outs = func.vmap(_lanes(one, 7))(ts, var.xs[:-1], var.xs[1:], var.us,
                                     var.lambdas[:-1], var.lambdas[1:],
                                     var.ss, var.nus)
    Lx_T, Lxx_T = _lanes(problem.quadraticize_terminal_cost, 1)(
        t0 + N * dt, var.xs[-1])
    Lx_T, Lxx_T = Lx_T.to(dtype), Lxx_T.to(dtype)
    Lx_bar_T = Lx_T - var.lambdas[-1]                         # (2.25a)
    return _StCoeffs(*(a.to(dtype).contiguous() for a in
                       (*outs, Lx_T, Lxx_T, Lx_bar_T)))


def _kkt_error_bm(x0_b, var: FmpcVariable, co: _StCoeffs, barrier_eps, gms):
    """Per-lane KKT residual norm (``FmpcSolver.hpp:496-521``); all args
    batch-minor, ``barrier_eps`` [B], ``gms`` [N, ng].  Returns [B]."""
    s01 = lambda a: torch.sum(a, dim=(0, 1))
    e = torch.sum((x0_b - var.xs[0]) ** 2, dim=0)
    e = e + (s01(co.x_bar**2) + s01(co.g_bar**2))
    e = e + (s01(co.Lx_bar**2) + s01(co.Lu_bar**2))
    comp = torch.clamp(var.ss * var.nus - barrier_eps[None, None, :], min=0.0)
    comp = comp * gms[:, :, None]
    e = e + s01(comp**2)
    e = e + torch.sum(co.Lx_bar_term**2, dim=0)
    return torch.sqrt(e)


def _lanes_all(a):
    """Reduce a boolean [..., B] over every axis but the batch axis."""
    return a.reshape(-1, a.shape[-1]).all(dim=0)


def _finite(a):
    return _lanes_all(torch.isfinite(a))


def _backward_bm(problem: Problem, config: FmpcConfig, co: _StCoeffs, ss,
                 nus, gms, barrier_eps):
    """Condensed Riccati recursion, batch-minor (``FmpcSolver.hpp:524-665``):
    the plain version of the K8 kernel (``kernels/fmpc_backward.py``).

    ``co`` from :func:`_coeffs_bm`; ``ss``/``nus`` [N, ng, B], ``gms``
    [N, ng], ``barrier_eps`` [B].  The (s, nu) condensation through nu/s
    (computed for every row, then selected by the mask), then
    :func:`_riccati_condensed`.
    Returns (ks [N,nu,B], Ks [N,nu,nx,B], svecs [N+1,nx,B],
    Ps [N+1,nx,nx,B], ok [B], finite [B]); row N of svecs/Ps is the
    terminal (s_T, P_T), which the finite check covers too."""
    nu_s, tilde = condensation(co, ss, nus, gms, barrier_eps)
    fields = {"A": co.A, "B": co.B, "C": co.C, "D": co.D, "Lxx": co.Lxx,
              "Luu": co.Luu, "Lxu": co.Lxu, "xb": co.x_bar,
              "Lxb": co.Lx_bar, "Lub": co.Lu_bar, "nu_s": nu_s,
              "tilde": tilde}
    return _riccati_condensed(problem, config, fields, -co.Lx_bar_term,
                              co.Lxx_term)


def _riccati_condensed(problem: Problem, config: FmpcConfig, f: dict, s_T,
                       P_T):
    """The recursion of :func:`_backward_bm` on condensed stage fields
    ``f`` (the names of ``kernels/fmpc_backward.py::IN_FIELDS``, each
    [N, ..., B]) from the terminal (s_T [nx, B], P_T [nx, nx, B]): per
    stage F/H/G, LLT(G) with Eigen's pivot > 0 rule and, unless
    ``break_if_llt_fails``, the Gauss-Jordan inverse on the lanes whose
    LLT failed, then the (s, P) recursion with P symmetrized.  Also the
    plain version of the packed kernel (K10), which unpacks into ``f``."""
    dt = problem.dt
    N, B = f["A"].shape[0], s_T.shape[-1]
    s_vec, P = s_T, P_T
    ok = torch.ones((B,), dtype=torch.bool, device=s_T.device)
    ks, Ks, svecs, Ps = [None] * N, [None] * N, [None] * N, [None] * N
    for i in reversed(range(N)):
        A, Bm, C, D = f["A"][i], f["B"][i], f["C"][i], f["D"][i]
        nu_s, tilde = f["nu_s"][i], f["tilde"][i]            # [ng, B]
        CT, DT = _mT(C), _mT(D)
        Qxx_t = dt * f["Lxx"][i] + _mm(CT, nu_s[:, None, :] * C)  # (2.28c)
        Quu_t = dt * f["Luu"][i] + _mm(DT, nu_s[:, None, :] * D)  # (2.28e)
        Qxu_t = dt * f["Lxu"][i] + _mm(CT, nu_s[:, None, :] * D)  # (2.28d)
        Lx_t = f["Lxb"][i] + _mv(CT, tilde)                      # (2.28f)
        Lu_t = f["Lub"][i] + _mv(DT, tilde)                      # (2.28g)

        AT, BT = _mT(A), _mT(Bm)
        PB = _mm(P, Bm)
        F = Qxx_t + _mm(AT, _mm(P, A))                       # (2.35b)
        H = Qxu_t + _mm(AT, PB)                              # (2.35c)
        G = Quu_t + _mm(BT, PB)                              # (2.35d)

        Pxb = _mv(P, f["xb"][i])
        rhs_k = _mv(BT, Pxb - s_vec) + Lu_t                  # [nu, B]
        L, pd = _chol_bl(G)
        k = -_chol_solve_bl(L, rhs_k[:, None, :])[:, 0, :]
        K = -_chol_solve_bl(L, _mT(H))
        if config.break_if_llt_fails:
            ok = ok & pd
        else:
            # LU fallback on a non-PD G (FmpcSolver.hpp:608-617)
            Ginv = _inv_bl(G)
            k = torch.where(pd[None, :], k, -_mv(Ginv, rhs_k))
            K = torch.where(pd[None, None, :], K, -_mm(Ginv, _mT(H)))

        s_vec = _mv(AT, s_vec - Pxb) - Lx_t - _mv(H, k)      # (2.35a)
        P_new = F - _mm(_mT(K), _mm(G, K))                   # (2.35a)
        P = 0.5 * (P_new + _mT(P_new))
        ks[i], Ks[i], svecs[i], Ps[i] = k, K, s_vec, P
    ks, Ks = torch.stack(ks), torch.stack(Ks)
    svecs = torch.stack(svecs + [s_T])                       # [N+1, nx, B]
    Ps = torch.stack(Ps + [P_T])
    finite = torch.ones((B,), dtype=torch.bool, device=ok.device)
    if config.check_nan:
        finite = _finite(ks) & _finite(Ks) & _finite(svecs) & _finite(Ps)
    return ks, Ks, svecs, Ps, ok, finite


def _forward_bm(problem, config, co: _StCoeffs, var: FmpcVariable, x0_b,
                ks, Ks, ss_vec, Ps, barrier_eps, gms, fused: bool = False):
    """Batch-minor forward recursion (``FmpcSolver.hpp:668-708``).

    The (dxs, dus) stage recursion, the only sequential part, runs in the
    K11 kernel with ``fused`` (``kernels/fmpc_forward.py``) and in its
    plain loop otherwise; dxs[i] is the delta before stage i, dxs[N] the
    final carry.  The Δλ/Δs/Δν post-passes are elementwise over the whole
    horizon and stay torch ops either way.
    Returns (delta variable, batch-minor; finite [B])."""
    dx0 = x0_b - var.xs[0]                                   # [nx, B]
    recursion = forward_fmpc_deltas_fused if fused else \
        forward_fmpc_deltas_plain
    dxs, dus = recursion(co.A, co.B, co.x_bar, ks, Ks, dx0.contiguous())
    # Δλ_i = P_i Δx_i - s_i  (2.33)
    dlams = torch.sum(Ps * dxs[:, None, :, :], dim=2) - ss_vec
    # Δs, Δν (2.27a-b); masked rows pinned to zero
    Cdx = torch.sum(co.C * dxs[:-1][:, None, :, :], dim=2)   # [N, ng, B]
    Ddu = torch.sum(co.D * dus[:, None, :, :], dim=2)
    dss = -(Cdx + Ddu + co.g_bar)
    dnus = -(var.nus * (dss + var.ss) - barrier_eps[None, None, :]) / var.ss
    gm3 = gms[:, :, None]
    delta = FmpcVariable(xs=dxs, us=dus, lambdas=dlams, ss=dss * gm3,
                         nus=dnus * gm3)
    finite = torch.ones(x0_b.shape[-1:], dtype=torch.bool,
                        device=x0_b.device)
    if config.check_nan:
        for f in dataclasses.fields(FmpcVariable):
            finite = finite & _finite(getattr(delta, f.name))
    return delta, finite


def _merit_pieces_bm(problem, config, t0, x0_b, var: FmpcVariable,
                     barrier_eps, gms):
    """Per-lane (merit_obj, merit_const) of the l1 merit function
    (``FmpcSolver.hpp:936-982``); batch-minor, returns ([B], [B])."""
    N = config.horizon_steps
    dt = problem.dt
    dtype = var.xs.dtype
    ts = _stage_times(problem, t0, N)

    def stage(t, eps, x, x_next, u, s):
        gm = problem.ineq_mask_at(t).to(dtype)
        obj = problem.running_cost(t, x, u) * dt
        obj = obj + -eps * torch.sum(torch.where(gm > 0, torch.log(s), 0.0))
        cx = problem.dynamics(t, x, u) - x_next
        g = torch.where(gm > 0, problem.ineq_const(t, x, u) + s, 0.0)
        return obj, torch.sum(torch.abs(cx)) + torch.sum(torch.abs(g))

    objs, consts = func.vmap(_lanes(stage, 5),
                             in_dims=(0, None, 0, 0, 0, 0))(
        ts, barrier_eps, var.xs[:-1], var.xs[1:], var.us, var.ss)
    term = _lanes(problem.terminal_cost, 1)(t0 + N * dt, var.xs[-1])
    obj = torch.sum(objs.to(dtype), dim=0) + term.to(dtype)
    const = (torch.sum(consts.to(dtype), dim=0)
             + torch.sum(torch.abs(x0_b - var.xs[0]), dim=0))
    return obj, const


def _l1_dir_deriv_bm(fn_val, jac_dot_dir):
    """Per-lane directional derivative of ||fn||_1 along jac@dir
    (Nocedal & Wright A.51; reference ``MathUtils.h:17-38``), reduced over
    every axis but the batch axis."""
    d = torch.where(fn_val > 0, jac_dot_dir,
                    torch.where(fn_val < 0, -jac_dot_dir,
                                torch.abs(jac_dot_dir)))
    return torch.sum(d, dim=tuple(range(d.ndim - 1)))


def _update_bm(problem, config, t0, x0_b, co: _StCoeffs, var: FmpcVariable,
               delta: FmpcVariable, barrier_eps, gms, host):
    """Fraction-to-boundary + optional line search + update
    (``FmpcSolver.hpp:711-834``), per lane.  The Armijo halving is a
    Python loop with one ``host`` read per trip; a lane stops halving on
    its own and is frozen.  Returns (new_var, valid [B])."""
    gm3 = gms[:, :, None]

    def ftb(v, dv):
        cand = torch.where((dv < 0) & (gm3 > 0), -_FTB_MARGIN * v / dv, 1.0)
        return torch.clamp(torch.amin(cand, dim=(0, 1)), max=1.0)

    alpha_s = ftb(var.ss, delta.ss)                           # [B]
    alpha_nu = ftb(var.nus, delta.nus)
    valid = ((alpha_s > 0.0) & (alpha_s <= 1.0)
             & (alpha_nu > 0.0) & (alpha_nu <= 1.0))

    if config.enable_line_search:
        dt = problem.dt
        s01 = lambda a: torch.sum(a, dim=(0, 1))
        merit_obj, merit_const = _merit_pieces_bm(
            problem, config, t0, x0_b, var, barrier_eps, gms)
        d_obj = s01(co.Lx * delta.xs[:-1]) * dt
        d_obj = d_obj + s01(co.Lu * delta.us) * dt
        d_obj = d_obj + -barrier_eps * s01(
            torch.where(gm3 > 0, delta.ss / var.ss, 0.0))
        d_obj = d_obj + torch.sum(co.Lx_term * delta.xs[-1], dim=0)

        contract = lambda M, v: torch.sum(M * v[:, None, :, :], dim=2)
        d_const = _l1_dir_deriv_bm(x0_b - var.xs[0], -delta.xs[0])
        d_const = d_const + _l1_dir_deriv_bm(
            co.x_bar, contract(co.A, delta.xs[:-1]))
        d_const = d_const + _l1_dir_deriv_bm(co.x_bar,
                                             contract(co.B, delta.us))
        d_const = d_const + _l1_dir_deriv_bm(co.x_bar, -delta.xs[1:])
        d_const = d_const + _l1_dir_deriv_bm(
            co.g_bar, contract(co.C, delta.xs[:-1]))
        d_const = d_const + _l1_dir_deriv_bm(co.g_bar,
                                             contract(co.D, delta.us))
        d_const = d_const + _l1_dir_deriv_bm(co.g_bar, delta.ss)

        if config.merit_const_scale_from_lagrange_multipliers:
            scale = torch.clamp(torch.maximum(
                torch.amax(torch.abs(var.lambdas), dim=(0, 1)),
                torch.amax(torch.abs(var.nus * gm3), dim=(0, 1))), min=1e-3)
        else:
            rho = 0.5
            scale = torch.clamp(d_obj / ((1.0 - rho) * merit_const),
                                min=1e-3)
        merit0 = merit_obj + scale * merit_const
        merit_deriv = d_obj + scale * d_const
        armijo_scale, alpha_min = 1e-3, 1e-10

        def merit_at(alpha):
            v = FmpcVariable(xs=var.xs + alpha * delta.xs,
                             us=var.us + alpha * delta.us,
                             lambdas=var.lambdas,
                             ss=var.ss + alpha * delta.ss, nus=var.nus)
            o, c = _merit_pieces_bm(problem, config, t0, x0_b, v,
                                    barrier_eps, gms)
            return o + scale * c

        it = torch.zeros_like(alpha_s, dtype=torch.int32)
        while True:
            fail = (merit_at(alpha_s)
                    >= merit0 + armijo_scale * alpha_s * merit_deriv)
            act = (fail & (alpha_s >= alpha_min)
                   & (it < config.max_line_search_iter))
            if not host(torch.any(act)):
                break
            alpha_s = torch.where(act, alpha_s * 0.5, alpha_s)
            it = torch.where(act, it + 1, it)

    new_var = FmpcVariable(
        xs=var.xs + alpha_s * delta.xs,
        us=var.us + alpha_s * delta.us,
        lambdas=var.lambdas + alpha_nu * delta.lambdas,
        ss=var.ss + alpha_s * delta.ss,
        nus=var.nus + alpha_nu * delta.nus,
    )
    return new_var, valid


def _resolve_impls(config: FmpcConfig, problem: Problem, dtype,
                   device) -> tuple:
    """(backward, forward) choice of the batched solve; the one place that
    holds the ``auto`` rules.

    ``auto`` takes the K8 backward (``"pallas"``) and the K11 recursion
    (``"fused"``) on CUDA tensors wherever the kernel takes the shape and
    dtype (``kernel_supports``: (nx, nu, ng) up to (16, 16, 64), float32
    or float64, any B; past (8, 4, 16), the oscillating masses' (12, 3,
    30) among them, the wide units; the unit is built on demand), and the
    plain versions otherwise, on CPU tensors always.  The JAX rule's
    ``B % 128 == 0``, fp32, ``N >= 50`` and VMEM conditions were fit to
    the TPU and do not carry over.  An explicit ``"pallas"`` or
    ``"fused"`` on a shape the kernel does not take raises
    ``ValueError`` naming the shape and the ceiling; on CPU tensors the
    kernels' wrappers run their plain versions."""
    nx, nu, ng = problem.state_dim, problem.input_dim, problem.ineq_dim
    bw, fw = config.backward_impl, config.forward_impl
    bw_ok = kernel_supports(nx, nu, ng, dtype)
    fw_ok = forward_kernel_supports(nx, nu, dtype)
    if bw == "pallas" and not bw_ok:
        raise ValueError(f"backward_impl='pallas': the K8 kernel takes "
                         f"(nx, nu, ng) up to ({MAX_NX}, {MAX_NU}, "
                         f"{MAX_NG}) at float32/float64; got ({nx}, {nu}, "
                         f"{ng}) at {dtype}")
    if fw == "fused" and not fw_ok:
        raise ValueError(f"forward_impl='fused': the K11 kernel takes "
                         f"(nx, nu) up to ({MAX_NX}, {MAX_NU}) at "
                         f"float32/float64; got ({nx}, {nu}) at {dtype}")
    on_card = device.type == "cuda"
    if bw == "auto":
        bw = "pallas" if on_card and bw_ok else "stacked"
    if fw == "auto":
        fw = "fused" if on_card and fw_ok else "scan"
    return bw, fw


def _solve_batched(problem: Problem, config: FmpcConfig, t0, x0s,
                   variables: FmpcVariable, barrier_eps0s,
                   backward_variant="stream", host=None, timer=None,
                   single=False):
    """Batched FMPC solve; returns the FmpcResult.  ``host`` (a
    ``HostReads``) counts the host reads.

    Check-first loop (``nmpc_tpu/solvers/fmpc.py:1059-1137``): the
    (barrier, coefficients, KKT) check runs before the loop and again at
    the end of each body for the next iterate, as the reference returns
    from procOnce before the backward pass when the KKT error is small
    (``FmpcSolver.hpp:443-448``).  Per-lane control flow follows JAX's
    ``_solve_batched`` exactly: a lane that is not running is frozen, a
    checking lane writes trace column ``steps + 1`` and takes eps2, the
    others keep their eps.  ``timer`` (``utils/timing.py::PhaseTimer``)
    records the checks (``"coeff"``: the barrier update, coefficients and
    KKT error, row 1 and then row ``steps + 1``) and each step's
    ``"backward"``, ``"forward"`` and ``"update"`` (row ``steps``);
    without it the solve adds no event and no synchronization.
    ``single`` (B = 1, from ``FmpcSolver.solve``) emits the
    ``print_level`` messages."""
    dtype, device = x0s.dtype, x0s.device
    B = x0s.shape[0]
    N = config.horizon_steps
    nx, nu_dim, ng = problem.state_dim, problem.input_dim, problem.ineq_dim
    want = {"xs": (B, N + 1, nx), "us": (B, N, nu_dim),
            "lambdas": (B, N + 1, nx), "ss": (B, N, ng), "nus": (B, N, ng)}
    for name, shape in want.items():
        got = tuple(getattr(variables, name).shape)
        if got != shape:
            raise ValueError(f"variables.{name} must have shape {shape}, "
                             f"got {got}")
    host = HostReads() if host is None else host
    level = config.print_level if single else 0

    t0 = torch.as_tensor(t0, dtype=dtype, device=device)
    ts = _stage_times(problem, t0, N)
    gms = _ineq_masks(problem, ts, dtype)                    # [N, ng]
    gm3 = gms[:, :, None]
    bw_impl, fw_impl = _resolve_impls(config, problem, dtype, device)

    bm = lambda a: torch.movedim(a, 0, -1).contiguous()
    x0_b = bm(x0s)                                           # [nx, B]
    var = _map(bm, variables)
    eps = torch.as_tensor(barrier_eps0s, dtype=dtype,
                          device=device).expand(B).clone()

    if config.init_complementary_variable:
        # (FmpcSolver.hpp:171-188): every lane restarts from eps = 1e-4
        margin, cmin = 1e-2, 1e-2
        eps = torch.full((B,), _BARRIER_EPS_INIT, dtype=dtype, device=device)
        g0 = func.vmap(_lanes(problem.ineq_const, 2))(
            ts, var.xs[:-1], var.us).to(dtype).contiguous()
        ss = (1.0 + margin) * torch.clamp(-g0, min=cmin)
        nus = (1.0 + margin) * torch.clamp(eps[None, None, :] / ss, min=cmin)
        var = dataclasses.replace(var, ss=ss, nus=nus)

    # masked inequality rows pinned to the inert fixed point (s=1, nu=0)
    var = dataclasses.replace(var, ss=torch.where(gm3 > 0, var.ss, 1.0),
                              nus=torch.where(gm3 > 0, var.nus, 0.0))
    n_active = torch.clamp(torch.sum(gms), min=1.0)
    # A negative (s, nu) warm start: the reference throws (checkVariable,
    # FmpcSolver.hpp:348-362); here the lane ends UNINITIALIZED with
    # kkt = inf and is left untouched.
    ws_valid = (_lanes_all(var.ss * gm3 >= 0)
                & _lanes_all(var.nus * gm3 >= 0))

    if bw_impl == "pallas":
        variant = backward_variant
        if variant == "resident" and not resident_fits(nx, nu_dim, ng, N,
                                                        dtype):
            variant = "stream"

        def backward_fn(co, ss, nus, eps_):
            return backward_fmpc_fused(problem, config, co, ss, nus, gms,
                                       eps_, variant=variant)
    else:
        def backward_fn(co, ss, nus, eps_):
            return _backward_bm(problem, config, co, ss, nus, gms, eps_)

    def check(var, eps):
        """Barrier update + coefficients + KKT error (FmpcSolver.hpp:
        377-448)."""
        if config.update_barrier_eps:
            s_nu_ave = torch.sum(var.ss * var.nus * gm3, dim=(0, 1)) / n_active
            eps = torch.clamp(_SIGMA * s_nu_ave, _BARRIER_EPS_MIN,
                              _BARRIER_EPS_MAX)
        co = _coeffs_bm(problem, config, t0, var)
        kkt = _kkt_error_bm(x0_b, var, co, torch.zeros_like(eps), gms)
        return co, kkt, eps

    with phase(timer, "coeff", 1):
        co, kkt1, eps1 = check(var, eps)
    status = torch.where(kkt1 <= config.kkt_error_thre,
                         int(FmpcStatus.SUCCEEDED), _CONTINUED)
    status = torch.where(ws_valid, status,
                         int(FmpcStatus.UNINITIALIZED)).to(torch.int32)
    trace = torch.zeros((B, config.max_iter + 1), dtype=dtype, device=device)
    if config.max_iter >= 1:
        trace[:, 1] = torch.where(ws_valid, kkt1, 0.0)
    iters = ws_valid.to(torch.int32)
    kkt = torch.where(ws_valid, kkt1, float("inf")).to(dtype)
    eps = torch.where(ws_valid, eps1, eps)
    ks = torch.zeros((N, nu_dim, B), dtype=dtype, device=device)
    Ks = torch.zeros((N, nu_dim, nx, B), dtype=dtype, device=device)

    steps = 0
    while steps < config.max_iter and host(torch.any(status == _CONTINUED)):
        steps += 1
        running = status == _CONTINUED
        with phase(timer, "backward", steps):
            ks_b, Ks_b, ss_vec, Ps, bw_ok, bw_finite = backward_fn(
                co, var.ss, var.nus, eps)
        bw_good = bw_ok & bw_finite
        with phase(timer, "forward", steps):
            delta, fw_finite = _forward_bm(problem, config, co, var, x0_b,
                                           ks_b, Ks_b, ss_vec, Ps, eps, gms,
                                           fused=fw_impl == "fused")
        with phase(timer, "update", steps):
            new_var, up_ok = _update_bm(problem, config, t0, x0_b, co, var,
                                        delta, eps, gms, host=host)

        # precedence: backward over forward over update (fmpc.py:1112-1115)
        step_status = torch.full((B,), _CONTINUED, dtype=torch.int32,
                                 device=device)
        step_status = torch.where(~up_ok, int(FmpcStatus.ERROR_IN_UPDATE),
                                  step_status)
        step_status = torch.where(~fw_finite, int(FmpcStatus.ERROR_IN_FORWARD),
                                  step_status)
        step_status = torch.where(~bw_good, int(FmpcStatus.ERROR_IN_BACKWARD),
                                  step_status)
        status = torch.where(running, step_status, status)

        advance = running & (status == _CONTINUED)
        var = _map(lambda n, o: torch.where(advance, n, o), new_var, var)
        # gains only from a good backward pass
        take_gains = running & bw_good
        ks = torch.where(take_gains, ks_b, ks)
        Ks = torch.where(take_gains, Ks_b, Ks)

        # the next check, per lane, gated by the iteration cap
        with phase(timer, "coeff", steps + 1):
            co2, kkt2, eps2 = check(var, eps)
        do_check = advance & (iters < config.max_iter)
        iters = torch.where(do_check, iters + 1, iters)
        status = torch.where(do_check & (kkt2 <= config.kkt_error_thre),
                             int(FmpcStatus.SUCCEEDED), status)
        kkt = torch.where(do_check, kkt2, kkt)
        eps = torch.where(do_check, eps2, eps)
        co = _StCoeffs(*(torch.where(do_check, n, o)
                         for n, o in zip(co2, co)))
        # every checking lane writes column steps + 1 (= its iters)
        if steps + 1 <= config.max_iter:
            trace[:, steps + 1] = torch.where(do_check, kkt2,
                                              trace[:, steps + 1])

        if level:   # diagnostics (reference FmpcSolver.h:60-61 gate)
            log(level, 3, "[FMPC] iter {it}: kkt_error {kkt:.6e} "
                "barrier_eps {eps:.3e}", read=host.item, it=iters[0],
                kkt=kkt[0], eps=eps[0])
            for bad, what in ((~bw_good, "backward pass"),
                              (~fw_finite, "forward pass"),
                              (~up_ok, "update")):
                log_when(level, 1, bad[0], f"[FMPC/Warning] Error in {what} "
                         "(iter {it})", read=host.item, it=iters[0])

    status = torch.where(status == _CONTINUED,
                         int(FmpcStatus.MAX_ITERATION_REACHED), status)
    bf = lambda a: torch.movedim(a, -1, 0).contiguous()
    result = FmpcResult(
        status=status.to(torch.int32),
        iters=iters,
        variable=_map(bf, var),
        kkt_error=kkt,
        ks=bf(ks),
        Ks=bf(Ks),
        barrier_eps=eps,
        trace=FmpcTrace(
            iter=torch.arange(config.max_iter + 1, dtype=torch.int32,
                              device=device).repeat(B, 1),
            kkt_error=trace),
    )
    return result
