"""DDP / iLQG trajectory optimizer, batched, in PyTorch.

Port of the batched path of ``nmpc_tpu/solvers/ddp.py`` (``_solve_stacked``;
reference ``nmpc_ddp/include/nmpc_ddp/DDPSolver.hpp``): Levenberg-Marquardt
regularized backward Riccati recursion with per-lane lambda retry,
all-alphas line search with the reference's first-accept decision, the
reference's termination tests, per-lane status and trace rows.

Layout: every internal quantity is batch-minor, ``[..., B]``, as in the
JAX package; the public layout is batch-first.  The JAX package's
``(S, 128)`` lane blocking is TPU-only and is replaced by a flat trailing
``B``.  The problem's per-instance callables are batched with
``torch.func.vmap``.

Host control flow: the JAX ``lax.while_loop`` / ``lax.cond`` constructs
become Python control flow that reads a device value (one host sync) at
each decision: the iteration loop's any-lane-running test, each pass of
the backward retry loop, the head path's tail test and, in ``ls_mode``
"auto", the hysteresis predictor's accept-all-alpha[0] flag.
``DDPSolver.host_syncs`` holds the count for the last solve.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import func

from nmpc_tpu_torch.core.problem import Problem
from nmpc_tpu_torch.core.types import DDPConfig, DDPResult, DDPStatus, DDPTrace
from nmpc_tpu_torch.kernels.ddp_backward import (StackedDerivs, StackedSecond,
                                                 backward_stacked)
from nmpc_tpu_torch.kernels.ddp_backward_fused import (backward_fused,
                                                       kernel_supports)

_RUNNING = int(DDPStatus.RUNNING)


def _check_ported(config: DDPConfig):
    """Raise for the configurations this port does not run yet."""
    if config.with_input_constraint:
        raise NotImplementedError(
            "with_input_constraint=True (boxed DDP) is not ported yet: "
            "ROADMAP A6 (its kernel is B4)")
    if config.ls_mode == "serial":
        raise NotImplementedError(
            "ls_mode='serial' is not ported yet: ROADMAP A4 (after A9)")
    if config.backward_impl == "remat":
        raise NotImplementedError(
            "backward_impl='remat' is not ported yet: ROADMAP B3")
    if config.forward_impl == "fused":
        raise NotImplementedError(
            "forward_impl='fused' is not ported yet: ROADMAP B2")


class DDPSolver:
    """Problem + config bound into batched solve functions.

    ``config.print_level`` is carried for config parity and not acted on
    yet (ROADMAP A12)."""

    def __init__(self, problem: Problem, config: DDPConfig = DDPConfig()):
        _check_ported(config)
        self.problem = problem
        self.config = config
        self.host_syncs = 0   # host reads of device values, last solve

    def solve_batch(self, t0, x0s, us_inits) -> DDPResult:
        """Batched solve: x0s [B, nx], us_inits [B, N, nu]; the result
        carries a leading batch axis."""
        res, self.host_syncs = _solve_stacked(self.problem, self.config, t0,
                                              x0s, us_inits)
        return res

    def solve(self, t0, x0, us_init) -> DDPResult:
        """One solve (reference ``DDPSolver::solve``): ``solve_batch`` at
        B=1, squeezed."""
        N, nu = self.config.horizon_steps, self.problem.input_dim
        if tuple(us_init.shape) != (N, nu):
            raise ValueError(f"initial_u_list must have shape {(N, nu)}, "
                             f"got {tuple(us_init.shape)}")
        res = self.solve_batch(t0, x0[None], us_init[None])
        first = lambda a: a[0]
        return DDPResult(
            **{f.name: first(getattr(res, f.name))
               for f in dataclasses.fields(res) if f.name != "trace"},
            trace=DDPTrace(**{f.name: first(getattr(res.trace, f.name))
                              for f in dataclasses.fields(res.trace)}))


# --------------------------------------------------------------------------
# batch-minor building blocks
# --------------------------------------------------------------------------


def _lanes(f, n_array_args: int):
    """vmap ``f(t, *arrays)`` over the trailing batch axis of the arrays."""
    return func.vmap(f, in_dims=(None,) + (-1,) * n_array_args, out_dims=-1)


def _step_lanes(problem):
    """Batched (next state, running cost) of one stage: one vmapped call
    per stage instead of two."""
    return _lanes(lambda t, x, u: (problem.dynamics(t, x, u),
                                   problem.running_cost(t, x, u)), 2)


def _deriv_dtype_of(config: DDPConfig, dtype):
    if config.deriv_dtype == "same":
        return dtype
    return getattr(torch, config.deriv_dtype)


def _stage_times(problem, t0, N):
    return t0 + problem.dt * torch.arange(N, dtype=t0.dtype, device=t0.device)


def _stage_derivs(problem: Problem, config: DDPConfig, t, x, u):
    """One stage's derivatives at the solve dtype: (Fx, Fu, Lx, Lu, Lxx,
    Luu, Lxu) plus (Fxx, Fuu, Fxu) for full DDP.  The callbacks run at
    ``deriv_dtype``; results are cast back at the boundary so wide model
    constants do not promote the solve."""
    dtype = x.dtype
    ddt = _deriv_dtype_of(config, dtype)
    td, xd, ud = t.to(ddt), x.to(ddt), u.to(ddt)
    Fx, Fu = (a.to(dtype) for a in problem.linearize_dynamics(td, xd, ud))
    Lx, Lu, Lxx, Luu, Lxu = (
        a.to(dtype) for a in problem.quadraticize_running_cost(td, xd, ud))
    second = ()
    if config.use_state_eq_second_derivative:
        second = tuple(a.to(dtype)
                       for a in problem.second_order_dynamics(td, xd, ud))
    if problem.input_mask is not None:
        # Masked-dimension embedding: zero the inactive columns and put a
        # unit diagonal on the inactive Luu block, so inactive inputs get
        # k = 0 and zero K rows (reference DDPSolver.hpp:513-517).
        mask = problem.input_mask(t).to(dtype)
        Fu = Fu * mask[None, :]
        Lu = Lu * mask
        Luu = Luu * (mask[:, None] * mask[None, :]) + torch.diag_embed(1.0 - mask)
        Lxu = Lxu * mask[None, :]
        if second:
            Fxx, Fuu, Fxu = second
            second = (Fxx, Fuu * (mask[None, :, None] * mask[None, None, :]),
                      Fxu * mask[None, None, :])
    return (Fx, Fu, Lx, Lu, Lxx, Luu, Lxu) + second


def _terminal_quad_lanes(problem, config, t0, xs):
    """Terminal cost expansion: (Vx_T [nx, B], Vxx_T [nx, nx, B])."""
    N = config.horizon_steps
    dtype = xs.dtype
    ddt = _deriv_dtype_of(config, dtype)
    quad = _lanes(problem.quadraticize_terminal_cost, 1)
    Vx_T, Vxx_T = quad((t0 + N * problem.dt).to(ddt), xs[-1].to(ddt))
    return Vx_T.to(dtype), Vxx_T.to(dtype)


def _derivative_sweep_lanes(problem, config, t0, xs, us):
    """Stage derivatives of the whole horizon, batch-minor and contiguous
    (every field [N, dims..., B]), plus the terminal expansion.

    One ``vmap`` over N of a ``vmap`` over B with ``out_dims=-1`` produces
    the batch-minor layout directly; ``contiguous()`` then copies it into
    the dense layout the CUDA kernel reads."""
    ts = _stage_times(problem, t0, config.horizon_steps)
    per_lane = _lanes(
        lambda t, x, u: _stage_derivs(problem, config, t, x, u), 2)
    D = func.vmap(per_lane, in_dims=(0, 0, 0), out_dims=0)(ts, xs[:-1], us)
    D = tuple(a.contiguous() for a in D)
    Vx_T, Vxx_T = _terminal_quad_lanes(problem, config, t0, xs)
    return D, Vx_T.contiguous(), Vxx_T.contiguous()


def _rollout_lanes(problem, config, t0, x0, us):
    """Initial rollout (``DDPSolver.hpp:87-95``): x0 [nx, B], us [N, nu, B]
    -> (xs [N+1, nx, B], costs [N+1, B])."""
    N = config.horizon_steps
    dtype = x0.dtype
    ts = _stage_times(problem, t0, N)
    step = _step_lanes(problem)
    xs, cs = [x0], []
    for i in range(N):
        xn, c = step(ts[i], xs[-1], us[i])
        # boundary casts: wide model constants must not promote the solve
        xs.append(xn.to(dtype))
        cs.append(c.to(dtype))
    term = _lanes(problem.terminal_cost, 1)
    cs.append(term(t0 + N * problem.dt, xs[-1]).to(dtype))
    return torch.stack(xs), torch.stack(cs)


def _ls_cost_dtype(problem, config, t0, xs, us):
    """Accumulator dtype of the line-search cost sums: the running cost's
    output dtype (evaluated on one sample), widened by ``deriv_dtype``."""
    cdtype = problem.running_cost(t0, xs[0, :, 0], us[0, :, 0]).dtype
    return torch.promote_types(cdtype, _deriv_dtype_of(config, xs.dtype))


def _forward_costs_lanes(problem, config, t0, xs, us, ks, Ks, alphas,
                         cdtype):
    """Cost-only line-search rollout of every alpha at once
    (``DDPSolver.hpp:242-265,537-560``).  The state carry is laid out
    [nx, A, B] so that the alpha and batch axes merge into one vmapped axis
    without a copy.  Returns per-alpha total costs [A, B]."""
    N = config.horizon_steps
    dtype = xs.dtype
    nx, B = xs.shape[1], xs.shape[2]
    A = alphas.shape[0]
    ts = _stage_times(problem, t0, N)
    step = _step_lanes(problem)
    a_bc = alphas[None, :, None]                          # [1, A, 1]
    x = xs[0][:, None, :].expand(nx, A, B)
    ctot = torch.zeros((A, B), dtype=cdtype, device=xs.device)
    for i in range(N):
        dx = x - xs[i][:, None, :]                        # [nx, A, B]
        u = (us[i][:, None, :] + a_bc * ks[i][:, None, :]
             + torch.sum(Ks[i][:, :, None, :] * dx[None], dim=1))
        xn, c = step(ts[i], x.reshape(nx, A * B), u.reshape(-1, A * B))
        x = xn.to(dtype).reshape(nx, A, B)
        ctot = ctot + c.to(cdtype).reshape(A, B)
    term = _lanes(problem.terminal_cost, 1)
    c_term = term(t0 + N * problem.dt, x.reshape(nx, A * B)).to(cdtype)
    return ctot + c_term.reshape(A, B)


def _forward_selected_lanes(problem, config, t0, xs, us, ks, Ks, alpha,
                            cdtype):
    """Rollout at each lane's selected alpha [B]: (xs [N+1,nx,B],
    us [N,nu,B], costs [N+1,B], cost_sum [B] in cdtype).  ``cost_sum`` is
    accumulated in horizon order exactly like the per-alpha sums of
    :func:`_forward_costs_lanes`, so the alpha[0] accept decision is the
    same in every ``ls_mode``."""
    N = config.horizon_steps
    dtype = xs.dtype
    ts = _stage_times(problem, t0, N)
    step = _step_lanes(problem)
    x = xs[0]
    ctot = torch.zeros(xs.shape[-1:], dtype=cdtype, device=xs.device)
    xs_new, us_new, cs = [x], [], []
    for i in range(N):
        u = (us[i] + alpha[None] * ks[i]
             + torch.sum(Ks[i] * (x - xs[i])[None], dim=1))
        xn, c_raw = step(ts[i], x, u)
        x = xn.to(dtype)
        ctot = ctot + c_raw.to(cdtype)
        xs_new.append(x)
        us_new.append(u)
        cs.append(c_raw.to(dtype))
    c_term = _lanes(problem.terminal_cost, 1)(t0 + N * problem.dt, x)
    cs.append(c_term.to(dtype))
    return (torch.stack(xs_new), torch.stack(us_new), torch.stack(cs),
            ctot + c_term.to(cdtype))


def _resolve_backward_impl(config: DDPConfig, problem: Problem, dtype,
                           device, boxed: bool, second: bool) -> str:
    """Backward-pass choice for the batched solve; the one place holding
    the ``auto`` rule.

    ``auto`` resolves to:
      * ``"pallas"`` (the fused CUDA kernel) on CUDA tensors, for a
        first-order, unboxed solve whose ``(nx, nu)`` and dtype the kernel
        was built for (``ddp_backward_fused.kernel_supports``);
      * ``"stacked"`` (the torch-op recursion) otherwise.
    The JAX rule's ``B % 128 == 0`` and TPU-backend conditions do not carry
    over: the kernel takes any B.  ``forward_impl="auto"`` resolves to the
    plain rollout until the fused forward kernel is ported (ROADMAP B2).

    An explicit ``"pallas"`` is taken as asked: a second-order or boxed
    solve, which the kernel does not compute, raises instead of running
    the twin.
    """
    impl = config.backward_impl
    if impl == "pallas" and (boxed or second):
        raise NotImplementedError(
            "backward_impl='pallas' (the fused backward kernel) is "
            "first-order and unboxed; the second-order D2 term and the "
            "boxed backward run on backward_impl='stacked': ROADMAP B1 "
            "(boxed: B4)")
    if impl != "auto":
        return impl
    if (device.type == "cuda" and not boxed and not second
            and kernel_supports(problem.state_dim, problem.input_dim, dtype)):
        return "pallas"
    return "stacked"


def _make_backward_fn(config: DDPConfig, impl: str, Dst, VxT, VxxT, D2=None):
    """Bind the chosen backward to its derivative data:
    ``backward_fn(lam) -> (ks, Ks, dV, ok)``, batch-minor."""
    if impl == "pallas":
        return lambda lam: backward_fused(config, Dst, VxT, VxxT, lam)
    return lambda lam: backward_stacked(config, Dst, VxT, VxxT, lam, D2=D2)


def _backward_retry(config, backward_fn, lam, dlam, ks0, Ks0, running, host):
    """Per-lane lambda-retry loop around a bound backward
    (``DDPSolver.hpp:191-209``): a lane whose backward fails raises its own
    lambda and retries; lanes that are not running are frozen.  ``host``
    reads a device flag (one sync per pass)."""
    lf = config.lambda_factor
    ks, Ks, dV, ok = backward_fn(lam)
    ok_all = ok | ~running
    ks = torch.where(ok, ks, ks0)
    Ks = torch.where(ok, Ks, Ks0)
    failed = torch.zeros_like(ok)
    n = 0
    while (n < config.max_backward_retries
           and host(torch.any(~ok_all & ~failed))):
        retry = ~ok_all & ~failed
        dlam_n = torch.clamp(dlam * lf, min=lf)
        lam_n = torch.clamp(lam * dlam_n, min=config.lambda_min)
        dlam = torch.where(retry, dlam_n, dlam)
        lam = torch.where(retry, lam_n, lam)
        failed = failed | (retry & (lam > config.lambda_max))
        ks2, Ks2, dV2, ok2 = backward_fn(lam)
        take = retry & ~failed & ok2
        ks = torch.where(take, ks2, ks)
        Ks = torch.where(take, Ks2, Ks)
        dV = torch.where(take, dV2, dV)
        ok_all = ok_all | take
        n += 1
    return lam, dlam, ks, Ks, dV, failed


def _ratio(actual, expected):
    """Actual/expected cost reduction; sign(actual) when expected < 0
    (``DDPSolver.hpp:251-259``)."""
    one = torch.ones_like(actual)
    return torch.where(expected < 0, torch.where(actual >= 0, one, -one),
                       actual / expected)


# --------------------------------------------------------------------------
# the batched solve
# --------------------------------------------------------------------------


def _solve_stacked(problem: Problem, config: DDPConfig, t0, x0s, us_init):
    """Batched DDP solve.  Returns (DDPResult, host syncs).

    Per-lane control flow reproduces the JAX ``_solve_stacked`` exactly:
    finished lanes are frozen, and status transitions fire only from
    RUNNING."""
    dtype, device = x0s.dtype, x0s.device
    B = x0s.shape[0]
    N = config.horizon_steps
    nx, nu = problem.state_dim, problem.input_dim
    if tuple(us_init.shape) != (B, N, nu):
        raise ValueError(f"initial_u_list must have shape {(B, N, nu)}, "
                         f"got {tuple(us_init.shape)}")
    n_syncs = 0

    def host(flag):
        nonlocal n_syncs
        n_syncs += 1
        return bool(flag)

    t0 = torch.as_tensor(t0, dtype=dtype, device=device)
    n_trace = config.max_iter + 1
    alphas = torch.tensor(config.alpha_list, dtype=dtype, device=device)
    A = len(config.alpha_list)
    second = config.use_state_eq_second_derivative
    impl = _resolve_backward_impl(config, problem, dtype, device,
                                  config.with_input_constraint, second)
    wdtype = torch.promote_types(dtype, _deriv_dtype_of(config, dtype))
    thre = config.cost_update_ratio_thre
    hyst = max(1, config.ls_auto_hysteresis)

    us = us_init.permute(1, 2, 0).contiguous()            # [N, nu, B]
    xs, costs = _rollout_lanes(problem, config, t0, x0s.T.contiguous(), us)
    cdtype = _ls_cost_dtype(problem, config, t0, xs, us)

    def f_costs(ks, Ks, alphas_):
        return _forward_costs_lanes(problem, config, t0, xs, us, ks, Ks,
                                    alphas_, cdtype)

    def f_sel(ks, Ks, alpha):
        return _forward_selected_lanes(problem, config, t0, xs, us, ks, Ks,
                                       alpha, cdtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    trace = DDPTrace(
        iter=torch.arange(n_trace, dtype=torch.int32,
                          device=device).repeat(B, 1),
        cost=zeros(B, n_trace), lam=zeros(B, n_trace),
        dlam=zeros(B, n_trace), alpha=zeros(B, n_trace),
        k_rel_norm=zeros(B, n_trace), cost_update_actual=zeros(B, n_trace),
        cost_update_expected=zeros(B, n_trace),
        cost_update_ratio=zeros(B, n_trace))
    trace.cost[:, 0] = costs.sum(0)
    trace.lam[:, 0] = config.initial_lambda
    trace.dlam[:, 0] = config.initial_dlambda

    iters = torch.zeros((B,), dtype=torch.int32, device=device)
    status = torch.full((B,), _RUNNING, dtype=torch.int32, device=device)
    ks, Ks = zeros(N, nu, B), zeros(N, nu, nx, B)
    lam = torch.full((B,), config.initial_lambda, dtype=dtype, device=device)
    dlam = torch.full((B,), config.initial_dlambda, dtype=dtype,
                      device=device)
    # the adaptive line search's predictor state: consecutive iterations in
    # which every running lane accepted alpha[0] (optimistic start)
    ls_consec = hyst

    it = 0
    while host(torch.any(status == _RUNNING)):
        it += 1
        running = status == _RUNNING

        # Steps 1+2: derivative sweep, backward pass with lambda retry.
        D, VxT, VxxT = _derivative_sweep_lanes(problem, config, t0, xs, us)
        D2 = StackedSecond(*D[7:]) if second else None
        backward_fn = _make_backward_fn(config, impl, StackedDerivs(*D[:7]),
                                        VxT, VxxT, D2=D2)
        lam_b, dlam_b, ks_b, Ks_b, dV, bw_failed = _backward_retry(
            config, backward_fn, lam, dlam, ks, Ks, running, host)
        new_status = torch.where(bw_failed & running,
                                 int(DDPStatus.FAIL_BACKWARD_LAMBDA), status)

        # small-gradient termination (DDPSolver.hpp:217-231)
        k_rel_norm = torch.amax(
            torch.sqrt(torch.sum(ks_b**2, dim=1))
            / (torch.sqrt(torch.sum(us**2, dim=1)) + 1.0), dim=0)   # [B]
        term_grad = (running & ~bw_failed
                     & (k_rel_norm < config.k_rel_norm_thre)
                     & (lam_b < config.lambda_thre))
        new_status = torch.where(term_grad, int(DDPStatus.SUCCEEDED),
                                 new_status)

        # Step 3: forward line search, the reference's first-accept
        # decision (DDPSolver.hpp:242-265) in every ls_mode.
        cost_old = costs.sum(0)                                    # [B]
        expected = -alphas[:, None] * (dV[0][None, :]
                                       + alphas[:, None] * dV[1][None, :])
        do_forward = running & ~bw_failed & ~term_grad

        def pick_alpha(cand_sums):
            """First accepted alpha per lane from per-alpha sums [A, B]."""
            actual = cost_old[None, :] - cand_sums
            ratio = _ratio(actual, expected)
            accept_mask = ratio > thre
            fw_success = torch.any(accept_mask, dim=0)
            first_idx = torch.argmax(accept_mask.to(torch.uint8), dim=0)
            idx = torch.where(fw_success, first_idx, A - 1)
            sel = lambda a: torch.gather(a, 0, idx[None, :])[0]
            all_a0 = ~torch.any(do_forward & ~accept_mask[0])
            return (idx, fw_success, sel(actual).to(wdtype), sel(expected),
                    sel(ratio).to(wdtype), all_a0)

        def sweep_path():
            out = pick_alpha(f_costs(ks_b, Ks_b, alphas))
            return f_sel(ks_b, Ks_b, alphas[out[0]])[:3] + out

        def head_path():
            h_xs, h_us, h_costs, sum0 = f_sel(
                ks_b, Ks_b, alphas[0].expand(B))
            actual0 = (cost_old - sum0).to(wdtype)
            ratio0 = _ratio(actual0, expected[0].to(wdtype))
            accept0 = ratio0 > thre
            if host(~torch.any(do_forward & ~accept0)):
                idx = torch.zeros((B,), dtype=torch.long, device=device)
                return (h_xs, h_us, h_costs, idx, accept0, actual0,
                        expected[0], ratio0, True)
            rest = f_costs(ks_b, Ks_b, alphas[1:])
            out = pick_alpha(torch.cat([sum0[None].to(rest.dtype), rest]))
            return (f_sel(ks_b, Ks_b, alphas[out[0]])[:3] + out[:-1]
                    + (False,))

        if A <= 1 or config.ls_mode == "head":
            ls_out = head_path()
        elif config.ls_mode == "sweep":
            ls_out = sweep_path()
        else:   # "auto": accept-history hysteresis carried across iterations
            ls_out = head_path() if ls_consec >= hyst else sweep_path()
            all_a0 = ls_out[-1]
            if isinstance(all_a0, torch.Tensor):
                all_a0 = host(all_a0)
            ls_consec = min(ls_consec + 1, hyst) if all_a0 else 0
        (sel_xs, sel_us, sel_costs, idx, fw_success, actual_sel,
         expected_sel, ratio_sel, _) = ls_out

        # Step 4: accept / reject and the lambda schedule
        # (DDPSolver.hpp:280-333).
        accept = do_forward & fw_success
        xs = torch.where(accept, sel_xs, xs)
        us = torch.where(accept, sel_us, us)
        costs = torch.where(accept, sel_costs, costs)
        new_status = torch.where(accept & (actual_sel < config.cost_update_thre),
                                 int(DDPStatus.SUCCEEDED), new_status)

        lf = config.lambda_factor
        dlam_acc = torch.clamp(dlam_b / lf, max=1.0 / lf)
        lam_acc = torch.where(lam_b >= config.lambda_min, lam_b * dlam_acc,
                              torch.zeros_like(lam_b))
        dlam_rej = torch.clamp(dlam_b * lf, min=lf)
        lam_rej = torch.clamp(lam_b * dlam_rej, min=config.lambda_min)
        reject = do_forward & ~fw_success
        lam = torch.where(accept, lam_acc, torch.where(reject, lam_rej, lam_b))
        dlam = torch.where(accept, dlam_acc,
                           torch.where(reject, dlam_rej, dlam_b))
        new_status = torch.where(reject & (lam > config.lambda_max),
                                 int(DDPStatus.FAIL_FORWARD_LAMBDA),
                                 new_status)

        # gains kept from the last successful backward
        good_bw = running & ~bw_failed
        ks = torch.where(good_bw, ks_b, ks)
        Ks = torch.where(good_bw, Ks_b, Ks)

        # trace column `it`, written for the lanes that reached each field
        def trow(col, val, mask):
            col[:, it] = torch.where(mask, val.to(col.dtype), col[:, it])

        trow(trace.cost, costs.sum(0), do_forward)
        trow(trace.lam, lam, do_forward)
        trow(trace.dlam, dlam, do_forward)
        trow(trace.alpha, alphas[idx], do_forward)
        trow(trace.k_rel_norm, k_rel_norm, good_bw)
        trow(trace.cost_update_actual, actual_sel, do_forward)
        trow(trace.cost_update_expected, expected_sel, do_forward)
        trow(trace.cost_update_ratio, ratio_sel, do_forward)

        if it >= config.max_iter:
            new_status = torch.where(new_status == _RUNNING,
                                     int(DDPStatus.MAX_ITER_REACHED),
                                     new_status)
        # Every update above is masked to running lanes (accept, reject,
        # do_forward and good_bw all imply running; the retry loop freezes
        # the others), so finished lanes stay frozen.
        iters = torch.where(running, iters + 1, iters)
        status = new_status

    batch_first = lambda a: torch.movedim(a, -1, 0).contiguous()
    result = DDPResult(
        status=status,
        success=status == int(DDPStatus.SUCCEEDED),
        iters=iters,
        xs=batch_first(xs),
        us=batch_first(us),
        costs=batch_first(costs),
        ks=batch_first(ks),
        Ks=batch_first(Ks),
        lam=lam,
        dlam=dlam,
        trace=trace,
    )
    return result, n_syncs
