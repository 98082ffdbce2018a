"""DDP / iLQG trajectory optimizer, batched, in PyTorch.

Port of the batched path of ``nmpc_tpu/solvers/ddp.py`` (``_solve_stacked``;
reference ``nmpc_ddp/include/nmpc_ddp/DDPSolver.hpp``): Levenberg-Marquardt
regularized backward Riccati recursion with per-lane lambda retry,
all-alphas line search with the reference's first-accept decision, the
reference's termination tests, per-lane status and trace rows.  With
``with_input_constraint`` the backward pass solves a box-constrained QP
per stage (``DDPSolver.hpp:450-497``) on the problem's ``input_limits``.

Layout: every internal quantity is batch-minor, ``[..., B]``, as in the
JAX package; the public layout is batch-first.  The JAX package's
``(S, 128)`` lane blocking is TPU-only and is replaced by a flat trailing
``B``.  The problem's per-instance callables are batched with
``torch.func.vmap``.

Host control flow: the JAX ``lax.while_loop`` / ``lax.cond`` constructs
become Python control flow that reads a device value (one host sync) at
each decision: the iteration loop's any-lane-running test, each pass of
the backward retry loop, the head path's tail test, in ``ls_mode``
"auto" the hysteresis predictor's accept-all-alpha[0] flag, in
``ls_mode`` "serial" each trip of the alpha loop and, on the plain boxed
backward, each trip of the QP's iteration and Armijo loops.
``DDPSolver.host_syncs`` holds the count for the last solve.  The
``print_level`` diagnostics of the JAX single solve
(``nmpc_tpu/solvers/ddp.py:491-505``) come from ``DDPSolver.solve``
only; a message read counts as a host sync, and level 0 reads nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from nmpc_tpu_torch.core.problem import Problem
from nmpc_tpu_torch.core.types import DDPConfig, DDPResult, DDPStatus, DDPTrace
from nmpc_tpu_torch.kernels import tileval
from nmpc_tpu_torch.kernels.ddp_backward import (StackedBounds,
                                                 StackedDerivs, StackedSecond,
                                                 backward_stacked,
                                                 backward_stacked_boxed)
from nmpc_tpu_torch.kernels.ddp_backward_boxed import (backward_fused_boxed,
                                                       boxed_kernel_supports)
from nmpc_tpu_torch.kernels.ddp_backward_fused import (DMA_MODES,
                                                       backward_fused,
                                                       kernel_supports)
from nmpc_tpu_torch.kernels.ddp_backward_remat import (MAX_NU_BOXED,
                                                       backward_remat,
                                                       remat_supported)
from nmpc_tpu_torch.kernels.ddp_forward_remat import (
    forward_costs_remat, forward_remat_supported, forward_selected_remat)
from nmpc_tpu_torch.solvers.stages import (
    _deriv_dtype_of, _derivative_sweep_lanes, _forward_costs_lanes,
    _forward_selected_lanes, _lanes, _stage_times, _step_lanes,
    _terminal_quad_lanes)
from nmpc_tpu_torch.utils.logging import log, log_when
from nmpc_tpu_torch.utils.timing import phase

_RUNNING = int(DDPStatus.RUNNING)


class HostReads:
    """The solve's counted host reads of device values: ``host(flag)``
    reads a bool, ``host.item(value)`` a scalar; ``n`` counts both.
    ``ls_trips`` holds the serial line search's alpha trips of each
    iteration."""

    def __init__(self):
        self.n = 0
        self.ls_trips = []

    def __call__(self, flag) -> bool:
        self.n += 1
        return bool(flag)

    def item(self, value):
        if not isinstance(value, torch.Tensor):
            return value
        self.n += 1
        return value.item()


class DDPSolver:
    """Problem + config bound into batched solve functions.

    ``backward_dma`` picks the sweep-fed CUDA kernel where the resolved
    backward is ``"pallas"`` and the solve is unboxed: ``"stage"`` (K1),
    ``"chunked"`` (K2) or ``"packed"`` (K3, after a pack of the stage
    fields), each at every shape K1 takes (nx <= 9, nu <= 16: the
    centroidal model's (9, 16) on the wide stage); the JAX package's
    ``packed=`` argument and ``NMPC_PALLAS_DMA`` switch
    (``nmpc_tpu/kernels/ddp_backward_pallas.py:1204-1234``).  The three
    compute the same numbers, bit for bit on the card.  ``ls_trips``
    holds, for the last solve with ``ls_mode="serial"``, the alpha trips
    of each iteration."""

    def __init__(self, problem: Problem, config: DDPConfig = DDPConfig(),
                 backward_dma: str = "stage"):
        if backward_dma not in DMA_MODES:
            raise ValueError(f"backward_dma must be one of {DMA_MODES}, got "
                             f"{backward_dma!r}")
        if backward_dma != "stage" and config.with_input_constraint:
            raise ValueError(f"backward_dma={backward_dma!r}: the chunked and "
                             "packed kernels are unboxed, as in the JAX "
                             "package; a boxed solve takes 'stage'")
        self.problem = problem
        self.config = config
        self.backward_dma = backward_dma
        self.host_syncs = 0   # host reads of device values, last solve
        self.ls_trips = []

    def _run(self, t0, x0s, us_inits, timer=None, single=False):
        host = HostReads()
        res = _solve_stacked(self.problem, self.config, t0, x0s, us_inits,
                             self.backward_dma, host=host, timer=timer,
                             single=single)
        self.host_syncs, self.ls_trips = host.n, host.ls_trips
        return res

    def solve_batch(self, t0, x0s, us_inits) -> DDPResult:
        """Batched solve: x0s [B, nx], us_inits [B, N, nu]; the result
        carries a leading batch axis."""
        return self._run(t0, x0s, us_inits)

    def solve(self, t0, x0, us_init, timer=None) -> DDPResult:
        """One solve (reference ``DDPSolver::solve``): ``solve_batch`` at
        B=1, squeezed, with the ``print_level`` diagnostics; ``timer``
        (``utils/timing.py::PhaseTimer``) records its phases."""
        N, nu = self.config.horizon_steps, self.problem.input_dim
        if tuple(us_init.shape) != (N, nu):
            raise ValueError(f"initial_u_list must have shape {(N, nu)}, "
                             f"got {tuple(us_init.shape)}")
        res = self._run(t0, x0[None], us_init[None], timer=timer,
                        single=True)
        first = lambda a: a[0]
        return DDPResult(
            **{f.name: first(getattr(res, f.name))
               for f in dataclasses.fields(res) if f.name != "trace"},
            trace=DDPTrace(**{f.name: first(getattr(res.trace, f.name))
                              for f in dataclasses.fields(res.trace)}))


# --------------------------------------------------------------------------
# batch-minor building blocks (the per-stage ones are in solvers/stages.py)
# --------------------------------------------------------------------------


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


def _resolve_backward_impl(config: DDPConfig, problem: Problem, dtype,
                           device, boxed: bool, second: bool,
                           dma: str = "stage") -> str:
    """Backward-pass choice for the batched solve; the one place holding
    the ``auto`` rule.

    ``auto`` resolves, on CUDA tensors and for a first-order solve, to:
      * ``"remat"`` (the trajectory-fed CUDA kernel, no derivative sweep)
        when ``deriv_dtype`` is ``"same"`` and the code generator takes
        the problem at this dtype (``remat_supported``; boxed: its limits
        and mask too, the aux group);
      * else ``"pallas"``, the sweep-fed CUDA kernel, its unit built on
        demand: unboxed, the kernel of the solve's ``dma``
        (``DDPSolver``'s ``backward_dma``: K1, K2 or K3) within its limits
        (``kernel_supports(nx, nu, dtype, dma)``: nx <= 9, nu <= 16,
        float32/float64 in every mode), so every first-order problem the
        generator rejects (the bipedal model; the centroidal model, whose
        ``torch.linalg.cross`` it does not take) runs a kernel; boxed
        (K4) within its limits (``boxed_kernel_supports``: its wide
        unit up to (9, 16) where the Armijo schedule fits its step table,
        ``armijo_steps(config.boxqp, dtype) <= 512``, its one-group unit
        at nu <= 4, float32/float64);
    and to ``"stacked"`` (the torch-op recursion) otherwise, on CPU
    tensors always.  The JAX rule sends a boxed solve with nu > 4 to the
    stacked path (``nmpc_tpu/solvers/ddp.py:747-752``); on the H100 the
    stacked BoxQP reads the host once per QP and Armijo trip of every
    stage, and the boxed centroidal solve (nu = 16) takes K4's wide unit
    instead (``chip_smoke.py`` on an NVIDIA H100 80GB HBM3, 700.00 W,
    PERF.md): at B=256, N=12, 3 iterations 0.19 s (fp32) and 0.21 s
    (fp64) with 10 host syncs, against the plain path's 4.03 and 3.66 s
    with 1,707 and 892; at N=100 1.49 and 1.04 s, where a plain solve had
    not ended after 15 minutes (its backward alone: 207.0 s, fp32).
    The JAX rule's ``B % 128 == 0`` and ``B >= 1024`` conditions were fit
    to the TPU's (8, 128) blocks and do not carry over: on the H100 the
    remat pair is the fastest at both shapes the port serves
    (``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md):
    18586.3 solves/s at B=4096, N=100 (remat + fused) against
    8032.8 (pallas + fused) and 2126.1 (pallas + scan); tick p50 236.43 ms
    at 256 controllers, N=200 (remat + fused) against 366.38 and 1759.31
    ms.

    An explicit ``"pallas"`` or ``"remat"`` is taken as asked: a
    second-order solve, which the kernels do not compute, raises, and so
    does ``"remat"`` on a boxed solve with nu > 4 (``MAX_NU_BOXED``), on a
    problem the generator rejects (``TileEvalError``) or with
    ``deriv_dtype`` other than ``"same"``; ``"pallas"`` at a shape its
    kernel does not take raises at its launch on the card; nothing runs
    the plain version in a kernel's place.
    """
    impl = config.backward_impl
    nx, nu = problem.state_dim, problem.input_dim
    if impl in ("pallas", "remat") and second:
        raise NotImplementedError(
            f"backward_impl={impl!r} (a fused backward kernel) is "
            "first-order; the second-order D2 term runs on "
            "backward_impl='stacked': ROADMAP B1")
    if impl == "remat" and boxed and nu > MAX_NU_BOXED:
        raise NotImplementedError(
            f"backward_impl='remat': the boxed remat kernel takes nu <= "
            f"{MAX_NU_BOXED}; nu={nu} runs on backward_impl='pallas' (K4) "
            f"or 'stacked': ROADMAP B7")
    if impl == "remat":
        if config.deriv_dtype != "same":
            raise ValueError("backward_impl='remat' evaluates the "
                             "derivatives at the solve dtype: deriv_dtype "
                             "must be 'same'")
        tileval.generate(problem, "remat_boxed" if boxed else "remat", nx,
                         nu, dtype)
        return impl
    if impl != "auto":
        return impl
    if device.type == "cuda" and not second:
        if (config.deriv_dtype == "same"
                and remat_supported(problem, nx, nu, dtype, boxed)):
            return "remat"
        if (boxed_kernel_supports(nx, nu, dtype, config.boxqp) if boxed
                else kernel_supports(nx, nu, dtype, dma)):
            return "pallas"
    return "stacked"


def _resolve_forward_impl(config: DDPConfig, problem: Problem, dtype,
                          device, cdtype) -> str:
    """Line-search rollout choice: ``"fused"`` (the CUDA rollout kernels,
    ``kernels/ddp_forward_remat.py``) or ``"scan"`` (the plain rollouts).

    The kernels sum the costs at the solve dtype, so both ``"fused"`` and
    ``auto`` need ``cdtype == dtype`` (as the JAX solver does).  They serve
    masked and boxed problems unchanged: the rollout does not read the
    mask (an inactive input has k = 0 and a zero K row, so it keeps its
    value), as in the JAX kernels.  ``auto``
    takes ``"fused"`` on CUDA tensors where the generator takes the
    problem (``forward_remat_supported``) and ``"scan"`` otherwise.  The
    JAX window (N >= 25 and (B <= 512 or N >= 50)) was fit on the TPU;
    on the H100 the fused rollouts replace host loops over N and win at
    both shapes (same run as ``_resolve_backward_impl``'s numbers: K6
    0.0485 ms against 106.0 ms for the plain rollout, K7 0.0402 ms
    against 115.4 ms, at B=4096, N=100), so no window is kept.  An
    explicit ``"fused"`` on a problem the generator rejects raises
    ``TileEvalError``; with ``cdtype != dtype`` it raises ``ValueError``.
    """
    impl = config.forward_impl
    nx, nu = problem.state_dim, problem.input_dim
    if impl == "fused":
        tileval.generate(problem, "forward", nx, nu, dtype)
        if cdtype != dtype:
            raise ValueError(
                f"forward_impl='fused' sums the line-search costs at the "
                f"solve dtype {dtype}; this solve sums them at {cdtype} "
                f"(deriv_dtype or the running cost's dtype)")
        return impl
    if (impl == "auto" and device.type == "cuda" and cdtype == dtype
            and forward_remat_supported(problem, nx, nu, dtype)):
        return "fused"
    return "scan"


def _make_backward_fn(config: DDPConfig, impl: str, Dst, VxT, VxxT,
                      bounds=None, D2=None, host=bool, dma="stage"):
    """Bind the chosen sweep-fed backward to its derivative data (and, for
    a boxed solve, its bounds): ``backward_fn(lam) -> (ks, Ks, dV, ok)``,
    batch-minor.  ``host`` reads the plain boxed QP's device flags;
    ``dma`` picks the unboxed kernel (``DDPSolver``)."""
    if bounds is not None:
        if impl == "pallas":
            return lambda lam: backward_fused_boxed(config, Dst, bounds, VxT,
                                                    VxxT, lam, host=host)
        return lambda lam: backward_stacked_boxed(
            config, Dst, bounds, VxT, VxxT, lam, D2=D2, host=host)
    if impl == "pallas":
        return lambda lam: backward_fused(config, Dst, VxT, VxxT, lam,
                                          dma=dma)
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


def _solve_stacked(problem: Problem, config: DDPConfig, t0, x0s, us_init,
                   backward_dma="stage", host=None, timer=None,
                   single=False):
    """Batched DDP solve; returns the DDPResult.  ``host`` (a
    :class:`HostReads`) counts the host reads.

    Per-lane control flow reproduces the JAX ``_solve_stacked`` exactly:
    finished lanes are frozen, and status transitions fire only from
    RUNNING.  ``timer`` (``utils/timing.py::PhaseTimer``) records the
    initial rollout (``"setup"``, row 0) and each iteration's derivative
    sweep, backward pass and line search (``"derivative"``,
    ``"backward"``, ``"forward"``, row ``it``); without it the solve adds
    no event and no synchronization.  ``single`` (B = 1, from
    ``DDPSolver.solve``) emits the ``print_level`` messages."""
    dtype, device = x0s.dtype, x0s.device
    B = x0s.shape[0]
    N = config.horizon_steps
    nx, nu = problem.state_dim, problem.input_dim
    if tuple(us_init.shape) != (B, N, nu):
        raise ValueError(f"initial_u_list must have shape {(B, N, nu)}, "
                         f"got {tuple(us_init.shape)}")
    host = HostReads() if host is None else host
    level = config.print_level if single else 0

    t0 = torch.as_tensor(t0, dtype=dtype, device=device)
    n_trace = config.max_iter + 1
    alphas = torch.tensor(config.alpha_list, dtype=dtype, device=device)
    A = len(config.alpha_list)
    second = config.use_state_eq_second_derivative
    boxed = config.with_input_constraint
    impl = _resolve_backward_impl(config, problem, dtype, device, boxed,
                                  second, backward_dma)
    wdtype = torch.promote_types(dtype, _deriv_dtype_of(config, dtype))
    thre = config.cost_update_ratio_thre
    hyst = max(1, config.ls_auto_hysteresis)

    us = us_init.permute(1, 2, 0).contiguous()            # [N, nu, B]
    with phase(timer, "setup", 0):
        xs, costs = _rollout_lanes(problem, config, t0, x0s.T.contiguous(),
                                   us)
    cdtype = _ls_cost_dtype(problem, config, t0, xs, us)
    fused = _resolve_forward_impl(config, problem, dtype, device,
                                  cdtype) == "fused"

    # The rollouts read the current (xs, us) through the closure.
    def f_costs(ks, Ks, alphas_):
        if fused:
            return forward_costs_remat(problem, config, t0, xs, us, ks, Ks,
                                       alphas_)
        return _forward_costs_lanes(problem, config, t0, xs, us, ks, Ks,
                                    alphas_, cdtype)

    def f_sel(ks, Ks, alpha):
        if fused:
            return forward_selected_remat(problem, config, t0, xs, us, ks,
                                          Ks, alpha.contiguous())
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
        # The remat kernel takes the trajectory: only the terminal
        # expansion is computed here, the stage derivatives in the kernel.
        with phase(timer, "derivative", it):
            if impl == "remat":
                VxT, VxxT = (a.contiguous() for a in _terminal_quad_lanes(
                    problem, config, t0, xs))
                xs_b, us_b = xs, us

                def backward_fn(lam_):
                    return backward_remat(problem, config, t0, xs_b, us_b,
                                          VxT, VxxT, lam_, boxed=boxed,
                                          host=host)
            else:
                D, VxT, VxxT = _derivative_sweep_lanes(problem, config, t0,
                                                       xs, us)
                D2 = StackedSecond(*D[7:10]) if second else None
                bounds = StackedBounds(*D[-3:]) if boxed else None
                backward_fn = _make_backward_fn(
                    config, impl, StackedDerivs(*D[:7]), VxT, VxxT,
                    bounds=bounds, D2=D2, host=host, dma=backward_dma)
        with phase(timer, "backward", it):
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

        def serial_path():
            """The reference's serial early-exit alpha loop
            (DDPSolver.hpp:242-265), batched as the JAX ``serial_path``
            (nmpc_tpu/solvers/ddp.py:1133-1192): each trip rolls out one
            alpha for every lane, trajectory included, and the lanes
            still searching take it on their first accept.  One host read
            a trip (the loop's test), and one that ends the loop."""
            ex_w = expected.to(wdtype)
            idx = torch.full((B,), A - 1, dtype=torch.long, device=device)
            accepted = torch.zeros((B,), dtype=torch.bool, device=device)
            sxs, sus, scosts = xs, us, costs
            act = torch.zeros((B,), dtype=wdtype, device=device)
            rat = torch.zeros_like(act)
            exp_ = torch.zeros((B,), dtype=dtype, device=device)
            k = 0
            while host(torch.any(do_forward & ~accepted)) and k < A:
                c_xs, c_us, c_costs, c_sum = f_sel(ks_b, Ks_b,
                                                   alphas[k].expand(B))
                actual_k = (cost_old - c_sum).to(wdtype)
                ratio_k = _ratio(actual_k, ex_w[k])
                rec = do_forward & ~accepted     # the lanes still searching
                sxs = torch.where(rec, c_xs, sxs)
                sus = torch.where(rec, c_us, sus)
                scosts = torch.where(rec, c_costs, scosts)
                act = torch.where(rec, actual_k, act)
                exp_ = torch.where(rec, expected[k], exp_)
                rat = torch.where(rec, ratio_k, rat)
                idx = torch.where(rec, k, idx)
                accepted = accepted | (rec & (ratio_k > thre))
                k += 1
            host.ls_trips.append(k)
            all_a0 = ~torch.any(do_forward & ~(accepted & (idx == 0)))
            return (sxs, sus, scosts, idx, accepted, act, exp_, rat, all_a0)

        with phase(timer, "forward", it):
            if A <= 1 or config.ls_mode == "head":
                ls_out = head_path()
            elif config.ls_mode == "sweep":
                ls_out = sweep_path()
            elif config.ls_mode == "serial":
                ls_out = serial_path()
            else:   # "auto": accept-history hysteresis across iterations
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

        if level:   # diagnostics (reference DDPSolver.hpp:106-109,198-207)
            log(level, 3, "[DDP] iter {it}: cost {cost:.6e} lambda "
                "{lam:.3e} alpha {alpha:.3e} k_rel_norm {krn:.3e}",
                read=host.item, it=it, cost=costs.sum(0)[0], lam=lam[0],
                alpha=alphas[idx][0], krn=k_rel_norm[0])
            log_when(level, 1, bw_failed[0], "[DDP/Warning] Failure in "
                     "backward pass: lambda exceeded lambda_max (iter {it})",
                     read=host.item, it=it)
            log_when(level, 1,
                     new_status[0] == int(DDPStatus.FAIL_FORWARD_LAMBDA),
                     "[DDP/Warning] Failure in forward pass: lambda exceeded "
                     "lambda_max (iter {it})", read=host.item, it=it)

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
    return result
