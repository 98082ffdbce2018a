"""Config, status and result types of the PyTorch port.

Configurations are frozen dataclasses, field for field with
``nmpc_tpu/core/types.py`` (same defaults, same validation), so a config
carries across the two packages unchanged (see ``nmpc_tpu_torch.convert``).
Results and traces are plain dataclasses of tensors.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class DDPStatus(enum.IntEnum):
    """Per-lane solve status (reference ``DDPSolver.hpp:116-144``)."""

    RUNNING = 0
    SUCCEEDED = 1            # small gradient or small cost update
    MAX_ITER_REACHED = 2     # loop exhausted (reference: solve() -> false)
    FAIL_BACKWARD_LAMBDA = 3  # lambda > lambda_max in backward retry loop
    FAIL_FORWARD_LAMBDA = 4   # lambda > lambda_max after rejected forward


@dataclasses.dataclass(frozen=True)
class DDPConfig:
    """DDP solver configuration (reference ``DDPSolver.h:47-110``).

    ``alpha_list`` is the reference's 11-point backtracking schedule
    10^0..10^-3; every alpha is evaluated at once and the first acceptable
    one is taken, which is the reference's serial first-accept decision.

    ``backward_impl`` selects the backward pass of the batched solve:

    - ``"stacked"``: the batch-minor torch-op recursion
      (``kernels/ddp_backward.py::backward_stacked``);
    - ``"pallas"``: the fused hand-written CUDA backward kernel
      (``kernels/ddp_backward_fused.py``, source ``csrc/ddp_backward.cu``).
      The name is kept from the JAX package, where it names the fused
      Pallas kernel, so a config carries across unchanged.  On CPU
      tensors it runs the plain twin;
    - ``"remat"``: the CUDA backward fed by the trajectory, which
      recomputes the stage derivatives in-kernel from code generated from
      the problem's callables (``kernels/ddp_backward_remat.py``); no
      derivative sweep.  On CPU tensors it runs its plain version; a
      problem the generator rejects raises ``TileEvalError``;
    - ``"auto"``: the rule in ``solvers/ddp.py::_resolve_backward_impl``.

    ``ls_mode`` ``"auto"|"head"|"sweep"|"serial"`` picks which alphas are
    evaluated (identical accept decisions in every mode): ``"serial"`` is
    the reference's early-exit loop, one alpha a trip for the lanes still
    searching.  ``print_level`` gates ``DDPSolver.solve``'s diagnostics
    (``utils/logging.py``).  ``forward_impl`` ``"scan"`` runs the plain rollouts, ``"fused"``
    the CUDA rollout kernels on generated dynamics and costs
    (``kernels/ddp_forward_remat.py``; plain versions on CPU tensors),
    ``"auto"`` the rule in ``solvers/ddp.py::_resolve_forward_impl``.
    """

    horizon_steps: int = 100
    max_iter: int = 500
    print_level: int = 0
    use_state_eq_second_derivative: bool = False
    with_input_constraint: bool = False
    reg_type: int = 1              # 1: Quu + lambda I, 2: Vxx + lambda I
    initial_lambda: float = 1e-4
    initial_dlambda: float = 1.0
    lambda_factor: float = 1.6
    lambda_min: float = 1e-6
    lambda_max: float = 1e10
    k_rel_norm_thre: float = 1e-4
    lambda_thre: float = 1e-5
    alpha_list: tuple = tuple(10.0 ** e for e in
                              [0.0, -0.3, -0.6, -0.9, -1.2, -1.5, -1.8,
                               -2.1, -2.4, -2.7, -3.0])
    cost_update_ratio_thre: float = 0.0
    cost_update_thre: float = 1e-7
    backward_impl: str = "auto"
    # dtype of the derivative sweep ("same" follows the solve dtype)
    deriv_dtype: str = "same"
    ls_mode: str = "auto"
    forward_impl: str = "auto"
    # consecutive all-lanes-accept-alpha[0] iterations before ls_mode
    # "auto" tries the head path again after a reject
    ls_auto_hysteresis: int = 2
    # bound on backward lambda retries per iteration (semantically
    # unbounded: lambda_min -> lambda_max at factor 1.6 takes ~80)
    max_backward_retries: int = 100
    boxqp: "BoxQPConfig" = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.boxqp is None:
            object.__setattr__(self, "boxqp", BoxQPConfig())
        if self.backward_impl not in ("auto", "stacked", "pallas", "remat"):
            raise ValueError(
                f"DDPConfig.backward_impl must be one of 'auto', 'stacked', "
                f"'pallas', 'remat'; got {self.backward_impl!r}")
        if self.deriv_dtype not in ("same", "float32", "float64"):
            raise ValueError(
                f"DDPConfig.deriv_dtype must be one of 'same', 'float32', "
                f"'float64'; got {self.deriv_dtype!r}")
        if self.ls_mode not in ("auto", "serial", "head", "sweep"):
            raise ValueError(
                f"DDPConfig.ls_mode must be one of 'auto', 'serial', "
                f"'head', 'sweep'; got {self.ls_mode!r}")
        if self.forward_impl not in ("auto", "fused", "scan"):
            raise ValueError(
                f"DDPConfig.forward_impl must be one of 'auto', 'fused', "
                f"'scan'; got {self.forward_impl!r}")

    def for_fp32(self, cost_scale: float = 1e3) -> "DDPConfig":
        """fp32-calibrated termination thresholds: the fp64 default
        cost_update_thre=1e-7 sits below fp32 resolution for costs of order
        ``cost_scale``; eps_f32 * cost_scale ~ 1e-4 is the smallest cost
        update fp32 can resolve."""
        return dataclasses.replace(
            self,
            cost_update_thre=max(self.cost_update_thre, 6e-8 * cost_scale * 2),
            k_rel_norm_thre=max(self.k_rel_norm_thre, 1e-4),
        )


@dataclasses.dataclass(frozen=True)
class BoxQPConfig:
    """Projected-Newton BoxQP configuration (reference ``BoxQP.h:33-55``),
    read by ``solvers/boxqp.py::boxqp_solve`` and by the boxed DDP
    backward (``DDPConfig.with_input_constraint``).  ``unroll_iter`` is
    carried for config parity: the JAX kernels unroll that many QP
    iterations before a masked loop; the port's plain version and CUDA
    kernels loop per lane.  ``ls_block`` is the number of Armijo
    candidates the plain version evaluates at once."""

    max_iter: int = 500
    grad_thre: float = 1e-8
    rel_improve_thre: float = 1e-8
    step_factor: float = 0.6
    min_step: float = 1e-22
    armijo_param: float = 0.1
    max_ls_iter: int = 104
    unroll_iter: int = 4
    ls_block: int = 9


class BoxQPStatus(enum.IntEnum):
    """Return codes, matching the reference table ``BoxQP.h:375-383``."""

    NOT_FINISHED = 0
    MAX_ITER = 1
    MAX_LS_ITER = 2
    NO_BOUNDS = 3
    SMALL_IMPROVEMENT = 4
    SMALL_GRADIENT = 5
    ALL_CLAMPED = 6
    HESSIAN_NOT_PD = -1
    POSITIVE_DIR_DERIV = -2


@dataclasses.dataclass
class DDPTrace:
    """Per-iteration trace, tensors [..., max_iter+1]; column 0 is the
    initial rollout (reference ``DDPSolver::TraceData``)."""

    iter: torch.Tensor
    cost: torch.Tensor
    lam: torch.Tensor
    dlam: torch.Tensor
    alpha: torch.Tensor
    k_rel_norm: torch.Tensor
    cost_update_actual: torch.Tensor
    cost_update_expected: torch.Tensor
    cost_update_ratio: torch.Tensor


@dataclasses.dataclass
class DDPResult:
    """Result of a solve; batched results carry a leading batch axis."""

    status: torch.Tensor        # int32, DDPStatus
    success: torch.Tensor       # bool  (status == SUCCEEDED)
    iters: torch.Tensor         # int32 iterations executed
    xs: torch.Tensor            # [N+1, nx]
    us: torch.Tensor            # [N, nu]
    costs: torch.Tensor         # [N+1]
    ks: torch.Tensor            # [N, nu] feedforward gains
    Ks: torch.Tensor            # [N, nu, nx] feedback gains
    lam: torch.Tensor
    dlam: torch.Tensor
    trace: DDPTrace


class FmpcStatus(enum.IntEnum):
    """FMPC result status (reference ``FmpcSolver.h:92-114``)."""

    UNINITIALIZED = 0
    SUCCEEDED = 1
    ERROR_IN_FORWARD = 2
    ERROR_IN_BACKWARD = 3
    ERROR_IN_UPDATE = 4
    MAX_ITERATION_REACHED = 5
    ITERATION_CONTINUED = 6


@dataclasses.dataclass(frozen=True)
class FmpcConfig:
    """FMPC solver configuration (reference ``FmpcSolver.h:58-89``).

    ``print_level`` gates ``FmpcSolver.solve``'s diagnostics
    (``utils/logging.py``).  ``max_line_search_iter`` bounds the l1-merit Armijo
    backtracking (the reference stops at alpha_s < 1e-10).

    ``backward_impl`` selects the condensed Riccati backward of the
    batched solve: ``"stacked"`` the torch-op recursion
    (``solvers/fmpc.py::_backward_bm``); ``"pallas"`` the hand-written
    CUDA kernel (``kernels/fmpc_backward.py``, source
    ``csrc/fmpc_backward.cuh``; the name is kept from the JAX package, where
    it names the fused Pallas kernel; on CPU tensors it runs the plain
    version); ``"auto"`` the rule in
    ``solvers/fmpc.py::_resolve_impls``.  ``forward_impl`` selects the
    Δx/Δu recursion the same way: ``"scan"`` the plain loop, ``"fused"``
    the CUDA kernel (``kernels/fmpc_forward.py``), ``"auto"``.
    """

    horizon_steps: int = 100
    max_iter: int = 10
    print_level: int = 0
    kkt_error_thre: float = 1e-4
    check_nan: bool = True
    init_complementary_variable: bool = False
    update_barrier_eps: bool = True
    break_if_llt_fails: bool = False
    enable_line_search: bool = False
    merit_const_scale_from_lagrange_multipliers: bool = False
    max_line_search_iter: int = 40
    backward_impl: str = "auto"
    forward_impl: str = "auto"

    def __post_init__(self):
        if self.backward_impl not in ("auto", "stacked", "pallas"):
            raise ValueError(
                f"FmpcConfig.backward_impl must be one of 'auto', 'stacked', "
                f"'pallas'; got {self.backward_impl!r}")
        if self.forward_impl not in ("auto", "fused", "scan"):
            raise ValueError(
                f"FmpcConfig.forward_impl must be one of 'auto', 'fused', "
                f"'scan'; got {self.forward_impl!r}")


@dataclasses.dataclass
class FmpcVariable:
    """Primal-dual iterate (reference ``FmpcSolver::Variable``,
    ``FmpcSolver.h:117-158``); also the warm start.  Batched variables
    carry a leading batch axis."""

    xs: torch.Tensor       # [N+1, nx]
    us: torch.Tensor       # [N, nu]
    lambdas: torch.Tensor  # [N+1, nx]  dynamics multipliers
    ss: torch.Tensor       # [N, ng]    slacks (>= 0)
    nus: torch.Tensor      # [N, ng]    inequality multipliers (>= 0)


def fmpc_variable_reset(N, nx, nu, ng, x=0.0, u=0.0, lam=0.0, s=1.0,
                        nu_=1.0, dtype=None, device=None) -> FmpcVariable:
    """Constant-filled iterate (``FmpcSolver::Variable::reset``,
    ``FmpcSolver.hpp:42-68``); ``dtype`` defaults to torch's default."""
    dtype = dtype or torch.get_default_dtype()
    full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=device)
    return FmpcVariable(xs=full((N + 1, nx), x), us=full((N, nu), u),
                        lambdas=full((N + 1, nx), lam), ss=full((N, ng), s),
                        nus=full((N, ng), nu_))


@dataclasses.dataclass
class FmpcTrace:
    """Per-iteration trace (``FmpcSolver::TraceData``): column j holds
    the KKT error of check j (column 0 is unused)."""

    iter: torch.Tensor
    kkt_error: torch.Tensor


@dataclasses.dataclass
class FmpcResult:
    """Result of an FMPC solve; batched results carry a leading batch
    axis."""

    status: torch.Tensor        # int32, FmpcStatus
    iters: torch.Tensor         # int32 KKT checks performed
    variable: FmpcVariable
    kkt_error: torch.Tensor     # KKT error at the last check
    ks: torch.Tensor            # [N, nu] feedforward gains, last good backward
    Ks: torch.Tensor            # [N, nu, nx] feedback gains
    barrier_eps: torch.Tensor   # final barrier parameter
    trace: FmpcTrace
