"""nmpc_tpu_torch — the PyTorch/CUDA port of ``nmpc_tpu``.

Ported so far: the batched DDP solve, unboxed and boxed (projected-Newton
BoxQP per stage, time-varying input masks), on the cart-pole, the
vertical-motion and the bipedal CoM-ZMP models, the single BoxQP solve,
the receding-horizon driver (``run_mpc``), the single and the batched
closed-loop tick loops, the batched FMPC solve (multiple shooting,
primal-dual interior point, condensed Riccati) on the oscillator and the
constrained cart-pole, the centroidal model (9 states, 16 ridge forces),
second-order (full) DDP solves, and the C/GMRES continuation solver
(``ContinuousProblem``, matrix-free GMRES, the batch-minor fleet path) on
the semiactive damper and the cart-pole, with the derivative checker,
the reference's dump formats, the ``print_level`` gate, timing, profiled
solves and trace plots (``utils/``), the parallel-in-time Riccati
(``solvers/parallel_riccati.py``), the batch and the horizon split over
``torch.distributed`` ranks (``parallel/``), the native multi-rate
executor (``runtime/``) and the examples (``examples/``); with
hand-written CUDA kernels
for Hopper beside
their plain torch-op versions: the sweep-fed Riccati backward in three
layouts (``csrc/ddp_backward.cuh``, ``_chunked.cuh``, ``_packed.cuh``)
and its boxed variant (``csrc/ddp_backward_boxed.cuh``), the remat
backward (unboxed and boxed) and fused line-search rollouts
(``csrc/ddp_*_remat.cuh``) built from code that ``kernels/tileval.py``
generates from the problem's own callables, and FMPC's condensed Riccati
backward in three layouts (``csrc/fmpc_backward.cuh``, ``_resident.cuh``,
``_packed.cuh``) and Δx/Δu recursion (``csrc/fmpc_forward.cuh``).  The
package imports ``torch`` and never ``jax``; ``nmpc_tpu`` stays the
reference it is tested against.
"""

from nmpc_tpu_torch.core.problem import ContinuousProblem, Problem
from nmpc_tpu_torch.core.types import (
    BoxQPConfig,
    BoxQPStatus,
    DDPConfig,
    DDPResult,
    DDPStatus,
    DDPTrace,
    FmpcConfig,
    FmpcResult,
    FmpcStatus,
    FmpcVariable,
    fmpc_variable_reset,
)
from nmpc_tpu_torch.models.bipedal import (
    BipedalCostWeight,
    example_omega2_func,
    example_ref_zmp_func,
    make_bipedal_problem,
)
from nmpc_tpu_torch.mpc.closed_loop import make_closed_loop
from nmpc_tpu_torch.mpc.driver import MpcLog, run_mpc, shift_warm_start
from nmpc_tpu_torch.solvers.boxqp import boxqp_solve
from nmpc_tpu_torch.solvers.cgmres import (CgmresConfig, CgmresSolver,
                                           CgmresState)
from nmpc_tpu_torch.solvers.ddp import DDPSolver
from nmpc_tpu_torch.solvers.fmpc import FmpcSolver
from nmpc_tpu_torch.solvers.gmres import gmres, gmres_dense

__version__ = "0.1.0"

__all__ = [
    "Problem",
    "ContinuousProblem",
    "CgmresConfig",
    "CgmresSolver",
    "CgmresState",
    "gmres",
    "gmres_dense",
    "DDPConfig",
    "DDPResult",
    "DDPStatus",
    "DDPTrace",
    "DDPSolver",
    "FmpcConfig",
    "FmpcResult",
    "FmpcStatus",
    "FmpcVariable",
    "fmpc_variable_reset",
    "FmpcSolver",
    "BoxQPConfig",
    "BoxQPStatus",
    "boxqp_solve",
    "run_mpc",
    "shift_warm_start",
    "MpcLog",
    "make_closed_loop",
    "BipedalCostWeight",
    "make_bipedal_problem",
    "example_ref_zmp_func",
    "example_omega2_func",
]
