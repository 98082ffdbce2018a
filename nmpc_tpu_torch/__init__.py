"""nmpc_tpu_torch — the PyTorch/CUDA port of ``nmpc_tpu``.

Ported so far: the batched DDP solve, unboxed and boxed (projected-Newton
BoxQP per stage, time-varying input masks), on the cart-pole and the
vertical-motion models, the single BoxQP solve, the batched closed-loop
tick loop, and the batched FMPC solve (multiple shooting, primal-dual
interior point, condensed Riccati) on the oscillator and the constrained
cart-pole, with hand-written CUDA kernels for Hopper beside their plain
torch-op versions: the sweep-fed Riccati backward
(``csrc/ddp_backward.cu``) and its boxed variant
(``csrc/ddp_backward_boxed.cuh``), the remat backward (unboxed and boxed)
and fused line-search rollouts (``csrc/ddp_*_remat.cuh``) built from code
that ``kernels/tileval.py`` generates from the problem's own callables,
and FMPC's condensed Riccati backward (``csrc/fmpc_backward.cuh``) and
Δx/Δu recursion (``csrc/fmpc_forward.cuh``).  The package imports
``torch`` and never ``jax``; ``nmpc_tpu`` stays the reference it is tested
against.
"""

from nmpc_tpu_torch.core.problem import Problem
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
from nmpc_tpu_torch.solvers.boxqp import boxqp_solve
from nmpc_tpu_torch.solvers.ddp import DDPSolver
from nmpc_tpu_torch.solvers.fmpc import FmpcSolver

__version__ = "0.1.0"

__all__ = [
    "Problem",
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
]
