"""nmpc_tpu_torch — the PyTorch/CUDA port of ``nmpc_tpu``.

Ported so far: the batched DDP solve on unboxed problems (cart-pole), its
fused Riccati backward as a hand-written CUDA kernel for Hopper
(``csrc/ddp_backward.cu``) with a torch-op twin, and the batched
closed-loop tick loop.  The package imports ``torch`` and never ``jax``;
``nmpc_tpu`` stays the reference it is tested against.
"""

from nmpc_tpu_torch.core.problem import Problem
from nmpc_tpu_torch.core.types import (
    BoxQPConfig,
    BoxQPStatus,
    DDPConfig,
    DDPResult,
    DDPStatus,
    DDPTrace,
)
from nmpc_tpu_torch.solvers.ddp import DDPSolver

__version__ = "0.1.0"

__all__ = [
    "Problem",
    "DDPConfig",
    "DDPResult",
    "DDPStatus",
    "DDPTrace",
    "DDPSolver",
    "BoxQPConfig",
    "BoxQPStatus",
]
