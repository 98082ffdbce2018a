"""nmpc_tpu_torch — the PyTorch/CUDA port of ``nmpc_tpu``.

Ported so far: the batched DDP solve on unboxed problems (cart-pole) and
the batched closed-loop tick loop, with hand-written CUDA kernels for
Hopper beside their plain torch-op versions: the sweep-fed Riccati
backward (``csrc/ddp_backward.cu``), and the remat backward and fused
line-search rollouts (``csrc/ddp_*_remat.cuh``) built from code that
``kernels/tileval.py`` generates from the problem's own callables.  The package imports ``torch`` and never ``jax``;
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
