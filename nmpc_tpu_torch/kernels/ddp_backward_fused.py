"""Fused DDP Riccati backward: the hand-written CUDA kernel's wrapper.

Replaces ``nmpc_tpu/kernels/ddp_backward_pallas.py::backward_pallas`` (the
fused Pallas TPU kernel).  Source: ``csrc/ddp_backward.cu``, one thread per
batch lane running the whole N-stage recursion with its carry in
registers; the source's header says what bounds it on the card and what
the design does about that.

:func:`backward_fused` is a drop-in for
``kernels/ddp_backward.py::backward_stacked`` (same arguments, same
batch-minor layout, ok as bool).  On CPU tensors it runs that plain twin;
on CUDA tensors it launches the kernel or raises.  Nothing here builds or
touches CUDA until the first CUDA call, so the module imports without
``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nmpc_tpu_torch.core.types import DDPConfig
from nmpc_tpu_torch.kernels.build import build
from nmpc_tpu_torch.kernels.ddp_backward import StackedDerivs, backward_stacked

# (nx, nu) pairs instantiated in csrc/ddp_backward.cu (cart-pole: 4, 1).
BUILT_SHAPES = frozenset({(4, 1)})
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def kernel_supports(nx: int, nu: int, dtype) -> bool:
    """Whether the CUDA kernel was built for this state/input size and
    dtype."""
    return (nx, nu) in BUILT_SHAPES and dtype in _DTYPE_CODES


@functools.cache
def _launcher():
    lib = ctypes.CDLL(str(build("ddp_backward")))
    fn = lib.ddp_backward_launch
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 15
    fn.restype = ctypes.c_int
    return fn


def _check(name, a, shape, dtype, device):
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, expected {device}")
    if a.dtype != dtype:
        raise ValueError(f"{name} has dtype {a.dtype}, expected {dtype}")
    if tuple(a.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                         f"{shape}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def backward_fused(config: DDPConfig, D: StackedDerivs, Vx_T, Vxx_T, lam):
    """Backward pass, batch-minor, by the fused CUDA kernel.

    Args: D with Fx [N,nx,nx,B], Fu [N,nx,nu,B], Lx [N,nx,B], Lu [N,nu,B],
    Lxx [N,nx,nx,B], Luu [N,nu,nu,B], Lxu [N,nx,nu,B]; Vx_T [nx,B],
    Vxx_T [nx,nx,B]; lam [B].
    Returns (ks [N,nu,B], Ks [N,nu,nx,B], dV [2,B], ok [B] bool).
    """
    N, nx = D.Fx.shape[0], D.Fx.shape[1]
    nu = D.Fu.shape[2]
    B = Vx_T.shape[-1]
    dtype, device = Vx_T.dtype, Vx_T.device
    shapes = {"Fx": (N, nx, nx, B), "Fu": (N, nx, nu, B), "Lx": (N, nx, B),
              "Lu": (N, nu, B), "Lxx": (N, nx, nx, B), "Luu": (N, nu, nu, B),
              "Lxu": (N, nx, nu, B)}
    for name, a in zip(StackedDerivs._fields, D):
        _check(name, a, shapes[name], dtype, device)
    _check("Vx_T", Vx_T, (nx, B), dtype, device)
    _check("Vxx_T", Vxx_T, (nx, nx, B), dtype, device)
    _check("lam", lam, (B,), dtype, device)
    if device.type == "cpu":
        return backward_stacked(config, D, Vx_T, Vxx_T, lam)
    if device.type != "cuda":
        raise ValueError(f"backward_fused takes CPU or CUDA tensors, got "
                         f"{device}")
    if not kernel_supports(nx, nu, dtype):
        raise ValueError(
            f"the CUDA backward kernel is built for (nx, nu) in "
            f"{sorted(BUILT_SHAPES)} and float32/float64; got ({nx}, {nu}) "
            f"{dtype}")

    ks = torch.empty((N, nu, B), dtype=dtype, device=device)
    Ks = torch.empty((N, nu, nx, B), dtype=dtype, device=device)
    dV = torch.empty((2, B), dtype=dtype, device=device)
    ok = torch.empty((B,), dtype=torch.bool, device=device)
    launch = _launcher()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = launch(_DTYPE_CODES[dtype], nx, nu, config.reg_type, N, B,
                     *(a.data_ptr() for a in D), Vx_T.data_ptr(),
                     Vxx_T.data_ptr(), lam.data_ptr(), ks.data_ptr(),
                     Ks.data_ptr(), dV.data_ptr(), ok.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ddp_backward kernel launch failed: CUDA error "
                           f"{err}")
    backward_fused.launches += 1
    return ks, Ks, dV, ok


backward_fused.launches = 0
