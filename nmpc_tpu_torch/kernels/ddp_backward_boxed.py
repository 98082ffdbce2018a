"""Boxed DDP Riccati backward fed by the derivative sweep: the CUDA
kernel's wrapper (TPU K4).

Replaces ``nmpc_tpu/kernels/ddp_backward_pallas.py::backward_pallas_boxed``.
Source: ``csrc/ddp_backward_boxed.cuh`` (a group of ``kQpGroup`` threads
per lane that evaluates the Armijo schedule that many candidates at a
time; the stage ``riccati_stage_boxed`` and the projected-Newton QP
``csrc/boxqp.cuh``), instantiated per (nx, nu, dtype) in a small
generated unit that nvcc builds at first use.  As on the TPU the kernel
takes nu <= ``MAX_NU``: the QP unrolls about nu^3 work per stage into
registers.

:func:`backward_fused_boxed` is a drop-in for
``kernels/ddp_backward.py::backward_stacked_boxed``.  On CPU tensors it
runs that plain version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from nmpc_tpu_torch.core.types import BoxQPConfig, DDPConfig
from nmpc_tpu_torch.kernels.build import CSRC, build_generated, load
from nmpc_tpu_torch.kernels.ddp_backward import (StackedBounds,
                                                 StackedDerivs,
                                                 backward_stacked_boxed)
from nmpc_tpu_torch.kernels.ddp_backward_fused import _check

MAX_NU = 4
# the kernels' scalar types (the generated units' T)
DTYPES = {torch.float32: "float", torch.float64: "double"}

# nvcc flags of every boxed unit: no contraction of a*b + c into an FMA,
# so that the kernel rounds op by op as its plain version's separate torch
# ops do.  The fp32 QP's free set and stopping iterate are decided at
# rounding level on flat objectives (the vertical model's input weight is
# 1e-4), so contraction alone moves ks by more than the kernel tolerance.
BOXED_FLAGS = ("-fmad=false",)

# The BoxQPConfig fields a boxed kernel reads, as C parameters of a launch
# function and as the nmpc::BoxQPParams they fill (csrc/boxqp.cuh).
QP_PARAMS_C = ("int qp_max_iter, int qp_max_ls_iter, double qp_grad_thre,\n"
               "    double qp_rel_improve_thre, double qp_step_factor,\n"
               "    double qp_min_step, double qp_armijo_param")
QP_STRUCT_C = ("  const nmpc::BoxQPParams qp{qp_max_iter, qp_max_ls_iter, "
               "qp_grad_thre,\n      qp_rel_improve_thre, qp_step_factor, "
               "qp_min_step, qp_armijo_param};\n")
QP_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_double] * 5


def qp_args(cfg: BoxQPConfig) -> tuple:
    """``cfg`` as the arguments of :data:`QP_PARAMS_C`.  The kernels need
    at least one Armijo candidate (``max_ls_iter >= 0``), as the plain
    version does."""
    if cfg.max_ls_iter < 0:
        raise ValueError(f"the boxed kernels take max_ls_iter >= 0, got "
                         f"{cfg.max_ls_iter}")
    return (cfg.max_iter, cfg.max_ls_iter, cfg.grad_thre,
            cfg.rel_improve_thre, cfg.step_factor, cfg.min_step,
            cfg.armijo_param)


def boxed_kernel_supports(nu: int, dtype) -> bool:
    """Whether the kernel takes this input size and dtype: nu <= MAX_NU,
    float32 or float64 (any nx; the unit is built on demand)."""
    return nu <= MAX_NU and dtype in DTYPES


def unit_source(nx: int, nu: int, dtype, group: int | None = None) -> str:
    """The unit instantiating the kernel at (nx, nu, dtype), with the
    header's ``kQpGroup`` threads per lane, or ``group`` where a
    measurement asks for another."""
    g = "" if group is None else f", {group}"
    return (f"#include \"ddp_backward_boxed.cuh\"\n\n"
            f"extern \"C\" int boxed_backward_launch(\n"
            f"    int N, int B, int reg_type, const void* const* fields,\n"
            f"    const void* VxT, const void* VxxT, const void* lam,\n"
            f"    void* ks, void* Ks, void* dV, void* ok, void* stream,\n"
            f"    {QP_PARAMS_C}) {{\n{QP_STRUCT_C}"
            f"  return nmpc::launch_backward_boxed<{DTYPES[dtype]}, {nx}, "
            f"{nu}{g}>(\n      N, B, reg_type, qp, fields, VxT, VxxT, lam, "
            f"ks, Ks, dV, ok, stream);\n}}\n")


def unit_name(nx: int, nu: int, dtype, group: int | None = None) -> str:
    g = "" if group is None else f"_g{group}"
    return f"ddp_backward_boxed_{nx}x{nu}_{str(dtype)[6:]}{g}"


@functools.lru_cache(maxsize=16)
def launcher(nx: int, nu: int, dtype, group: int | None = None,
             csrc: Path = CSRC):
    """The launch function of the unit at (nx, nu, dtype, group), built
    from the headers under ``csrc`` (another checkout's, to time it
    beside this one's)."""
    lib = load(build_generated(unit_name(nx, nu, dtype, group),
                               unit_source(nx, nu, dtype, group),
                               BOXED_FLAGS, csrc))
    fn = lib.boxed_backward_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 9 + QP_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(fn, config: DDPConfig, D: StackedDerivs, bounds: StackedBounds,
           Vx_T, Vxx_T, lam):
    """One launch of the unit function ``fn`` (:func:`launcher`) on
    checked CUDA tensors; raises on a CUDA error.  Counts nothing: the
    wrapper counts its own launches."""
    N, nx, nu = D.Fu.shape[0], D.Fu.shape[1], D.Fu.shape[2]
    B = Vx_T.shape[-1]
    dtype, device = Vx_T.dtype, Vx_T.device
    ks = torch.empty((N, nu, B), dtype=dtype, device=device)
    Ks = torch.empty((N, nu, nx, B), dtype=dtype, device=device)
    dV = torch.empty((2, B), dtype=dtype, device=device)
    ok = torch.empty((B,), dtype=torch.bool, device=device)
    fields = (ctypes.c_void_p * 10)(*(a.data_ptr() for a in (*D, *bounds)))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(N, B, config.reg_type, fields, Vx_T.data_ptr(),
                 Vxx_T.data_ptr(), lam.data_ptr(), ks.data_ptr(),
                 Ks.data_ptr(), dV.data_ptr(), ok.data_ptr(), stream,
                 *qp_args(config.boxqp))
    if err != 0:
        raise RuntimeError(f"boxed backward kernel launch failed: CUDA "
                           f"error {err}")
    return ks, Ks, dV, ok


def backward_fused_boxed(config: DDPConfig, D: StackedDerivs,
                         bounds: StackedBounds, Vx_T, Vxx_T, lam, host=bool):
    """Boxed backward pass, batch-minor, by the CUDA kernel.

    Args: D as ``backward_fused``'s; bounds with lower, upper, u
    [N, nu, B]; Vx_T [nx, B], Vxx_T [nx, nx, B], lam [B].  ``host`` reads
    the plain version's device flags on CPU tensors.
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
    for name, a in zip(StackedBounds._fields, bounds):
        _check(name, a, (N, nu, B), dtype, device)
    _check("Vx_T", Vx_T, (nx, B), dtype, device)
    _check("Vxx_T", Vxx_T, (nx, nx, B), dtype, device)
    _check("lam", lam, (B,), dtype, device)
    if device.type == "cpu":
        return backward_stacked_boxed(config, D, bounds, Vx_T, Vxx_T, lam,
                                      host=host)
    if device.type != "cuda":
        raise ValueError(f"backward_fused_boxed takes CPU or CUDA tensors, "
                         f"got {device}")
    if not boxed_kernel_supports(nu, dtype):
        raise ValueError(f"the boxed CUDA backward takes nu <= {MAX_NU} and "
                         f"float32/float64; got nu={nu} {dtype}")
    out = launch(launcher(nx, nu, dtype), config, D, bounds, Vx_T, Vxx_T,
                 lam)
    backward_fused_boxed.launches += 1
    return out


backward_fused_boxed.launches = 0
