"""Boxed DDP Riccati backward fed by the derivative sweep: the CUDA
kernels' wrapper (TPU K4).

Replaces ``nmpc_tpu/kernels/ddp_backward_pallas.py::backward_pallas_boxed``,
which takes any (nx, nu), with two sources, each instantiated per (nx, nu,
dtype) in a small generated unit that nvcc builds at first use:

* ``csrc/ddp_backward_boxed.cuh`` for nu <= ``MAX_NU_GROUP`` at any nx:
  a group of ``kQpGroup`` threads per lane that each run the lane's
  stage ``riccati_stage_boxed`` and projected-Newton QP
  ``csrc/boxqp.cuh`` in registers and evaluate the Armijo schedule that
  many candidates at a time;
* ``csrc/ddp_backward_boxed_wide.cuh`` at a :func:`boxed_wide` shape,
  where the one-group unit cannot serve (MAX_NU_GROUP < nu, up to K1's
  (9, 16): the centroidal model's 16 boxed forces): K1-wide's block and
  TMA ring with the bounds added to each stage, and the stage and QP of
  ``csrc/boxqp_wide.cuh``, whose 32 threads a lane split the 16-input
  work by rows through shared memory (the one-group QP unrolls about
  nu^3 work per stage into each thread's registers).

:func:`backward_fused_boxed` is a drop-in for
``kernels/ddp_backward.py::backward_stacked_boxed``.  On CPU tensors it
runs that plain version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from nmpc_tpu_torch.core.types import BoxQPConfig, DDPConfig
from nmpc_tpu_torch.kernels.build import CSRC, build_generated, load
from nmpc_tpu_torch.kernels.ddp_backward import (StackedBounds,
                                                 StackedDerivs,
                                                 backward_stacked_boxed)
from nmpc_tpu_torch.kernels.ddp_backward_fused import (MAX_NU, MAX_NX,
                                                       _check,
                                                       padded_fields)

# The largest input the one-group unit (ddp_backward_boxed.cuh) takes, at
# any nx; the wide unit takes the inputs past it up to K1's (MAX_NX,
# MAX_NU).
MAX_NU_GROUP = 4
# The most Armijo steps (armijo_steps) the wide unit's step table holds
# (csrc/ddp_backward_boxed_wide.cuh::kWideStepTable).
WIDE_STEP_TABLE = 512
# The phases of a wide boxed stage whose cycles the wide unit's profile
# build stores after its QP stats (csrc/boxqp_wide.cuh::WidePhase, in its
# order): the ring's wait, the Q expansion, the QP's gradient, masked
# system, Cholesky, backward substitution and Armijo rounds (summed over
# its iterations), K's columns, the value update, the gains' stores.
WIDE_PHASES = ("wait", "expand", "gradient", "system", "cholesky", "solve",
               "armijo", "K columns", "value", "store")
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


def armijo_steps(cfg: BoxQPConfig, dtype) -> int:
    """The Armijo steps a search can visit: ``max_ls_iter + 1``, or k + 1
    where step k of 1, f, f^2, ... (formed by repeated multiplication at
    ``dtype``, as ``kernels/ddp_backward.py::_step_schedule`` forms them,
    and compared with ``min_step`` at ``dtype``) is the first below
    ``min_step``: the search stops there, exhausted, whatever Armijo says,
    so no later step is read.  With the defaults (0.6, 1e-22) that is 101
    at both dtypes.  The wide unit's step table holds this many
    (``csrc/ddp_backward_boxed_wide.cuh::armijo_steps``, the same rule)."""
    t = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    f, below = t(cfg.step_factor), t(cfg.min_step)
    step = t(1.0)
    for k in range(cfg.max_ls_iter + 1):
        if step < below:
            return k + 1
        if step * f == step:   # a fixed point: no later step differs
            break
        step = step * f
    return cfg.max_ls_iter + 1


def boxed_wide(nx: int, nu: int) -> bool:
    """Whether the wide unit serves (nx, nu): only where the one-group
    unit cannot, MAX_NU_GROUP < nu <= MAX_NU and nx <= MAX_NX."""
    return MAX_NU_GROUP < nu <= MAX_NU and 1 <= nx <= MAX_NX


def boxed_kernel_supports(nx: int, nu: int, dtype,
                          qp: BoxQPConfig = BoxQPConfig()) -> bool:
    """Whether a boxed kernel takes this state/input size, dtype and QP
    configuration: float32 or float64, and (nx, nu) with nu <=
    MAX_NU_GROUP at any nx (the one-group unit) or a :func:`boxed_wide`
    shape (up to (9, 16)) whose Armijo schedule fits the wide unit's
    step table (``armijo_steps(qp, dtype) <= WIDE_STEP_TABLE``); any B
    and N (the unit is built on demand)."""
    if dtype not in DTYPES or nx < 1 or nu < 1:
        return False
    if boxed_wide(nx, nu):
        return armijo_steps(qp, dtype) <= WIDE_STEP_TABLE
    return nu <= MAX_NU_GROUP


def unit_source(nx: int, nu: int, dtype, group: int | None = None,
                profile: bool = False) -> str:
    """The unit instantiating the kernel at (nx, nu, dtype) (the wide one
    at a :func:`boxed_wide` shape), with its header's threads per lane,
    or ``group`` where a measurement asks for another; ``profile`` (wide
    only) builds the profile kernel, which adds the cycles of each of
    :data:`WIDE_PHASES` to its QP stats.  Both take a lane stride ``ld``
    and a ``qp_stats`` buffer, which the one-group kernel does not
    read."""
    wide = boxed_wide(nx, nu)
    if profile and not wide:
        raise ValueError("only the wide boxed unit has a profile build")
    g = "" if group is None else f", {group}"
    if profile:
        g = f", {'nmpc::kWideGroup' if group is None else group}, true"
    if wide:
        header, fn, lead, tail = ("ddp_backward_boxed_wide.cuh",
                                  "launch_backward_boxed_wide", "ld, ",
                                  "qp_stats, ")
        unused = ""
    else:
        header, fn, lead, tail = ("ddp_backward_boxed.cuh",
                                  "launch_backward_boxed", "", "")
        unused = "  (void)ld;\n  (void)qp_stats;\n"
    return (f"#include \"{header}\"\n\n"
            f"extern \"C\" int boxed_backward_launch(\n"
            f"    int N, int B, int reg_type, int ld,\n"
            f"    const void* const* fields, const void* VxT,\n"
            f"    const void* VxxT, const void* lam, void* ks, void* Ks,\n"
            f"    void* dV, void* ok, void* qp_stats, void* stream,\n"
            f"    {QP_PARAMS_C}) {{\n{QP_STRUCT_C}{unused}"
            f"  return nmpc::{fn}<{DTYPES[dtype]}, {nx}, {nu}{g}>(\n"
            f"      N, B, {lead}reg_type, qp, fields, VxT, VxxT, lam, ks, Ks, "
            f"dV, ok,\n      {tail}stream);\n}}\n")


def unit_name(nx: int, nu: int, dtype, group: int | None = None,
              profile: bool = False) -> str:
    kind = "_wide" if boxed_wide(nx, nu) else ""
    g = "" if group is None else f"_g{group}"
    prof = "_prof" if profile else ""
    return f"ddp_backward_boxed{kind}_{nx}x{nu}_{str(dtype)[6:]}{g}{prof}"


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
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 10 + QP_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(fn, config: DDPConfig, D: StackedDerivs, bounds: StackedBounds,
           Vx_T, Vxx_T, lam, stats=None, profile=False):
    """One launch of the unit function ``fn`` (:func:`launcher`) on
    checked CUDA tensors; raises on a CUDA error.  The wide unit reads
    its ten fields through TMA tensor maps: fields TMA does not take are
    copied once (``padded_fields``; counted in
    ``backward_fused_boxed.padded_copies``).  ``stats``, a dict if given
    (the wide unit only), receives the kernel's QP iterations
    (``"qp_iters"``), free sets (``"free"``, bit a for input a) and
    Armijo candidates visited (``"ls_evals"``), [N, B] int32 each; with
    ``profile`` (``fn`` a profile build's) also ``"phases"``, the cycles
    of each of :data:`WIDE_PHASES` a (stage, lane), [len(WIDE_PHASES), N,
    B] int32.  Counts no launch: the wrapper counts its own."""
    N, nx, nu = D.Fu.shape[0], D.Fu.shape[1], D.Fu.shape[2]
    B = Vx_T.shape[-1]
    dtype, device = Vx_T.dtype, Vx_T.device
    wide = boxed_wide(nx, nu)
    if stats is not None and not wide:
        raise ValueError("only the wide boxed unit records QP stats")
    if profile and stats is None:
        raise ValueError("a profile launch records its phases in stats")
    if wide and armijo_steps(config.boxqp, dtype) > WIDE_STEP_TABLE:
        q = config.boxqp
        raise ValueError(
            f"the wide boxed kernel's step table holds {WIDE_STEP_TABLE} "
            f"Armijo steps; max_ls_iter={q.max_ls_iter} with step_factor="
            f"{q.step_factor}, min_step={q.min_step} needs "
            f"{armijo_steps(q, dtype)}")
    fields, ld = (*D, *bounds), B
    if wide:
        fields, ld, copies = padded_fields(fields)
        backward_fused_boxed.padded_copies += copies
    ks = torch.empty((N, nu, B), dtype=dtype, device=device)
    Ks = torch.empty((N, nu, nx, B), dtype=dtype, device=device)
    dV = torch.empty((2, B), dtype=dtype, device=device)
    ok = torch.empty((B,), dtype=torch.bool, device=device)
    rows = 3 + (len(WIDE_PHASES) if profile else 0)
    qp = (torch.empty((rows, N, B), dtype=torch.int32, device=device)
          if stats is not None else None)
    ptrs = (ctypes.c_void_p * 10)(*(a.data_ptr() for a in fields))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(N, B, config.reg_type, ld, ptrs, Vx_T.data_ptr(),
                 Vxx_T.data_ptr(), lam.data_ptr(), ks.data_ptr(),
                 Ks.data_ptr(), dV.data_ptr(), ok.data_ptr(),
                 None if qp is None else qp.data_ptr(), stream,
                 *qp_args(config.boxqp))
    if err != 0:
        raise RuntimeError(f"boxed backward kernel launch failed: CUDA "
                           f"error {err}")
    if stats is not None:
        stats.update(qp_iters=qp[0], free=qp[1], ls_evals=qp[2])
        if profile:
            stats["phases"] = qp[3:]
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
    if not boxed_kernel_supports(nx, nu, dtype):
        raise ValueError(
            f"the boxed CUDA backward takes nu <= {MAX_NU_GROUP} at any "
            f"nx, or {MAX_NU_GROUP} < nu <= {MAX_NU} at nx <= {MAX_NX}, and "
            f"float32/float64; got ({nx}, {nu}) {dtype}")
    out = launch(launcher(nx, nu, dtype), config, D, bounds, Vx_T, Vxx_T,
                 lam)
    if boxed_wide(nx, nu):
        backward_fused_boxed.wide_launches += 1
    else:
        backward_fused_boxed.launches += 1
    return out


backward_fused_boxed.launches = 0         # the one-group unit
backward_fused_boxed.wide_launches = 0    # the wide unit: (9, 16)
backward_fused_boxed.padded_copies = 0    # a field copied to a TMA stride
