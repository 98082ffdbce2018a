"""Remat DDP backward: the CUDA kernel's wrapper (TPU K5, unboxed and
boxed).

Replaces ``nmpc_tpu/kernels/ddp_backward_remat.py::backward_remat``: the
Riccati backward fed by the trajectory, with each stage's derivatives (and,
boxed, its bounds) recomputed inside the kernel from (t_i, x_i, u_i), so
the derivative sweep and its buffer go away.  The kernel is the template
``csrc/ddp_backward_remat.cuh`` instantiated in a unit generated from the
problem's own callables (``kernels/tileval.py``: ``"remat"``, or
``"remat_boxed"`` with the aux group; unboxed, a group of ``kRematGroup``
threads per lane that generates the fields of that many stages ahead into
shared memory, one stage a thread, and splits the rows of each Riccati
stage, with as many lanes a block as their shared memory allows (one
thread per lane and the fields in registers where no slab fits); boxed,
a group of ``kQpGroup`` threads per lane that evaluates the Armijo
schedule that many candidates at a time), compiled by nvcc at first use
with ``-fmad=false`` and bound through ctypes.  Its plain
version is :func:`backward_remat_plain`: the derivative sweep and
``backward_stacked`` (boxed: ``backward_stacked_boxed``), independent of
the generator, so that holding one against the other on the card checks the
generator too.

:func:`backward_remat` generates the problem's unit on any device, so a
problem the generator rejects raises :class:`TileEvalError` everywhere;
then it runs the plain version on CPU tensors and launches the kernel on
CUDA tensors (or raises).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from nmpc_tpu_torch.core.types import DDPConfig
from nmpc_tpu_torch.kernels import tileval
from nmpc_tpu_torch.kernels.build import CSRC, build_generated, load
from nmpc_tpu_torch.kernels.ddp_backward import (StackedBounds,
                                                 StackedDerivs,
                                                 backward_stacked,
                                                 backward_stacked_boxed)
from nmpc_tpu_torch.kernels.ddp_backward_boxed import (BOXED_FLAGS, DTYPES,
                                                       QP_ARGTYPES,
                                                       QP_PARAMS_C,
                                                       QP_STRUCT_C, qp_args)
from nmpc_tpu_torch.kernels.ddp_backward_fused import _check
from nmpc_tpu_torch.solvers.stages import _stage_derivs_sweep

# The largest input the boxed remat kernel takes: its lane group repeats
# the QP's NU x NU work in each thread's registers (csrc/boxqp.cuh).
MAX_NU_BOXED = 4


def _kind(boxed: bool) -> str:
    return "remat_boxed" if boxed else "remat"


def remat_supported(problem, nx: int, nu: int, dtype,
                    boxed: bool = False) -> bool:
    """Whether the kernel takes this problem at this dtype: float32 or
    float64, stage callables (boxed: and limits and mask) the generator
    accepts, and boxed nu <= MAX_NU_BOXED."""
    return (dtype in DTYPES and (not boxed or nu <= MAX_NU_BOXED)
            and tileval.tile_supported(problem, _kind(boxed), nx, nu, dtype))


def unit_source(problem, nx: int, nu: int, dtype, boxed: bool = False,
                group: int | None = None) -> str:
    """The generated translation unit for ``problem`` at ``dtype``, with
    the header's threads per lane (boxed ``kQpGroup``, unboxed
    ``kRematLaneGroup``), or ``group`` where a measurement asks for
    another (unboxed 0: one thread per lane, the fields in registers)."""
    unit = tileval.generate(problem, _kind(boxed), nx, nu, dtype)
    params = qp_struct = flag = qp = ""
    if boxed:   # the QP's parameters ride along to the boxed instantiation
        params, qp_struct, flag, qp = (f",\n    {QP_PARAMS_C}", QP_STRUCT_C,
                                       ", true", ", qp")
    if group is not None:
        flag = f"{flag or ', false'}, {group}"
    return (f"{unit.cpp}\n#include \"ddp_backward_remat.cuh\"\n\n"
            f"extern \"C\" int remat_backward_launch(\n"
            f"    int N, int B, int reg_type, double dt, const void* xs,\n"
            f"    const void* us, const void* VxT, const void* VxxT,\n"
            f"    const void* lam, const void* t0, void* ks, void* Ks,\n"
            f"    void* dV, void* ok, void* stream{params}) {{\n{qp_struct}"
            f"  return nmpc::launch_backward_remat<{DTYPES[dtype]}, {nx}, "
            f"{nu}{flag}>(\n      N, B, reg_type, dt, xs, us, VxT, VxxT, "
            f"lam, t0, ks, Ks, dV, ok, stream{qp});\n}}\n")


def unit_name(dtype, boxed: bool = False, group: int | None = None) -> str:
    g = "" if group is None else f"_g{group}"
    return f"ddp_backward_{_kind(boxed)}_{str(dtype)[6:]}{g}"


def unit_flags(boxed: bool = False) -> tuple:
    """The unit's nvcc flags beyond ``build.NVCC_FLAGS``: no FMA
    contraction, boxed or not (``BOXED_FLAGS``)."""
    return BOXED_FLAGS


def bind(lib, boxed: bool = False):
    """The launch function of a loaded unit (:func:`unit_source`)."""
    fn = lib.remat_backward_launch
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_double]
                   + [ctypes.c_void_p] * 11 + (QP_ARGTYPES if boxed else []))
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=64)
def launcher(problem, nx: int, nu: int, dtype, boxed: bool,
             group: int | None = None, csrc: Path = CSRC):
    """The launch function of ``problem``'s unit, built from the headers
    under ``csrc`` (another checkout's, to time it beside this one's)."""
    return bind(load(build_generated(
        unit_name(dtype, boxed, group),
        unit_source(problem, nx, nu, dtype, boxed, group), unit_flags(boxed),
        csrc)), boxed)


def launch(fn, problem, config: DDPConfig, t0, xs, us, Vx_T, Vxx_T, lam,
           boxed: bool = False):
    """One launch of the unit function ``fn`` (:func:`launcher`) on
    checked CUDA tensors, t0 a device scalar; raises on a CUDA error.
    Counts nothing: the wrapper counts its own launches."""
    N, nu, B = us.shape
    nx = xs.shape[1]
    dtype, device = xs.dtype, xs.device
    ks = torch.empty((N, nu, B), dtype=dtype, device=device)
    Ks = torch.empty((N, nu, nx, B), dtype=dtype, device=device)
    dV = torch.empty((2, B), dtype=dtype, device=device)
    ok = torch.empty((B,), dtype=torch.bool, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(N, B, config.reg_type, float(problem.dt), xs.data_ptr(),
                 us.data_ptr(), Vx_T.data_ptr(), Vxx_T.data_ptr(),
                 lam.data_ptr(), t0.data_ptr(), ks.data_ptr(), Ks.data_ptr(),
                 dV.data_ptr(), ok.data_ptr(), stream,
                 *(qp_args(config.boxqp) if boxed else ()))
    if err != 0:
        raise RuntimeError(f"remat backward kernel launch failed: CUDA "
                           f"error {err}")
    return ks, Ks, dV, ok


def backward_remat_plain(problem, config: DDPConfig, t0, xs, us, Vx_T,
                         Vxx_T, lam, boxed: bool = False, host=bool):
    """The kernel's plain version: the derivative sweep (boxed: with the
    bounds), then ``backward_stacked`` or ``backward_stacked_boxed``."""
    D = _stage_derivs_sweep(problem, dataclasses.replace(
        config, with_input_constraint=boxed), t0, xs, us)
    if boxed:
        return backward_stacked_boxed(config, StackedDerivs(*D[:7]),
                                      StackedBounds(*D[-3:]), Vx_T, Vxx_T,
                                      lam, host=host)
    return backward_stacked(config, StackedDerivs(*D[:7]), Vx_T, Vxx_T, lam)


def backward_remat(problem, config: DDPConfig, t0, xs, us, Vx_T, Vxx_T,
                   lam, boxed: bool = False, host=bool):
    """Backward pass fed by the trajectory, batch-minor.

    Args: t0 scalar; xs [N+1, nx, B] (the terminal state rides along
    unread), us [N, nu, B], Vx_T [nx, B], Vxx_T [nx, nx, B], lam [B].
    ``boxed=True`` runs the boxed stage on the bounds the aux group
    generates; ``host`` reads the plain boxed version's device flags on
    CPU tensors.
    Returns (ks [N, nu, B], Ks [N, nu, nx, B], dV [2, B], ok [B] bool).
    """
    N, nu, B = us.shape
    nx = xs.shape[1]
    dtype, device = xs.dtype, xs.device
    for name, a, shape in (("xs", xs, (N + 1, nx, B)), ("us", us, (N, nu, B)),
                           ("Vx_T", Vx_T, (nx, B)),
                           ("Vxx_T", Vxx_T, (nx, nx, B)), ("lam", lam, (B,))):
        _check(name, a, shape, dtype, device)
    if config.use_state_eq_second_derivative:
        raise NotImplementedError(
            "the remat backward is first-order: ROADMAP B1")
    if config.deriv_dtype != "same":
        raise ValueError("the remat backward evaluates the derivatives at "
                         "the solve dtype: deriv_dtype must be 'same'")
    if dtype not in DTYPES:
        raise ValueError(f"the remat backward takes float32/float64, got "
                         f"{dtype}")
    if boxed and nu > MAX_NU_BOXED:
        raise NotImplementedError(
            f"the boxed remat backward takes nu <= {MAX_NU_BOXED}: ROADMAP "
            f"B7")
    tileval.generate(problem, _kind(boxed), nx, nu, dtype)   # the gate
    t0 = torch.as_tensor(t0, dtype=dtype, device=device)
    if device.type == "cpu":
        return backward_remat_plain(problem, config, t0, xs, us, Vx_T,
                                    Vxx_T, lam, boxed, host)
    if device.type != "cuda":
        raise ValueError(f"backward_remat takes CPU or CUDA tensors, got "
                         f"{device}")
    out = launch(launcher(problem, nx, nu, dtype, boxed), problem, config,
                 t0, xs, us, Vx_T, Vxx_T, lam, boxed)
    if boxed:
        backward_remat.boxed_launches += 1
    else:
        backward_remat.launches += 1
    return out


backward_remat.launches = 0
backward_remat.boxed_launches = 0
