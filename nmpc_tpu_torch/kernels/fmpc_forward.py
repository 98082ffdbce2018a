"""FMPC forward Δx/Δu recursion: its plain version and the CUDA kernel's
wrapper (TPU K11).

Replaces ``nmpc_tpu/kernels/fmpc_forward_pallas.py::
forward_fmpc_deltas_pallas``.  Source: ``csrc/fmpc_forward.cuh`` (a group
of threads per lane, dx in registers, the coefficients of the next chunks
of stages fed into shared memory by ``csrc/fwd_ring.cuh``'s TMA ring),
instantiated per (nx, nu, dtype) in a small generated unit that nvcc
builds at first use without FMA contraction.

:func:`forward_fmpc_deltas_fused` takes the plain version's arguments.  On
CPU tensors it runs :func:`forward_fmpc_deltas_plain`; on CUDA tensors it
launches the kernel or raises.  A field whose lane stride or address TMA
does not take (B = 1023 at fp32, a view at an offset) is copied once to a
padded stride, counted in ``forward_fmpc_deltas_fused.padded_copies``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nmpc_tpu_torch.kernels.build import build_generated, load
from nmpc_tpu_torch.kernels.ddp_backward import _mv
from nmpc_tpu_torch.kernels.ddp_backward_fused import _check, padded_fields
from nmpc_tpu_torch.kernels.fmpc_backward import (DTYPES, FMPC_FLAGS, MAX_NU,
                                                  MAX_NX, NARROW_NU,
                                                  NARROW_NX)


def forward_kernel_supports(nx: int, nu: int, dtype) -> bool:
    """Whether the kernel takes this shape and dtype: 1 <= nx <= 16,
    1 <= nu <= 16, float32 or float64 (any B and N)."""
    return 1 <= nx <= MAX_NX and 1 <= nu <= MAX_NU and dtype in DTYPES


def forward_wide_shape(nx: int, nu: int) -> bool:
    """Whether (nx, nu) passes (8, 4), where the kernel's group of
    threads splits the rows of du too (``csrc/fmpc_forward.cuh::
    kFmpcFwdWide``); its launches there are counted apart."""
    return nx > NARROW_NX or nu > NARROW_NU


def forward_fmpc_deltas_plain(A, Bm, xb, ks, Ks, dx0):
    """The recursion ``du = K dx + k``, ``dx' = A dx + B du + x_bar``
    (``FmpcSolver.hpp:668-708``), batch-minor: A [N,nx,nx,B], Bm
    [N,nx,nu,B], xb [N,nx,B], ks [N,nu,B], Ks [N,nu,nx,B], dx0 [nx,B] ->
    (dxs [N+1,nx,B], dus [N,nu,B]); dxs[i] is the delta before stage i,
    dxs[N] the final carry."""
    dx, dxs, dus = dx0, [], []
    for i in range(A.shape[0]):
        du = _mv(Ks[i], dx) + ks[i]                          # (2.36)
        dxs.append(dx)
        dus.append(du)
        dx = _mv(A[i], dx) + _mv(Bm[i], du) + xb[i]          # (2.26b)
    dxs.append(dx)
    return torch.stack(dxs), torch.stack(dus)


def unit_source(nx: int, nu: int, dtype, group: int | None = None,
                chunk: int | None = None) -> str:
    """The unit instantiating the kernel at (nx, nu, dtype), at the
    header's threads per lane and chunk of stages (``kFmpcFwdGroup``,
    ``fmpc_fwd_chunk``), or at ``group`` and ``chunk`` (both) where a
    measurement asks for others."""
    T = DTYPES[dtype]
    g = "" if group is None else f", {group}, {chunk}"
    return (f"#include \"fmpc_forward.cuh\"\n\n"
            f"extern \"C\" int fmpc_forward_launch(\n"
            f"    int N, int B, int ld, const void* A, const void* Bm,\n"
            f"    const void* xb, const void* ks, const void* Ks,\n"
            f"    const void* dx0, void* dxs, void* dus, void* stream) {{\n"
            f"  return nmpc::launch_fmpc_forward<{T}, {nx}, {nu}{g}>(\n"
            f"      N, B, ld, A, Bm, xb, ks, Ks, dx0, dxs, dus, stream);\n"
            f"}}\n")


def unit_name(nx: int, nu: int, dtype, group: int | None = None,
              chunk: int | None = None) -> str:
    g = "" if group is None else f"_g{group}"
    c = "" if chunk is None else f"_c{chunk}"
    return f"fmpc_forward_{nx}x{nu}_{str(dtype)[6:]}{g}{c}"


def bind(lib):
    """The launch function of a loaded unit (:func:`unit_source`)."""
    fn = lib.fmpc_forward_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 9
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=32)
def launcher(nx: int, nu: int, dtype, group: int | None = None,
             chunk: int | None = None):
    """The launch function of the unit at (nx, nu, dtype), with ``group``
    and ``chunk`` where a measurement asks for them."""
    return bind(load(build_generated(
        unit_name(nx, nu, dtype, group, chunk),
        unit_source(nx, nu, dtype, group, chunk), FMPC_FLAGS)))


def launch(fn, A, Bm, xb, ks, Ks, dx0):
    """One launch of the unit function ``fn`` (:func:`launcher`) on checked
    CUDA inputs whose fields TMA takes as they are (their lanes
    A.shape[-1] values apart: :func:`~nmpc_tpu_torch.kernels.
    ddp_backward_fused.padded_fields`); returns (dxs, dus) and raises on a
    CUDA error.  Counts no launch."""
    N, nx, nu, B = A.shape[0], A.shape[1], Bm.shape[2], dx0.shape[-1]
    dtype, device = dx0.dtype, dx0.device
    dxs = torch.empty((N + 1, nx, B), dtype=dtype, device=device)
    dus = torch.empty((N, nu, B), dtype=dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(N, B, A.shape[-1], A.data_ptr(), Bm.data_ptr(),
                 xb.data_ptr(), ks.data_ptr(), Ks.data_ptr(), dx0.data_ptr(),
                 dxs.data_ptr(), dus.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"FMPC forward kernel launch failed: CUDA error "
                           f"{err}")
    return dxs, dus


def forward_fmpc_deltas_fused(A, Bm, xb, ks, Ks, dx0):
    """:func:`forward_fmpc_deltas_plain` by the CUDA kernel (same arguments
    and results, every input contiguous)."""
    N, nx = A.shape[0], A.shape[1]
    nu = Bm.shape[2]
    B = dx0.shape[-1]
    dtype, device = dx0.dtype, dx0.device
    for name, a, shape in (("A", A, (N, nx, nx, B)), ("Bm", Bm, (N, nx, nu, B)),
                           ("xb", xb, (N, nx, B)), ("ks", ks, (N, nu, B)),
                           ("Ks", Ks, (N, nu, nx, B)), ("dx0", dx0, (nx, B))):
        _check(name, a, shape, dtype, device)
    if device.type == "cpu":
        return forward_fmpc_deltas_plain(A, Bm, xb, ks, Ks, dx0)
    if device.type != "cuda":
        raise ValueError(f"forward_fmpc_deltas_fused takes CPU or CUDA "
                         f"tensors, got {device}")
    if not forward_kernel_supports(nx, nu, dtype):
        raise ValueError(f"the FMPC CUDA forward takes (nx, nu) up to "
                         f"({MAX_NX}, {MAX_NU}) and float32/float64; got "
                         f"({nx}, {nu}) {dtype}")
    fields, _, copies = padded_fields((A, Bm, xb, ks, Ks))
    forward_fmpc_deltas_fused.padded_copies += copies
    dxs, dus = launch(launcher(nx, nu, dtype), *fields, dx0)
    if forward_wide_shape(nx, nu):
        forward_fmpc_deltas_fused.wide_launches += 1
    else:
        forward_fmpc_deltas_fused.launches += 1
    return dxs, dus


forward_fmpc_deltas_fused.launches = 0
forward_fmpc_deltas_fused.wide_launches = 0   # past (8, 4)
forward_fmpc_deltas_fused.padded_copies = 0   # a field copied for TMA
