"""Condensed PDIP Riccati backward of the batched FMPC solve: the CUDA
kernel's wrapper (TPU K8).

Replaces ``nmpc_tpu/kernels/fmpc_backward_pallas.py::backward_fmpc_pallas``.
Source: ``csrc/fmpc_backward.cuh`` (one thread per lane, the (s, P, ok)
carry in registers; the stage ``csrc/fmpc_stage.cuh::fmpc_stage``, the LU
fallback ``csrc/linalg.cuh::gauss_jordan_inverse``), instantiated per
(nx, nu, ng, dtype) in a small generated unit that nvcc builds at first use
without FMA contraction.  The header says what bounds it on the card.

:func:`backward_fmpc_fused` is a drop-in for
``solvers/fmpc.py::_backward_bm``.  On CPU tensors it runs that plain
version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nmpc_tpu_torch.kernels.build import build_generated, load
from nmpc_tpu_torch.kernels.ddp_backward_fused import _check

# The largest (nx, nu, ng) a unit is instantiated for: every stage field
# is unrolled into registers.
MAX_NX, MAX_NU, MAX_NG = 8, 4, 16
# the kernels' scalar types (the generated units' T)
DTYPES = {torch.float32: "float", torch.float64: "double"}
# No contraction of a*b + c into an FMA, so that the kernel rounds op by
# op as its plain version's separate torch ops do: the fp32 PDIP
# iteration is chaotic on diverging lanes, which amplify any difference.
FMPC_FLAGS = ("-fmad=false",)
_FIELDS = ("A", "B", "C", "D", "Lxx", "Luu", "Lxu", "x_bar", "Lx_bar",
           "Lu_bar")


def kernel_supports(nx: int, nu: int, ng: int, dtype) -> bool:
    """Whether the kernel takes this shape and dtype: 1 <= nx <= 8,
    1 <= nu <= 4, 1 <= ng <= 16, float32 or float64 (any B and N)."""
    return (1 <= nx <= MAX_NX and 1 <= nu <= MAX_NU and 1 <= ng <= MAX_NG
            and dtype in DTYPES)


def unit_source(nx: int, nu: int, ng: int, dtype) -> str:
    """The unit instantiating the kernel at (nx, nu, ng, dtype); the fp64
    units load each stage when they need it (no prefetch)."""
    prefetch = "true" if dtype == torch.float32 else "false"
    return (f"#include \"fmpc_backward.cuh\"\n\n"
            f"extern \"C\" int fmpc_backward_launch(\n"
            f"    int N, int B, double dt, int break_if_llt_fails,\n"
            f"    int check_nan, const void* const* fields, const void* sT,\n"
            f"    const void* PT, void* ks, void* Ks, void* sv, void* Ps,\n"
            f"    void* ok, void* finite, void* stream) {{\n"
            f"  return nmpc::launch_fmpc_backward<{DTYPES[dtype]}, {nx}, "
            f"{nu}, {ng}, {prefetch}>(\n      N, B, dt, break_if_llt_fails, "
            f"check_nan, fields, sT, PT, ks, Ks, sv, Ps,\n      ok, finite, "
            f"stream);\n}}\n")


def unit_name(nx: int, nu: int, ng: int, dtype) -> str:
    return f"fmpc_backward_{nx}x{nu}x{ng}_{str(dtype)[6:]}"


@functools.lru_cache(maxsize=32)
def _launcher(nx: int, nu: int, ng: int, dtype):
    lib = load(build_generated(unit_name(nx, nu, ng, dtype),
                               unit_source(nx, nu, ng, dtype), FMPC_FLAGS))
    fn = lib.fmpc_backward_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_double,
                    ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10)
    fn.restype = ctypes.c_int
    return fn


def condensation(co, ss, nus, gms, barrier_eps):
    """(nu_s, tilde) [N, ng, B]: the (s, nu) condensation scalings of every
    stage, zero on masked rows (``FmpcSolver.hpp:572-579``).  The kernel
    and its plain version (``solvers/fmpc.py::_backward_bm``) both take
    them from here, so both start from the same bits."""
    gm3 = gms[:, :, None]
    nu_s = torch.where(gm3 > 0, nus / ss, 0.0)
    tilde = torch.where(gm3 > 0, nu_s * co.g_bar - nus
                        + barrier_eps[None, None, :] / ss, 0.0)
    return nu_s, tilde


def backward_fmpc_fused(problem, config, co, ss, nus, gms, barrier_eps):
    """Condensed Riccati backward, batch-minor, by the CUDA kernel.

    Args as ``_backward_bm``'s: ``co`` a ``_StCoeffs`` (contiguous fields),
    ss, nus [N, ng, B], gms [N, ng], barrier_eps [B].
    Returns (ks [N,nu,B], Ks [N,nu,nx,B], svecs [N+1,nx,B],
    Ps [N+1,nx,nx,B], ok [B] bool, finite [B] bool).
    """
    N, nx = co.A.shape[0], co.A.shape[1]
    nu, ng = co.B.shape[2], co.C.shape[1]
    B = barrier_eps.shape[0]
    dtype, device = barrier_eps.dtype, barrier_eps.device
    shapes = {"A": (N, nx, nx, B), "B": (N, nx, nu, B), "C": (N, ng, nx, B),
              "D": (N, ng, nu, B), "Lxx": (N, nx, nx, B),
              "Luu": (N, nu, nu, B), "Lxu": (N, nx, nu, B),
              "x_bar": (N, nx, B), "g_bar": (N, ng, B), "Lx_bar": (N, nx, B),
              "Lu_bar": (N, nu, B), "Lx_bar_term": (nx, B),
              "Lxx_term": (nx, nx, B)}
    for name, shape in shapes.items():
        _check(name, getattr(co, name), shape, dtype, device)
    _check("ss", ss, (N, ng, B), dtype, device)
    _check("nus", nus, (N, ng, B), dtype, device)
    if tuple(gms.shape) != (N, ng):
        raise ValueError(f"gms has shape {tuple(gms.shape)}, expected "
                         f"{(N, ng)}")
    if device.type == "cpu":
        from nmpc_tpu_torch.solvers.fmpc import _backward_bm
        return _backward_bm(problem, config, co, ss, nus, gms, barrier_eps)
    if device.type != "cuda":
        raise ValueError(f"backward_fmpc_fused takes CPU or CUDA tensors, "
                         f"got {device}")
    if not kernel_supports(nx, nu, ng, dtype):
        raise ValueError(
            f"the FMPC CUDA backward takes nx <= {MAX_NX}, nu <= {MAX_NU}, "
            f"ng <= {MAX_NG} and float32/float64; got ({nx}, {nu}, {ng}) "
            f"{dtype}")

    nu_s, tilde = condensation(co, ss, nus, gms, barrier_eps)
    s_T = -co.Lx_bar_term
    ks = torch.empty((N, nu, B), dtype=dtype, device=device)
    Ks = torch.empty((N, nu, nx, B), dtype=dtype, device=device)
    svecs = torch.empty((N + 1, nx, B), dtype=dtype, device=device)
    Ps = torch.empty((N + 1, nx, nx, B), dtype=dtype, device=device)
    ok = torch.empty((B,), dtype=torch.bool, device=device)
    finite = torch.empty((B,), dtype=torch.bool, device=device)
    ins = [getattr(co, name) for name in _FIELDS] + [nu_s, tilde]
    fields = (ctypes.c_void_p * 12)(*(a.data_ptr() for a in ins))
    launch = _launcher(nx, nu, ng, dtype)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = launch(N, B, float(problem.dt), int(config.break_if_llt_fails),
                     int(config.check_nan), fields, s_T.data_ptr(),
                     co.Lxx_term.data_ptr(), ks.data_ptr(), Ks.data_ptr(),
                     svecs.data_ptr(), Ps.data_ptr(), ok.data_ptr(),
                     finite.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"FMPC backward kernel launch failed: CUDA error "
                           f"{err}")
    backward_fmpc_fused.launches += 1
    return ks, Ks, svecs, Ps, ok, finite


backward_fmpc_fused.launches = 0
