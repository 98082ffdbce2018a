"""Fused DDP line-search rollouts: the CUDA kernels' wrappers (TPU K6, K7).

Replace ``nmpc_tpu/kernels/ddp_forward_remat.py``:

* :func:`forward_selected_remat` (K6): the rollout at each lane's alpha,
  returning (xs, us, per-stage costs, cost sum);
* :func:`forward_costs_remat` (K7): the cost sum of every (alpha, lane)
  pair for an alpha schedule, the line-search sweep.

Both run the stage body of ``csrc/ddp_forward_remat.cuh`` on the
problem's dynamics and costs as generated by ``kernels/tileval.py``, in one
unit per (problem, dtype), compiled by nvcc at first use and bound through
ctypes.  A unit builds K6 with the one feed :func:`ref_chunk` names for
the problem's step: one stage ahead into registers, or
``csrc/fwd_ring.cuh``'s TMA ring of chunks of stages in shared memory
(references whose lane stride or address TMA does not take are copied
once, counted in ``forward_selected_remat.padded_copies``).  The JAX
kernels need ``B % 128 == 0``; these take any B.  Plain versions:
``solvers/stages.py::_forward_selected_lanes`` and
``_forward_costs_lanes`` with the cost sums at the solve dtype, which the
kernels require (``cdtype == dtype``, as the JAX solver does).

Each wrapper generates the problem's unit on any device, so a problem the
generator rejects raises :class:`TileEvalError` everywhere; then it runs
the plain version on CPU tensors and launches the kernel on CUDA tensors
(or raises).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from nmpc_tpu_torch.core.types import DDPConfig
from nmpc_tpu_torch.kernels import tileval
from nmpc_tpu_torch.kernels.build import build_generated, load
from nmpc_tpu_torch.kernels.ddp_backward_fused import _check, padded_fields
from nmpc_tpu_torch.kernels.ddp_backward_remat import DTYPES
from nmpc_tpu_torch.solvers.stages import (_forward_costs_lanes,
                                           _forward_selected_lanes)


def forward_remat_supported(problem, nx: int, nu: int, dtype) -> bool:
    """Whether the kernels take this problem at this dtype: float32 or
    float64 and dynamics / running / terminal costs the generator
    accepts."""
    return dtype in DTYPES and tileval.tile_supported(problem, "forward",
                                                      nx, nu, dtype)


# Calls of a generated step that make it a long dependent chain (each
# tens of instructions, with a branch to a slow path).  Measured on the
# H100: sin and cos (the cart-pole's step) against a step with none (the
# vertical model's); the others are classed with them unmeasured.
_LONG_OPS = frozenset(("sin", "cos", "tan", "exp", "log", "tanh", "asin",
                       "acos", "atan", "sinh", "cosh", "log1p", "expm1",
                       "pow", "atan2"))


@functools.lru_cache(maxsize=64)
def ref_chunk(problem, nx: int, nu: int, dtype) -> int:
    """K6's chunk of stages for ``problem``, as the H100 measured it
    (chip_smoke.py --qp-groups; PERF.md, Findings): 0, the one-stage
    register prefetch (the TPU kernel's design), for a generated step that
    calls a transcendental function (the cart-pole's sin and cos), a chain
    long enough to hide the loads of one stage ahead, which a deeper feed
    only adds work to; 8, ``csrc/fwd_ring.cuh``'s TMA ring of chunks of 8
    stages, for any other step (the vertical model's)."""
    prog, outs = tileval.generate(problem, "forward", nx, nu,
                                  dtype).functions["step"]
    return 0 if any(v.op in _LONG_OPS for v in prog.live(outs)) else 8


def unit_source(problem, nx: int, nu: int, dtype,
                chunk: int | None = None) -> str:
    """The generated translation unit for ``problem`` at ``dtype``: K6 at
    the chunk of stages of :func:`ref_chunk` (within the ring's depth,
    ``fwd_chunk``), or at ``chunk`` where a measurement asks for another
    (0: the register prefetch), and K7."""
    unit = tileval.generate(problem, "forward", nx, nu, dtype)
    t = f"{DTYPES[dtype]}, {nx}, {nu}"
    c = chunk if chunk is not None else ref_chunk(problem, nx, nu, dtype)
    if chunk is None and c:
        c = (f"nmpc::fwd_chunk<{DTYPES[dtype]}>("
             f"nmpc::RefFields<{nx}, {nu}>::F, {c})")
    return (f"{unit.cpp}\n#include \"ddp_forward_remat.cuh\"\n\n"
            f"extern \"C\" int forward_selected_launch(\n"
            f"    int N, int B, int ld, double dt, double n_dt,\n"
            f"    const void* xs, const void* us, const void* ks,\n"
            f"    const void* Ks, const void* alpha, const void* t0,\n"
            f"    void* xs_out, void* us_out, void* costs, void* csum,\n"
            f"    void* stream) {{\n"
            f"  return nmpc::launch_forward_selected<{t}, {c}>(\n"
            f"      N, B, ld, dt, n_dt, xs, us, ks, Ks, alpha, t0, xs_out, "
            f"us_out,\n      costs, csum, stream);\n}}\n\n"
            f"extern \"C\" int forward_costs_launch(\n"
            f"    int N, int B, int A, double dt, double n_dt, const void* xs,"
            f"\n    const void* us, const void* ks, const void* Ks,\n"
            f"    const void* alphas, const void* t0, void* csum,\n"
            f"    void* stream) {{\n"
            f"  return nmpc::launch_forward_costs<{t}>(\n"
            f"      N, B, A, dt, n_dt, xs, us, ks, Ks, alphas, t0, csum, "
            f"stream);\n}}\n")


def unit_name(dtype, chunk: int | None = None) -> str:
    c = "" if chunk is None else f"_c{chunk}"
    return f"ddp_forward_remat_{str(dtype)[6:]}{c}"


class Unit(NamedTuple):
    """A loaded unit's launch functions and K6's chunk of stages (0: the
    register prefetch, which reads its references at lane stride B; else
    the TMA ring)."""
    selected: object
    costs: object
    chunk: int


def bind(lib, chunk: int) -> Unit:
    """The :class:`Unit` of a loaded library built at ``chunk``
    (:func:`unit_source`)."""
    sel = lib.forward_selected_launch
    sel.argtypes = [ctypes.c_int] * 3 + [ctypes.c_double] * 2 + [
        ctypes.c_void_p] * 11
    sel.restype = ctypes.c_int
    costs = lib.forward_costs_launch
    costs.argtypes = [ctypes.c_int] * 3 + [ctypes.c_double] * 2 + [
        ctypes.c_void_p] * 8
    costs.restype = ctypes.c_int
    return Unit(sel, costs, chunk)


@functools.lru_cache(maxsize=64)
def launchers(problem, nx: int, nu: int, dtype,
              chunk: int | None = None) -> Unit:
    """The :class:`Unit` of ``problem`` at ``dtype``, K6 at
    :func:`ref_chunk`'s chunk or at ``chunk`` where a measurement asks for
    another."""
    lib = load(build_generated(unit_name(dtype, chunk),
                               unit_source(problem, nx, nu, dtype, chunk)))
    return bind(lib, ref_chunk(problem, nx, nu, dtype) if chunk is None
                else chunk)


def _prepare(problem, t0, xs, us, ks, Ks, name):
    """Check the shared inputs, run the generator's gate, and return
    (N, nx, nu, B, t0 as a device scalar, launch on CUDA?)."""
    N, nu, B = us.shape
    nx = xs.shape[1]
    dtype, device = xs.dtype, xs.device
    for arg, a, shape in (("xs", xs, (N + 1, nx, B)), ("us", us, (N, nu, B)),
                          ("ks", ks, (N, nu, B)),
                          ("Ks", Ks, (N, nu, nx, B))):
        _check(arg, a, shape, dtype, device)
    if dtype not in DTYPES:
        raise ValueError(f"{name} takes float32/float64, got {dtype}")
    tileval.generate(problem, "forward", nx, nu, dtype)   # the gate
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {device}")
    t0 = torch.as_tensor(t0, dtype=dtype, device=device)
    return N, nx, nu, B, t0, device.type == "cuda"


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def forward_selected_remat(problem, config: DDPConfig, t0, xs, us, ks, Ks,
                           alpha):
    """Rollout at each lane's alpha [B], batch-minor: xs [N+1, nx, B],
    us / ks [N, nu, B], Ks [N, nu, nx, B].  Returns (xs_new [N+1, nx, B],
    us_new [N, nu, B], costs [N+1, B], cost_sum [B]), the sum in horizon
    order at the solve dtype."""
    N, nx, nu, B, t0, on_card = _prepare(problem, t0, xs, us, ks, Ks,
                                         "forward_selected_remat")
    _check("alpha", alpha, (B,), xs.dtype, xs.device)
    if not on_card:
        return _forward_selected_lanes(problem, config, t0, xs, us, ks, Ks,
                                       alpha, xs.dtype)
    unit = launchers(problem, nx, nu, xs.dtype)
    refs = (xs, us, ks, Ks)
    if unit.chunk:
        refs, _, copies = padded_fields(refs)
        forward_selected_remat.padded_copies += copies
    out = launch_selected(unit, problem, t0, *refs, alpha)
    forward_selected_remat.launches += 1
    return out


def launch_selected(unit: Unit, problem, t0, xs, us, ks, Ks, alpha):
    """One launch of ``unit``'s K6 (:func:`launchers`) on checked CUDA
    inputs (those of :func:`forward_selected_remat`, t0 a device scalar;
    for the TMA ring, references whose lanes lie xs.shape[-1] values
    apart as :func:`~nmpc_tpu_torch.kernels.ddp_backward_fused.
    padded_fields` gives them); returns (xs_new, us_new, costs, cost_sum)
    and raises on a CUDA error.  Counts no launch."""
    N, nu = us.shape[:2]
    nx, B = xs.shape[1], alpha.shape[0]
    new = lambda *shape: torch.empty(shape, dtype=xs.dtype, device=xs.device)
    xs_new, us_new, costs, csum = (new(N + 1, nx, B), new(N, nu, B),
                                   new(N + 1, B), new(B))
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):
        err = unit.selected(N, B, xs.shape[-1], float(problem.dt),
                            N * problem.dt, xs.data_ptr(), us.data_ptr(),
                            ks.data_ptr(), Ks.data_ptr(), alpha.data_ptr(),
                            t0.data_ptr(), xs_new.data_ptr(),
                            us_new.data_ptr(), costs.data_ptr(),
                            csum.data_ptr(), stream)
    _raise_on(err, "forward_selected_remat")
    return xs_new, us_new, costs, csum


def forward_costs_remat(problem, config: DDPConfig, t0, xs, us, ks, Ks,
                        alphas):
    """Cost sums [A, B] of the rollouts at every alpha of ``alphas`` [A]
    (a tensor on the arrays' device), batch-minor inputs as
    :func:`forward_selected_remat`; each sum in horizon order at the solve
    dtype, by the same stage body."""
    N, nx, nu, B, t0, on_card = _prepare(problem, t0, xs, us, ks, Ks,
                                         "forward_costs_remat")
    A = alphas.shape[0]
    _check("alphas", alphas, (A,), xs.dtype, xs.device)
    if not on_card:
        return _forward_costs_lanes(problem, config, t0, xs, us, ks, Ks,
                                    alphas, xs.dtype)
    csum = torch.empty((A, B), dtype=xs.dtype, device=xs.device)
    launch = launchers(problem, nx, nu, xs.dtype).costs
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):
        err = launch(N, B, A, float(problem.dt), N * problem.dt,
                     xs.data_ptr(), us.data_ptr(), ks.data_ptr(),
                     Ks.data_ptr(), alphas.data_ptr(), t0.data_ptr(),
                     csum.data_ptr(), stream)
    _raise_on(err, "forward_costs_remat")
    forward_costs_remat.launches += 1
    return csum


forward_selected_remat.launches = 0
forward_selected_remat.padded_copies = 0   # a reference copied for TMA
forward_costs_remat.launches = 0
