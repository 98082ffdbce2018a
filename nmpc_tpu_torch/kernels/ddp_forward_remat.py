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
the problem's step, and K7 with the one :func:`costs_chunk` names: each
thread reading its stage's references itself, a stage ahead into
registers, or ``csrc/fwd_ring.cuh``'s TMA ring of chunks of stages in
shared memory, which K7's alpha-threads of a lane share (references whose
lane stride or address TMA does not take are copied once, counted in
``forward_selected_remat.padded_copies`` and
``forward_costs_remat.padded_copies``).  The JAX
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


def _long_step(problem, nx: int, nu: int, dtype) -> bool:
    """Whether the problem's generated step calls one of ``_LONG_OPS``."""
    prog, outs = tileval.generate(problem, "forward", nx, nu,
                                  dtype).functions["step"]
    return any(v.op in _LONG_OPS for v in prog.live(outs))


@functools.lru_cache(maxsize=64)
def ref_chunk(problem, nx: int, nu: int, dtype) -> int:
    """K6's chunk of stages for ``problem``, as the H100 measured it
    (chip_smoke.py --qp-groups; PERF.md, Findings): 0, the one-stage
    register prefetch (the TPU kernel's design), for a generated step that
    calls a transcendental function (the cart-pole's sin and cos), a chain
    long enough to hide the loads of one stage ahead, which a deeper feed
    only adds work to; 8, ``csrc/fwd_ring.cuh``'s TMA ring of chunks of 8
    stages, for any other step (the vertical model's)."""
    return 0 if _long_step(problem, nx, nu, dtype) else 8


@functools.lru_cache(maxsize=64)
def costs_chunk(problem, nx: int, nu: int, dtype) -> int:
    """K7's chunk of stages for ``problem``, as the H100 measured it
    (chip_smoke.py --qp-groups; PERF.md, Findings): 0, each (alpha, lane)
    thread reading its references itself a stage ahead (the parent's
    kernel), for a step that calls a transcendental function, whose chain
    hides the alpha-threads' repeated reads; else ``csrc/fwd_ring.cuh``'s
    TMA ring, each lane's references brought into shared memory once for
    its alpha-threads, in chunks of 8 stages at fp32 and 4 at fp64."""
    if _long_step(problem, nx, nu, dtype):
        return 0
    return 8 if dtype == torch.float32 else 4


def _chunk_text(chunk, rule, nx, nu, dtype):
    """A unit's chunk of stages: ``chunk`` as given (a measurement's), or
    ``rule``'s within the ring's depth (``fwd_chunk``)."""
    if chunk is not None or not rule:
        return rule if chunk is None else chunk
    return (f"nmpc::fwd_chunk<{DTYPES[dtype]}>("
            f"nmpc::RefFields<{nx}, {nu}>::F, {rule})")


def unit_source(problem, nx: int, nu: int, dtype, chunk: int | None = None,
                costs: int | None = None) -> str:
    """The generated translation unit for ``problem`` at ``dtype``: K6 at
    the chunk of stages of :func:`ref_chunk` and K7 at that of
    :func:`costs_chunk` (each within the ring's depth, ``fwd_chunk``), or
    at ``chunk`` and ``costs`` where a measurement asks for others (0: each
    thread reads its references itself, one stage ahead)."""
    unit = tileval.generate(problem, "forward", nx, nu, dtype)
    t = f"{DTYPES[dtype]}, {nx}, {nu}"
    c = _chunk_text(chunk, ref_chunk(problem, nx, nu, dtype), nx, nu, dtype)
    k = _chunk_text(costs, costs_chunk(problem, nx, nu, dtype), nx, nu,
                    dtype)
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
            f"    int N, int B, int A, int ld, double dt, double n_dt,\n"
            f"    const void* xs, const void* us, const void* ks,\n"
            f"    const void* Ks, const void* alphas, const void* t0,\n"
            f"    void* csum, void* stream) {{\n"
            f"  return nmpc::launch_forward_costs<{t}, {k}>(\n"
            f"      N, B, A, ld, dt, n_dt, xs, us, ks, Ks, alphas, t0, csum, "
            f"stream);\n}}\n")


def unit_name(dtype, chunk: int | None = None,
              costs: int | None = None) -> str:
    c = "" if chunk is None else f"_c{chunk}"
    k = "" if costs is None else f"_k{costs}"
    return f"ddp_forward_remat_{str(dtype)[6:]}{c}{k}"


class Unit(NamedTuple):
    """A loaded unit's launch functions and K6's and K7's chunks of stages
    (0: each thread reads its references at lane stride B itself; else the
    TMA ring)."""
    selected: object
    costs: object
    chunk: int
    costs_chunk: int


def bind(lib, chunk: int, costs_chunk: int) -> Unit:
    """The :class:`Unit` of a loaded library built at ``chunk`` and
    ``costs_chunk`` (:func:`unit_source`)."""
    sel = lib.forward_selected_launch
    sel.argtypes = [ctypes.c_int] * 3 + [ctypes.c_double] * 2 + [
        ctypes.c_void_p] * 11
    sel.restype = ctypes.c_int
    costs = lib.forward_costs_launch
    costs.argtypes = [ctypes.c_int] * 4 + [ctypes.c_double] * 2 + [
        ctypes.c_void_p] * 8
    costs.restype = ctypes.c_int
    return Unit(sel, costs, chunk, costs_chunk)


@functools.lru_cache(maxsize=64)
def launchers(problem, nx: int, nu: int, dtype, chunk: int | None = None,
              costs: int | None = None) -> Unit:
    """The :class:`Unit` of ``problem`` at ``dtype``, K6 at
    :func:`ref_chunk`'s chunk and K7 at :func:`costs_chunk`'s, or at
    ``chunk`` and ``costs`` where a measurement asks for others."""
    lib = load(build_generated(unit_name(dtype, chunk, costs),
                               unit_source(problem, nx, nu, dtype, chunk,
                                           costs)))
    return bind(lib, ref_chunk(problem, nx, nu, dtype) if chunk is None
                else chunk,
                costs_chunk(problem, nx, nu, dtype) if costs is None
                else costs)


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
    unit = launchers(problem, nx, nu, xs.dtype)
    refs = (xs, us, ks, Ks)
    if unit.costs_chunk:
        refs, _, copies = padded_fields(refs)
        forward_costs_remat.padded_copies += copies
    out = launch_costs(unit, problem, t0, *refs, alphas, B)
    forward_costs_remat.launches += 1
    return out


def launch_costs(unit: Unit, problem, t0, xs, us, ks, Ks, alphas, B: int):
    """One launch of ``unit``'s K7 (:func:`launchers`) on checked CUDA
    inputs (those of :func:`forward_costs_remat`, t0 a device scalar; for
    the TMA ring, references whose lanes lie xs.shape[-1] values apart as
    ``padded_fields`` gives them) for B lanes; returns the cost sums [A, B]
    and raises on a CUDA error.  Counts no launch."""
    N, A = us.shape[0], alphas.shape[0]
    csum = torch.empty((A, B), dtype=xs.dtype, device=xs.device)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):
        err = unit.costs(N, B, A, xs.shape[-1], float(problem.dt),
                         N * problem.dt, xs.data_ptr(), us.data_ptr(),
                         ks.data_ptr(), Ks.data_ptr(), alphas.data_ptr(),
                         t0.data_ptr(), csum.data_ptr(), stream)
    _raise_on(err, "forward_costs_remat")
    return csum


forward_selected_remat.launches = 0
forward_selected_remat.padded_copies = 0   # a reference copied for TMA
forward_costs_remat.launches = 0
forward_costs_remat.padded_copies = 0      # a reference copied for TMA
