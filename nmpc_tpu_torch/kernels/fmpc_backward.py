"""Condensed PDIP Riccati backward of the batched FMPC solve: the CUDA
kernels' wrappers (TPU K8, K9, K10).

Replaces ``nmpc_tpu/kernels/fmpc_backward_pallas.py::backward_fmpc_pallas``
in its three variants, each a CUDA kernel that runs the whole N-stage
recursion of a batch lane with its (s, P, ok) carry in registers (LU
fallback ``csrc/linalg.cuh::gauss_jordan_inverse``):

* ``"stream"`` (K8, ``csrc/fmpc_backward.cuh``): a group of threads per
  lane running ``csrc/fmpc_stage.cuh::fmpc_stage_group``, each stage's 13
  fields brought into shared memory by a producer warp's TMA ring; the
  kernel forms the (s, nu) condensation itself from s, nu, g_bar, the
  masks and eps, so the wrapper launches nothing else (fields TMA does
  not take as they are are copied once, :func:`tma_fields`);
* ``"resident"`` (K9, ``csrc/fmpc_backward_resident.cuh``): K8's kernel
  with the whole horizon of a block's lanes brought into shared memory by
  one TMA box per field, for N <= 32 where it fits (:func:`resident_fits`);
  its inputs and its one launch are K8's;
* ``"packed"`` (K10, ``csrc/fmpc_backward_packed.cuh``): K8's loop with
  inputs from one ``[N, Fin, B]`` buffer (:func:`pack_fmpc_inputs`, after
  :func:`condensation`) fetched by TMA a chunk of stages at a time, and
  outputs to one ``[N, Fout, B]`` buffer (:func:`backward_fmpc_packed`).

Each is instantiated per (nx, nu, ng, dtype) in a small generated unit that
nvcc builds at first use without FMA contraction, so all three equal the
plain version bit for bit.  Past (nx, nu, ng) = (8, 4, 16)
(:func:`wide_shape`), up to (16, 16, 64), the units instantiate the wide
kernels instead (``csrc/fmpc_backward_wide.cuh``: K8 and K9,
``csrc/fmpc_backward_packed_wide.cuh``: K10), which run
``csrc/fmpc_stage_wide.cuh``'s stage on one lane a warp, each product
split by entries over the warp through shared memory; their launches are
counted apart (``wide_launches``, ``resident_wide_launches``).
``csrc/fmpc_group.cuh`` sizes the groups, rings and blocks; the headers
say what bounds each kernel on the card.

:func:`backward_fmpc_fused` is a drop-in for
``solvers/fmpc.py::_backward_bm``.  On CPU tensors it runs that plain
version (``"packed"`` through the pack and its inverse, so that the
offsets run on the CPU too); on CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from nmpc_tpu_torch.kernels.build import build_generated, load
from nmpc_tpu_torch.kernels.ddp_backward_fused import (_check, offsets,
                                                       pack_fields,
                                                       padded_fields,
                                                       padded_lanes,
                                                       unpack_fields)

# The largest (nx, nu, ng) a unit is instantiated for, and the largest of
# a narrow unit, which unrolls every stage field into registers (past it
# the wide units: fmpc_group.cuh::kFmpcWide).
MAX_NX, MAX_NU, MAX_NG = 16, 16, 64
NARROW_NX, NARROW_NU, NARROW_NG = 8, 4, 16
# the kernels' scalar types (the generated units' T)
DTYPES = {torch.float32: "float", torch.float64: "double"}
# No contraction of a*b + c into an FMA, so that the kernel rounds op by
# op as its plain version's separate torch ops do: the fp32 PDIP
# iteration is chaotic on diverging lanes, which amplify any difference.
FMPC_FLAGS = ("-fmad=false",)
_FIELDS = ("A", "B", "C", "D", "Lxx", "Luu", "Lxu", "x_bar", "Lx_bar",
           "Lu_bar")
VARIANTS = ("stream", "resident", "packed")
# The packed stage's fields (fmpc_backward_pallas.py::_IN_FIELDS,
# _OUT_FIELDS), and the resident kernel's limits: the TPU kernel's static
# unroll bound on N (_RESIDENT_MAX_N) and the H100's shared memory per
# block (csrc/fmpc_group.cuh::kResidentMaxN, row_group.cuh::kMaxBlockSmem).
# K8's and K9's threads per lane (fmpc_group.cuh::fmpc_group) and the
# fewest lanes of a block at that group (a warp's).
GROUP = 4
LEAST_LANES = 32 // GROUP
IN_FIELDS = ("A", "B", "C", "D", "Lxx", "Luu", "Lxu", "xb", "Lxb", "Lub",
             "nu_s", "tilde")
OUT_FIELDS = ("k", "K", "svec", "P")
RESIDENT_MAX_N = 32
MAX_SMEM_BYTES = 227 * 1024
# K9's and K10's threads per lane at the wide shapes (fmpc_group.cuh::
# kFmpcWideGroup) and the bounds of the wide blocks (their
# kFmpcWideMaxThreads, K8's kFmpcWideStreamThreads, kFmpcWideRowBytes and
# kFmpcWideRing, row_group.cuh's kMaxRowLanes, kFillBlocks, kMaxChunk,
# kWideBoxRows).
WIDE_GROUP = 32
_WIDE_MAX_THREADS, _STREAM_THREADS, _WIDE_RING = 256, 96, 2
_ROW_BYTES = 16
_MAX_ROW_LANES, _FILL_BLOCKS, _MAX_CHUNK, _BOX_ROWS = 32, 128, 32, 256
# The parts of a lane's wide stage that the profile build of K8 and K9
# times (csrc/fmpc_stage_wide.cuh::FmpcWidePhase), then the producer's two
# (its wait for an empty buffer, the issue of a chunk's boxes).
WIDE_PHASES = ("wait", "scale", "sums", "factor", "update", "store")
PRODUCER_PHASES = ("empty wait", "issue")


def kernel_supports(nx: int, nu: int, ng: int, dtype) -> bool:
    """Whether the kernel takes this shape and dtype: 1 <= nx <= 16,
    1 <= nu <= 16, 1 <= ng <= 64, float32 or float64 (any B and N; past
    (8, 4, 16) the wide units)."""
    return (1 <= nx <= MAX_NX and 1 <= nu <= MAX_NU and 1 <= ng <= MAX_NG
            and dtype in DTYPES)


def wide_shape(nx: int, nu: int, ng: int) -> bool:
    """Whether (nx, nu, ng) takes the wide units: past (8, 4, 16)
    (``csrc/fmpc_group.cuh::fmpc_wide``)."""
    return nx > NARROW_NX or nu > NARROW_NU or ng > NARROW_NG


def _round_up(v: int, q: int) -> int:
    return -(-v // q) * q


def _stage_sizes(nx, nu, ng):
    """The values of K8's 13 stage fields, in the order of its maps."""
    return (nx * nx, nx * nu, ng * nx, ng * nu, nx * nx, nu * nu, nx * nu,
            nx, nx, nu, ng, ng, ng)


def wide_boxes(size: int) -> tuple:
    """(pieces, box): a wide stage's field of ``size`` values arrives in
    ``pieces`` TMA boxes of ``box`` values, at most 256, a multiple of 8
    (``fmpc_group.cuh::fmpc_wide_pieces``, ``fmpc_wide_box``)."""
    pieces = -(-size // 256)
    return pieces, _round_up(-(-size // pieces), 8)


def wide_stage_values(nx: int, nu: int, ng: int) -> int:
    """Values of K8's and K9's wide stage in shared memory
    (``fmpc_group.cuh::FmpcWideLayout::F``): each field's boxes, one after
    another (984 at the masses' (12, 3, 30))."""
    return sum(p * box for p, box in map(wide_boxes,
                                         _stage_sizes(nx, nu, ng)))


def wide_scratch_values(nx: int, nu: int, ng: int) -> int:
    """Values of a lane's scratch of the wide stage
    (``fmpc_group.cuh::WideFmpcScratch::size``; 729 at the masses)."""
    xs, us = (nx + 1) | 1, nu | 1
    return (4 * nx + 3 * nx * nx + 2 * ng + 2 * nx * nu + nu * us
            + 2 * nu * xs + 3 * nu * nu + nu)


def wide_rule(nx: int, nu: int, ng: int, dtype, group: int | None = None):
    """The wide units' size rules at (nx, nu, ng, dtype) and ``group``
    threads a lane (None: K8's, :func:`stream_group`; K9's and K10's are
    ``WIDE_GROUP``), as ``fmpc_group.cuh::FmpcWideRule`` computes them: a
    namespace of G, F, Fin, stride, least, K8's max_lanes (least), ring
    and fits, K9's resident_fits(N), resident_max_lanes and
    resident_lanes(N, B), K10's packed_max_lanes, packed_chunk,
    packed_fits and packed_lanes(B), and the bytes of a block (K8's
    ``bytes(R, L)``, K9's ``resident_bytes(N, L)``, K10's
    ``packed_bytes(C, L)``)."""
    if group is None:
        group = stream_group(dtype)
    item = torch.empty((), dtype=dtype).element_size()
    F = wide_stage_values(nx, nu, ng)
    _, Fin, _, _ = field_offsets(nx, nu, ng)
    stride = _round_up(wide_scratch_values(nx, nu, ng), 128 // item)
    least = max(32 // group, 16 // item)

    def scratch(L):
        return L * stride * item

    def bytes_(R, L):
        return 128 + R * F * L * item + scratch(L)

    def resident_bytes(N, L):
        return _round_up(8 * N, 128) + N * F * L * item + scratch(L)

    def packed_bytes(C, L):
        rows = _round_up(C * Fin, _BOX_ROWS)
        return 128 + 2 * _round_up(rows * L * item, 128) + scratch(L)

    def most(size):
        L = _MAX_ROW_LANES
        while L > least and (L * group + 32 > _WIDE_MAX_THREADS
                             or size(L) > MAX_SMEM_BYTES):
            L //= 2
        return L

    def fill(top, B):
        L = top
        while L > least and -(-B // L) < _FILL_BLOCKS:
            L //= 2
        return L

    ring = _WIDE_RING
    while ring > 1 and bytes_(ring, least) > MAX_SMEM_BYTES:
        ring -= 1
    resident_max = most(lambda L: resident_bytes(1, L))
    packed_max = most(lambda L: packed_bytes(1, L))
    chunk = _MAX_CHUNK
    while chunk > 1 and packed_bytes(chunk, packed_max) > MAX_SMEM_BYTES:
        chunk -= 1

    def resident_lanes(N, B):
        L = fill(resident_max, B)
        while L > least and resident_bytes(N, L) > MAX_SMEM_BYTES:
            L //= 2
        return L

    return types.SimpleNamespace(
        G=group, F=F, Fin=Fin, stride=stride, least=least,
        max_lanes=least, ring=ring,
        fits=bytes_(1, least) <= MAX_SMEM_BYTES,
        resident_fits=lambda N: (1 <= N <= RESIDENT_MAX_N
                                 and resident_bytes(N, least)
                                 <= MAX_SMEM_BYTES),
        resident_max_lanes=resident_max, resident_lanes=resident_lanes,
        packed_max_lanes=packed_max, packed_chunk=chunk,
        packed_fits=packed_bytes(1, least) <= MAX_SMEM_BYTES,
        packed_lanes=lambda B: fill(packed_max, B), bytes=bytes_,
        resident_bytes=resident_bytes, packed_bytes=packed_bytes)


def stream_group(dtype) -> int:
    """K8's threads a lane at the wide shapes
    (``fmpc_group.cuh::kFmpcWideStreamGroup``): 2 consumer warps over the
    lanes of a 16-byte box row (16 at fp32, 32 at fp64); K9's is
    ``WIDE_GROUP``."""
    item = torch.empty((), dtype=dtype).element_size()
    return (_STREAM_THREADS - 32) // (_ROW_BYTES // item)


def field_offsets(nx: int, nu: int, ng: int):
    """(input offsets, Fin, output offsets, Fout) of the packed per-stage
    buffers (``fmpc_backward_pallas.py::_field_offsets``): each field
    row-major, in the order of ``IN_FIELDS`` / ``OUT_FIELDS``."""
    return offsets(_in_shapes(nx, nu, ng)) + offsets(_out_shapes(nx, nu))


def _in_shapes(nx, nu, ng):
    return dict(zip(IN_FIELDS, ((nx, nx), (nx, nu), (ng, nx), (ng, nu),
                                (nx, nx), (nu, nu), (nx, nu), (nx,), (nx,),
                                (nu,), (ng,), (ng,))))


def _out_shapes(nx, nu):
    return dict(zip(OUT_FIELDS, ((nu,), (nu, nx), (nx,), (nx, nx))))


def stream_stage_values(nx: int, nu: int, ng: int, itemsize: int,
                        group: int = GROUP) -> int:
    """Values of K8's and K9's stage in shared memory
    (``csrc/fmpc_group.cuh::FmpcStreamLayout`` at G = ``group``): the 13
    fields A, B, C, D, Lxx, Luu, Lxu, x_bar, Lx_bar, Lu_bar, s, nu, g_bar,
    each rounded up to a multiple of ``stage_align`` values (88 at the
    cart-pole's (4, 1, 4) fp32, 56 at the oscillator's (2, 1, 3))."""
    row = (32 // group) * itemsize
    q = 1 if row >= 128 else 128 // row
    sizes = (nx * nx, nx * nu, ng * nx, ng * nu, nx * nx, nu * nu, nx * nu,
             nx, nx, nu, ng, ng, ng)
    return sum(-(-size // q) * q for size in sizes)


def resident_fits(nx: int, nu: int, ng: int, N: int, dtype) -> bool:
    """Whether the resident kernel (K9) takes this shape: the shape and
    dtype K8 takes, N <= 32, and the horizon of a block of the fewest lanes
    within the 227 KB of shared memory a block may have
    (``fmpc_group.cuh::fmpc_resident_fits``: the oscillator (2, 1, 3) and
    the cart-pole (4, 1, 4) at every N <= 32 at both dtypes; at a wide
    shape with the lanes' scratch, ``FmpcWideRule::resident_fits``: the
    masses' (12, 3, 30) up to N = 14).  The card's counterpart of
    ``_pick_sub_resident``."""
    if not kernel_supports(nx, nu, ng, dtype) or not 1 <= N <= RESIDENT_MAX_N:
        return False
    if wide_shape(nx, nu, ng):
        return wide_rule(nx, nu, ng, dtype, WIDE_GROUP).resident_fits(N)
    return resident_block_fits(nx, nu, ng, N, dtype, GROUP, LEAST_LANES)


def resident_block_fits(nx: int, nu: int, ng: int, N: int, dtype,
                        group: int, lanes: int) -> bool:
    """Whether K9's horizon of N stages of ``lanes`` lanes at ``group``
    threads a lane fits a block's shared memory (``fmpc_group.cuh``:
    ``ring_bytes`` of one buffer)."""
    itemsize = dtype.itemsize
    buffer = N * stream_stage_values(nx, nu, ng, itemsize, group) * lanes
    return 128 + -(-buffer * itemsize // 128) * 128 <= MAX_SMEM_BYTES


def pack_fmpc_inputs(co, nu_s, tilde):
    """K10's input buffer [N, Fin, B] from the coefficients and the
    condensation scalings (the concatenate of ``backward_fmpc_pallas``
    :717-722)."""
    return pack_fields([getattr(co, name) for name in _FIELDS]
                       + [nu_s, tilde])


def unit_source(nx: int, nu: int, ng: int, dtype, variant: str = "stream",
                group: int | None = None, share: bool | None = None,
                lanes: int | None = None, profile: bool = False) -> str:
    """The unit instantiating the ``variant`` kernel at (nx, nu, ng, dtype)
    with the threads per lane of ``csrc/fmpc_group.cuh``'s rules, or
    ``group`` where a measurement asks for another, and with the group's
    rows of P A, P B and P x_bar exchanged or computed by every thread as
    its rule says, or as ``share`` says
    (``csrc/fmpc_stage.cuh::fmpc_stage_group``); K9 with the lanes per
    block of ``fmpc_resident_lanes``, or ``lanes``.  At a wide shape
    (:func:`wide_shape`) the wide kernels (``fmpc_backward_wide.cuh``,
    ``fmpc_backward_packed_wide.cuh``) at their rules' threads a lane
    (K8: :func:`stream_group`; K9, K10: ``WIDE_GROUP``), or
    ``group``, K9 at its rule's lanes a block, or ``lanes``; ``share``
    has no meaning there.  ``profile``: the wide K8's or K9's
    profile build (its launch takes a last pointer, the cycles' buffer of
    :func:`profile_values`)."""
    T = DTYPES[dtype]
    wide = "_wide" if wide_shape(nx, nu, ng) else ""
    if profile and not (wide and variant in ("stream", "resident")):
        raise ValueError("the profile build is the wide K8's and K9's")
    if wide:
        if share is not None:
            raise ValueError("the wide FMPC units exchange every row; share "
                             "does not apply")
        if profile and group is None:
            group = (stream_group(dtype) if variant == "stream"
                     else WIDE_GROUP)
        args = f"{T}, {nx}, {nu}, {ng}" + (
            "" if group is None else f", {group}") + (
            ", true" if profile else "")
    else:
        rule = "kFmpcPackedGroup" if variant == "packed" else "kFmpcGroup"
        g = f"nmpc::{rule}<{nx}, {nu}>" if group is None else str(group)
        sh = (f"nmpc::kFmpcShare<{nx}>" if share is None
              else "true" if share else "false")
        args = f"{T}, {nx}, {nu}, {ng}, {g}, {sh}"
    if variant == "packed":
        return (f"#include \"fmpc_backward_packed{wide}.cuh\"\n\n"
                f"extern \"C\" int fmpc_backward_launch(\n"
                f"    int N, int B, int ld, double dt, int break_if_llt_fails,\n"
                f"    int check_nan, const void* Pin, const void* sT,\n"
                f"    const void* PT, void* out, void* ok, void* finite,\n"
                f"    void* stream) {{\n"
                f"  return nmpc::launch_fmpc_backward_packed{wide}<{args}>(\n"
                f"      N, B, ld, dt, break_if_llt_fails, check_nan, Pin, sT, "
                f"PT, out, ok,\n      finite, stream);\n}}\n")
    header = ("fmpc_backward_wide.cuh" if wide else
              "fmpc_backward_resident.cuh" if variant == "resident" else
              "fmpc_backward.cuh")
    launch = (f"launch_fmpc_backward_resident{wide}<{args}>(\n"
              f"      {lanes or 0}, " if variant == "resident" else
              f"launch_fmpc_backward{wide}<{args}>(\n      ")
    return (f"#include \"{header}\"\n\n"
            f"extern \"C\" int fmpc_backward_launch(\n"
            f"    int N, int B, int ld, double dt, int break_if_llt_fails,\n"
            f"    int check_nan, const void* const* fields, const void* gms,\n"
            f"    int gms_ld, const void* eps, const void* LxT, const void* PT,\n"
            f"    void* ks, void* Ks, void* sv, void* Ps, void* ok,\n"
            f"    void* finite, void* stream"
            f"{', void* prof' if profile else ''}) {{\n"
            f"  return nmpc::{launch}N, B, ld, dt, break_if_llt_fails, "
            f"check_nan, fields, gms,\n      gms_ld, eps, LxT, PT, ks, Ks, "
            f"sv, Ps, ok, finite, stream{', prof' if profile else ''});"
            f"\n}}\n")


def unit_name(nx: int, nu: int, ng: int, dtype, variant: str = "stream",
              group: int | None = None, share: bool | None = None,
              lanes: int | None = None, profile: bool = False) -> str:
    kind = "" if variant == "stream" else f"_{variant}"
    kind += "_wide" if wide_shape(nx, nu, ng) else ""
    g = "" if group is None else f"_g{group}"
    sh = {None: "", True: "_share", False: "_redundant"}[share]
    ln = "" if lanes is None else f"_l{lanes}"
    pr = "_profile" if profile else ""
    return (f"fmpc_backward{kind}_{nx}x{nu}x{ng}_{str(dtype)[6:]}{g}{sh}{ln}"
            f"{pr}")


def bind(lib, variant: str = "stream", profile: bool = False):
    """The launch function of a loaded ``variant`` unit
    (:func:`unit_source`; K9's takes K8's arguments, the profile build one
    pointer more)."""
    i, d, p = ctypes.c_int, ctypes.c_double, ctypes.c_void_p
    fn = lib.fmpc_backward_launch
    fn.argtypes = ([i, i, i, d, i, i] + [p] * 7 if variant == "packed"
                   else [i, i, i, d, i, i, p, p, i] + [p] * (
                       11 if profile else 10))
    fn.restype = ctypes.c_int
    return fn


def profile_values(N: int, B: int) -> int:
    """The cycles a profile build of the wide K8 or K9 stores (int64):
    each (stage, lane)'s of each of ``WIDE_PHASES`` ([6][N][B]), then the
    producer's of each of ``PRODUCER_PHASES`` a chunk and block ([2][N]
    [blocks], in room for [2][N][B])."""
    return (len(WIDE_PHASES) + len(PRODUCER_PHASES)) * N * B


@functools.lru_cache(maxsize=32)
def launcher(nx: int, nu: int, ng: int, dtype, variant: str = "stream",
             group: int | None = None, share: bool | None = None,
             lanes: int | None = None):
    """The launch function of the ``variant`` unit at (nx, nu, ng, dtype),
    with ``group`` threads per lane, without ``share`` or (K9) with
    ``lanes`` lanes a block where a measurement asks for them."""
    return bind(load(build_generated(
        unit_name(nx, nu, ng, dtype, variant, group, share, lanes),
        unit_source(nx, nu, ng, dtype, variant, group, share, lanes),
        FMPC_FLAGS)), variant)


def condensation(co, ss, nus, gms, barrier_eps):
    """(nu_s, tilde) [N, ng, B]: the (s, nu) condensation scalings of every
    stage, zero on masked rows (``FmpcSolver.hpp:572-579``).  The plain
    version (``solvers/fmpc.py::_backward_bm``) and K10's path take them
    from here; K8 and K9 form the same bits in the kernel
    (``csrc/fmpc_stage.cuh::fmpc_condense``)."""
    gm3 = gms[:, :, None]
    nu_s = torch.where(gm3 > 0, nus / ss, 0.0)
    tilde = torch.where(gm3 > 0, nu_s * co.g_bar - nus
                        + barrier_eps[None, None, :] / ss, 0.0)
    return nu_s, tilde


def backward_fmpc_fused(problem, config, co, ss, nus, gms, barrier_eps,
                        variant: str = "stream"):
    """Condensed Riccati backward, batch-minor, by the CUDA kernel of
    ``variant`` (``"stream"``: K8, ``"resident"``: K9, which raises where
    :func:`resident_fits` does not hold, ``"packed"``: K10 between
    :func:`pack_fmpc_inputs` and the slicing of its output buffer).

    Args as ``_backward_bm``'s: ``co`` a ``_StCoeffs`` (contiguous fields),
    ss, nus [N, ng, B], gms [N, ng], barrier_eps [B].
    Returns (ks [N,nu,B], Ks [N,nu,nx,B], svecs [N+1,nx,B],
    Ps [N+1,nx,nx,B], ok [B] bool, finite [B] bool).
    """
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
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
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"backward_fmpc_fused takes CPU or CUDA tensors, "
                         f"got {device}")
    if variant == "resident" and not resident_fits(nx, nu, ng, N, dtype):
        least = (wide_rule(nx, nu, ng, dtype, WIDE_GROUP).least
                 if kernel_supports(
            nx, nu, ng, dtype) and wide_shape(nx, nu, ng) else LEAST_LANES)
        raise ValueError(
            f"the resident FMPC backward takes N <= {RESIDENT_MAX_N} within "
            f"{MAX_SMEM_BYTES} bytes of shared memory per {least} lanes; "
            f"got (nx, nu, ng) = ({nx}, {nu}, {ng}), N={N}, {dtype}")
    if variant == "packed":
        return _backward_packed_fields(problem, config, co, ss, nus, gms,
                                       barrier_eps)
    if device.type == "cpu":
        from nmpc_tpu_torch.solvers.fmpc import _backward_bm
        return _backward_bm(problem, config, co, ss, nus, gms, barrier_eps)
    _check_shape(nx, nu, ng, dtype)
    _check("barrier_eps", barrier_eps, (B,), dtype, device)
    if gms.dtype != dtype or gms.device != device:
        raise ValueError(f"gms must be {dtype} on {device}, got {gms.dtype} "
                         f"on {gms.device}")
    out = launch_stream(launcher(nx, nu, ng, dtype, variant), problem, config,
                        co, ss, nus, gms, barrier_eps)
    wide = "wide_" if wide_shape(nx, nu, ng) else ""
    counter = (f"resident_{wide}launches" if variant == "resident"
               else f"{wide}launches")
    setattr(backward_fmpc_fused, counter,
            getattr(backward_fmpc_fused, counter) + 1)
    return out


backward_fmpc_fused.launches = 0                # K8
backward_fmpc_fused.resident_launches = 0       # K9
backward_fmpc_fused.wide_launches = 0           # K8 at a wide shape
backward_fmpc_fused.resident_wide_launches = 0  # K9 at a wide shape
backward_fmpc_fused.padded_copies = 0           # a K8 / K9 field copied for TMA


def _outputs(N, nx, nu, B, dtype, device):
    """Empty (ks, Ks, svecs, Ps, ok, finite) of a K8 or K9 launch."""
    return ([torch.empty(shape, dtype=dtype, device=device) for shape in
             ((N, nu, B), (N, nu, nx, B), (N + 1, nx, B), (N + 1, nx, nx, B))]
            + [torch.empty((B,), dtype=torch.bool, device=device)
               for _ in range(2)])


def _raise_on(err, variant):
    if err != 0:
        raise RuntimeError(f"FMPC backward ({variant}) kernel launch failed: "
                           f"CUDA error {err}")


def tma_fields(co, ss, nus):
    """(K8's 13 fields as its tensor maps take them, their lane stride):
    A, B, C, D, Lxx, Luu, Lxu, x_bar, Lx_bar, Lu_bar, s, nu, g_bar, each as
    it is where its B is a multiple of 16 bytes and its address 16-byte
    aligned, else copied once into a buffer padded to the lane stride TMA
    takes (``ddp_backward_fused.padded_fields``); each copy adds one to
    ``backward_fmpc_fused.padded_copies``."""
    fields, ld, copies = padded_fields(
        [getattr(co, name) for name in _FIELDS] + [ss, nus, co.g_bar])
    backward_fmpc_fused.padded_copies += copies
    return fields, ld


def launch_stream(fn, problem, config, co, ss, nus, gms, barrier_eps,
                  prof=None):
    """One launch of the K8 or K9 unit function ``fn`` (:func:`launcher`) on
    checked CUDA inputs (the arguments of :func:`backward_fmpc_fused`),
    its fields as :func:`tma_fields` gives them, ``gms`` read with its row
    stride (0 where every stage has one mask row; a copy only if its rows
    are not contiguous); returns (ks, Ks, svecs, Ps, ok, finite) and raises
    on a CUDA error.  Counts no launch.  ``prof``: a profile build's
    cycles (int64, :func:`profile_values`)."""
    N, nx = co.A.shape[0], co.A.shape[1]
    nu, B = co.B.shape[2], barrier_eps.shape[0]
    device = barrier_eps.device
    outs = _outputs(N, nx, nu, B, barrier_eps.dtype, device)
    fields, ld = tma_fields(co, ss, nus)
    ptrs = (ctypes.c_void_p * len(fields))(*(a.data_ptr() for a in fields))
    if gms.shape[1] > 1 and gms.stride(1) != 1:
        gms = gms.contiguous()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(N, B, ld, float(problem.dt), int(config.break_if_llt_fails),
                 int(config.check_nan), ptrs, gms.data_ptr(), gms.stride(0),
                 barrier_eps.data_ptr(), co.Lx_bar_term.data_ptr(),
                 co.Lxx_term.data_ptr(), *(o.data_ptr() for o in outs),
                 stream, *(() if prof is None else (prof.data_ptr(),)))
    _raise_on(err, "stream or resident")
    return tuple(outs)


def _check_shape(nx, nu, ng, dtype):
    if not kernel_supports(nx, nu, ng, dtype):
        raise ValueError(
            f"the FMPC CUDA backward takes (nx, nu, ng) up to ({MAX_NX}, "
            f"{MAX_NU}, {MAX_NG}) and float32/float64; got ({nx}, {nu}, "
            f"{ng}) {dtype}")


def _backward_packed_fields(problem, config, co, ss, nus, gms, barrier_eps):
    """``variant="packed"``: the condensation, the pack, K10 (or its plain
    version) and the outputs sliced back, with the terminal row appended."""
    nx, nu, ng = co.A.shape[1], co.B.shape[2], co.C.shape[1]
    nu_s, tilde = condensation(co, ss, nus, gms, barrier_eps)
    s_T, P_T = -co.Lx_bar_term, co.Lxx_term
    out, ok, finite = backward_fmpc_packed(
        problem, config, pack_fmpc_inputs(co, nu_s, tilde), s_T, P_T, nx, nu,
        ng)
    o = unpack_fields(out, _out_shapes(nx, nu))
    svecs = torch.cat([o["svec"], s_T[None]])
    Ps = torch.cat([o["P"], P_T[None]])
    return o["k"], o["K"], svecs, Ps, ok, finite


def backward_fmpc_packed(problem, config, P_in, s_T, P_T, nx: int, nu: int,
                         ng: int):
    """K10: the recursion from the packed inputs P_in [N, Fin, B]
    (:func:`pack_fmpc_inputs`) and the terminal (s_T [nx, B],
    P_T [nx, nx, B]).  Returns (out [N, Fout, B] holding k, K, s, P of rows
    0 .. N-1 at the offsets of :func:`field_offsets`, ok [B] bool,
    finite [B] bool; finite covers the terminal row too).  On CPU tensors
    the plain version unpacks P_in, runs ``_riccati_condensed`` and packs
    its outputs."""
    N, B = P_in.shape[0], s_T.shape[-1]
    dtype, device = s_T.dtype, s_T.device
    _, Fin, _, Fout = field_offsets(nx, nu, ng)
    _check("P_in", P_in, (N, Fin, B), dtype, device)
    _check("s_T", s_T, (nx, B), dtype, device)
    _check("P_T", P_T, (nx, nx, B), dtype, device)
    if device.type == "cpu":
        return backward_fmpc_packed_plain(problem, config, P_in, s_T, P_T,
                                          nx, nu, ng)
    _check_shape(nx, nu, ng, dtype)
    padded, ld = padded_lanes(P_in)
    backward_fmpc_packed.padded_copies += padded is not P_in
    out = launch_packed(launcher(nx, nu, ng, dtype, "packed"), problem,
                        config, padded, ld, s_T, P_T, nx, nu, ng)
    if wide_shape(nx, nu, ng):
        backward_fmpc_packed.wide_launches += 1
    else:
        backward_fmpc_packed.launches += 1
    return out


def launch_packed(fn, problem, config, P_in, ld, s_T, P_T, nx: int, nu: int,
                  ng: int):
    """One launch of the K10 unit function ``fn`` (:func:`launcher`) on
    checked CUDA inputs, P_in [N, Fin, ld] (its first B lanes read);
    returns (out, ok, finite) and raises on a CUDA error.  Counts no
    launch."""
    N, B = P_in.shape[0], s_T.shape[-1]
    dtype, device = s_T.dtype, s_T.device
    _, _, _, Fout = field_offsets(nx, nu, ng)
    out = torch.empty((N, Fout, B), dtype=dtype, device=device)
    ok = torch.empty((B,), dtype=torch.bool, device=device)
    finite = torch.empty((B,), dtype=torch.bool, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(N, B, ld, float(problem.dt), int(config.break_if_llt_fails),
                 int(config.check_nan), P_in.data_ptr(), s_T.data_ptr(),
                 P_T.data_ptr(), out.data_ptr(), ok.data_ptr(),
                 finite.data_ptr(), stream)
    _raise_on(err, "packed")
    return out, ok, finite


backward_fmpc_packed.launches = 0           # K10
backward_fmpc_packed.wide_launches = 0      # K10 at a wide shape
backward_fmpc_packed.padded_copies = 0      # P_in copied for TMA


def backward_fmpc_packed_plain(problem, config, P_in, s_T, P_T, nx: int,
                               nu: int, ng: int):
    """K10's plain version: unpack P_in, run ``_riccati_condensed`` (the
    recursion of ``_backward_bm``) and pack its outputs."""
    from nmpc_tpu_torch.solvers.fmpc import _riccati_condensed
    N = P_in.shape[0]
    ks, Ks, svecs, Ps, ok, finite = _riccati_condensed(
        problem, config, unpack_fields(P_in, _in_shapes(nx, nu, ng)), s_T,
        P_T)
    return pack_fields([ks, Ks, svecs[:N], Ps[:N]]), ok, finite
