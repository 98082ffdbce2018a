"""Fused DDP Riccati backward: the hand-written CUDA kernels' wrappers.

Replaces ``nmpc_tpu/kernels/ddp_backward_pallas.py::backward_pallas`` (the
fused Pallas TPU kernel) in its three DMA modes, each a CUDA kernel that
runs the whole N-stage recursion of a batch lane on a group of threads
(``csrc/riccati_stage.cuh::riccati_stage_group``, ``kRowGroup`` threads a
lane) with its carry in registers, in one loop that reads each stage from
shared memory (``csrc/ddp_backward.cuh::group_backward``); the modes differ
in how a stage gets there, and each source's header says what bounds it
on the card and what its design does about that:

* ``"stage"`` (K1, ``csrc/ddp_backward.cuh``): a ring of one-stage
  buffers per block, each filled by a producer warp with seven TMA boxes,
  one per field (a tensor map per field; fields whose lanes or address
  TMA does not take are copied once by :func:`tma_fields`); at a
  :func:`wide_shape` (past the narrow kernels' sizes: the centroidal
  model's (9, 16)) the same block and ring from
  ``csrc/ddp_backward_wide.cuh``, whose stage
  (``csrc/riccati_stage_wide.cuh``) splits the input-sized work by rows
  over 32 threads a lane through shared memory;
* ``"chunked"`` (K2, ``csrc/ddp_backward_chunked.cuh``): two slots of C
  stages per warp filled with ``cp.async``, double-buffered by chunk
  (``_backward_pallas_call_chunked``), the threads of a lane splitting its
  values; at a :func:`wide_shape` the same slots feeding K1-wide's stage
  and lanes (``csrc/ddp_backward_chunked_wide.cuh``);
* ``"packed"`` (K3, ``csrc/ddp_backward_packed.cuh``): the fields read
  from one ``[N, F, B]`` buffer built by :func:`pack_derivs`
  (``_backward_pallas_call_packed``), fetched by TMA a chunk of stages at
  a time into a ring of buffers; at a :func:`wide_shape` K1-wide's block
  whose producer warp fills a ring of two chunks of the buffer's rows
  (``csrc/ddp_backward_packed_wide.cuh``).

``csrc/row_group.cuh`` sizes every ring, slot and block.  Each is
instantiated per (nx, nu, dtype) in a small generated unit that nvcc
builds at first use with ``UNIT_FLAGS`` (``-fmad=false``: no product is
contracted into an FMA, so the three agree bit for bit by construction
and the fp32 solve's decisions follow the plain path's).

:func:`backward_fused` is a drop-in for
``kernels/ddp_backward.py::backward_stacked`` (same arguments, same
batch-minor layout, ok as bool).  On CPU tensors it runs that plain twin
(``"packed"`` through :func:`pack_derivs` and its inverse, so that the
offsets run on the CPU too); on CUDA tensors it launches the kernel or
raises.  Nothing here builds or touches CUDA until the first CUDA call, so
the module imports without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from nmpc_tpu_torch.core.types import DDPConfig
from nmpc_tpu_torch.kernels.build import build_generated, load
from nmpc_tpu_torch.kernels.ddp_backward import StackedDerivs, backward_stacked

# The largest (nx, nu) a unit is instantiated for, in every mode: the
# centroidal model's (9, 16) (F = 731 values a stage).  Past the narrow
# kernels' sizes (MAX_NX_CHUNKED, MAX_NU_CHUNKED: :func:`wide_shape`),
# where a thread can no longer hold every stage quantity of its lane in
# registers, each mode runs the wide stage on 32 threads a lane.
MAX_NX, MAX_NU = 9, 16
MAX_NX_CHUNKED, MAX_NU_CHUNKED = 8, 4
# the kernels' scalar types (the generated units' T)
DTYPES = {torch.float32: "float", torch.float64: "double"}
DMA_MODES = ("stage", "chunked", "packed")
# Lanes per block of K9 (one thread each, csrc/remat_common.cuh::
# kLaneThreads) and the most lanes of a block of the group kernels (K1-K3,
# csrc/row_group.cuh::kMaxRowLanes); K2's budget for a 32-lane block's two
# chunk slots and its most stages in a chunk (the TPU chooser's cap;
# row_group.cuh::kStageBudget, kMaxChunk).
LANES = 32
CHUNK_SMEM_BYTES = 96 * 1024
MAX_CHUNK = 32
# The wide blocks (csrc/ddp_backward_wide.cuh::WideBlock, csrc/row_group.cuh::
# wide_chunk_stages): threads a lane (kWideGroup), the most threads of a
# block with its producer warp (kWideMaxThreads), a block's shared memory
# (kMaxBlockSmem) and the rows of a wide K3's TMA box (kWideBoxRows).
WIDE_GROUP = 32
WIDE_MAX_THREADS = 256
BLOCK_SMEM_BYTES = 227 * 1024
WIDE_BOX_ROWS = 256
# nvcc flags of every unit here beyond build.NVCC_FLAGS
UNIT_FLAGS = ("-fmad=false",)
# per mode: the header and the launch template with its leading arguments;
# each mode at a wide_shape from its own header ("<mode>_wide")
_UNITS = {"stage": ("ddp_backward.cuh", "launch_ddp_backward", "ld, "),
          "stage_wide": ("ddp_backward_wide.cuh", "launch_ddp_backward_wide",
                         "ld, "),
          "chunked": ("ddp_backward_chunked.cuh",
                      "launch_ddp_backward_chunked", ""),
          "chunked_wide": ("ddp_backward_chunked_wide.cuh",
                           "launch_ddp_backward_chunked_wide", ""),
          "packed": ("ddp_backward_packed.cuh", "launch_ddp_backward_packed",
                     "ld, "),
          "packed_wide": ("ddp_backward_packed_wide.cuh",
                          "launch_ddp_backward_packed_wide", "ld, ")}


def kernel_supports(nx: int, nu: int, dtype, dma: str = "stage") -> bool:
    """Whether the ``dma`` kernel takes this state/input size and dtype:
    float32 or float64 and 1 <= nx <= 9, 1 <= nu <= 16, in every mode (any
    B and N; the unit is built on demand)."""
    return (dma in DMA_MODES and 1 <= nx <= MAX_NX and 1 <= nu <= MAX_NU
            and dtype in DTYPES)


def wide_shape(nx: int, nu: int) -> bool:
    """Whether the kernels run their wide stage at (nx, nu)
    (``csrc/row_group.cuh::kWideStage``): past the narrow kernels' sizes,
    nx > 8 or nu > 4, the centroidal model's (9, 16)."""
    return nx > MAX_NX_CHUNKED or nu > MAX_NU_CHUNKED


def _shapes(nx, nu):
    return dict(zip(StackedDerivs._fields, ((nx, nx), (nx, nu), (nx,), (nu,),
                                            (nx, nx), (nu, nu), (nx, nu))))


def offsets(shapes: dict):
    """(offset of each field, width) of a packed stage holding ``shapes``
    (name -> per-stage shape) in order, each row-major."""
    off, out = 0, {}
    for name, shape in shapes.items():
        out[name] = off
        off += math.prod(shape)
    return out, off


def pack_fields(arrays) -> torch.Tensor:
    """[N, F, B]: the [N, ..., B] arrays concatenated along one axis per
    stage."""
    N, B = arrays[0].shape[0], arrays[0].shape[-1]
    return torch.cat([a.reshape(N, -1, B) for a in arrays], dim=1)


def unpack_fields(P: torch.Tensor, shapes: dict) -> dict:
    """The inverse of :func:`pack_fields`: name -> contiguous
    [N, *shape, B] field."""
    N, B = P.shape[0], P.shape[-1]
    off, _ = offsets(shapes)
    return {name: P[:, off[name]:off[name] + math.prod(shape)].reshape(
        N, *shape, B).contiguous() for name, shape in shapes.items()}


def field_offsets(nx: int, nu: int):
    """(offset of each field, F) of the packed per-stage buffer: Fx, Fu,
    Lx, Lu, Lxx, Luu, Lxu, each row-major
    (``ddp_backward_pallas.py::_field_offsets``)."""
    return offsets(_shapes(nx, nu))


def pack_derivs(D: StackedDerivs) -> torch.Tensor:
    """The packed ``[N, F, B]`` buffer of K3 (``pack_derivs_pallas`` with B
    flat)."""
    return pack_fields(D)


def unpack_derivs(P: torch.Tensor, nx: int, nu: int) -> StackedDerivs:
    """The inverse of :func:`pack_derivs`: contiguous fields."""
    return StackedDerivs(**unpack_fields(P, _shapes(nx, nu)))


def wide_scratch(nx: int, nu: int) -> int:
    """Values of a lane's scratch of the wide stage
    (``csrc/riccati_stage_wide.cuh::WideScratch::size``)."""
    xs, us = (nx + 1) | 1, nu | 1
    return (3 * nx * nx + 2 * nx + 3 * nu + 2 * nu * nx + nu * us + nu * xs
            + nu * nu)


def wide_chunk_stages(nx: int, nu: int, dtype, box: int = 1) -> int:
    """A wide K2's (``box`` = 1) or K3's (``WIDE_BOX_ROWS``) stages a
    chunk before the cut to N (``csrc/row_group.cuh::wide_chunk_stages``
    in ``csrc/ddp_backward_wide.cuh::WideChunkBlock``): the most, up to
    32, whose two buffers (``C F`` values a lane rounded up to whole boxes
    and to 128 bytes, after 128 bytes of barriers) and the lanes' scratch
    keep a block of the most lanes ``WideBlock`` takes within 227 KB.
    (9, 16): K2 9 (fp32) and 4 (fp64), K3 8 and 3."""
    size = torch.empty((), dtype=dtype).element_size()
    _, F = field_offsets(nx, nu)
    per = 128 // size
    stride = -(-wide_scratch(nx, nu) // per) * per + WIDE_GROUP % per

    def block_bytes(C, L):
        buffer = -(-C * F // box) * box * L * size
        return 128 + 2 * (-(-buffer // 128) * 128) + L * stride * size

    L, least = LANES, max(32 // WIDE_GROUP, 4)
    while L > least and (L * WIDE_GROUP + 32 > WIDE_MAX_THREADS
                         or block_bytes(1, L) > BLOCK_SMEM_BYTES):
        L //= 2
    C = MAX_CHUNK
    while C > 1 and block_bytes(C, L) > BLOCK_SMEM_BYTES:
        C -= 1
    return C


def chunk_stages(nx: int, nu: int, N: int, dtype) -> int:
    """K2's stages per chunk, as its launch picks them: at a
    :func:`wide_shape` :func:`wide_chunk_stages` (at most N), else
    ``csrc/row_group.cuh::chunked_chunk_stages``, as many as two chunk
    slots of a 32-lane block hold within ``CHUNK_SMEM_BYTES`` (at most 32
    and N); the last chunk takes the rest when C does not divide N.
    (4, 1) fp32: 8; (2, 1) fp32: 24; (9, 16) fp32: 9."""
    if wide_shape(nx, nu):
        return min(N, wide_chunk_stages(nx, nu, dtype))
    _, F = field_offsets(nx, nu)
    per_stage = 2 * F * LANES * torch.empty((), dtype=dtype).element_size()
    return max(1, min(N, MAX_CHUNK, CHUNK_SMEM_BYTES // per_stage))


def packed_lane_stride(B: int, dtype) -> int:
    """The lane stride a TMA tensor map (K1's, K3's) takes for B lanes: B
    rounded up to a multiple of 16 bytes."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-B // per) * per


def unit_source(nx: int, nu: int, dtype, dma: str = "stage",
                group: int | None = None) -> str:
    """The unit instantiating the ``dma`` kernel at (nx, nu, dtype) with
    the header's ``kRowGroup`` threads per lane, or ``group`` where a
    measurement asks for another; at a :func:`wide_shape` from the mode's
    wide header (``csrc/ddp_backward{,_chunked,_packed}_wide.cuh``)."""
    header, launch, lead = _UNITS[f"{dma}_wide" if wide_shape(nx, nu)
                                  else dma]
    g = "" if group is None else f", {group}"
    unused = "" if lead else "  (void)ld;\n"
    return (f"#include \"{header}\"\n\n"
            f"extern \"C\" int ddp_backward_launch(\n"
            f"    int N, int B, int reg_type, int ld,\n"
            f"    const void* const* fields, const void* VxT,\n"
            f"    const void* VxxT, const void* lam, void* ks, void* Ks,\n"
            f"    void* dV, void* ok, void* stream) {{\n"
            f"{unused}"
            f"  return nmpc::{launch}<{DTYPES[dtype]}, {nx}, {nu}{g}>(\n"
            f"      N, B, {lead}reg_type, fields, VxT, VxxT, lam, ks, Ks, "
            f"dV, ok,\n      stream);\n}}\n")


def unit_name(nx: int, nu: int, dtype, dma: str = "stage",
              group: int | None = None) -> str:
    kind = "" if dma == "stage" else f"_{dma}"
    g = "" if group is None else f"_g{group}"
    return f"ddp_backward{kind}_{nx}x{nu}_{str(dtype)[6:]}{g}"


def bind(lib):
    """The launch function of a loaded unit (:func:`unit_source`)."""
    fn = lib.ddp_backward_launch
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=64)
def launcher(nx: int, nu: int, dtype, dma: str, group: int | None = None):
    """The launch function of the ``dma`` unit at (nx, nu, dtype), with
    ``group`` threads per lane where a measurement asks for another."""
    return bind(load(build_generated(unit_name(nx, nu, dtype, dma, group),
                                     unit_source(nx, nu, dtype, dma, group),
                                     UNIT_FLAGS)))


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


def _check_carry(nx, B, Vx_T, Vxx_T, lam):
    dtype, device = Vx_T.dtype, Vx_T.device
    _check("Vx_T", Vx_T, (nx, B), dtype, device)
    _check("Vxx_T", Vxx_T, (nx, nx, B), dtype, device)
    _check("lam", lam, (B,), dtype, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the DDP backward takes CPU or CUDA tensors, got "
                         f"{device}")


def _require(dma, nx, nu, dtype):
    """Raise, naming the shape, where the ``dma`` kernel does not take it."""
    if not kernel_supports(nx, nu, dtype, dma):
        raise ValueError(
            f"the CUDA backward kernel ({dma}) is built for 1 <= nx <= "
            f"{MAX_NX}, 1 <= nu <= {MAX_NU} and float32/float64; got "
            f"({nx}, {nu}) {dtype}")


def launch(fn, dma, config, N, nx, nu, fields, Vx_T, Vxx_T, lam, ld=0):
    """One launch of the unit function ``fn`` (:func:`launcher`) of the
    ``dma`` kernel on ``fields`` (checked CUDA tensors; K1's and K3's with
    lanes ``ld`` values apart, as :func:`tma_fields` and
    :func:`padded_packed` give them); returns (ks, Ks, dV, ok) and raises
    on a CUDA error.  Counts nothing: the wrappers count their own
    launches."""
    B, dtype, device = lam.shape[0], lam.dtype, lam.device
    _require(dma, nx, nu, dtype)
    ks = torch.empty((N, nu, B), dtype=dtype, device=device)
    Ks = torch.empty((N, nu, nx, B), dtype=dtype, device=device)
    dV = torch.empty((2, B), dtype=dtype, device=device)
    ok = torch.empty((B,), dtype=torch.bool, device=device)
    ptrs = (ctypes.c_void_p * len(fields))(*(a.data_ptr() for a in fields))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(N, B, config.reg_type, ld, ptrs, Vx_T.data_ptr(),
                 Vxx_T.data_ptr(), lam.data_ptr(), ks.data_ptr(),
                 Ks.data_ptr(), dV.data_ptr(), ok.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ddp_backward ({dma}) kernel launch failed: CUDA "
                           f"error {err}")
    return ks, Ks, dV, ok


def _launch(dma, config, N, nx, nu, fields, Vx_T, Vxx_T, lam, ld=0):
    """Launch the ``dma`` kernel the wrapper uses on ``fields`` (checked
    before its unit is built)."""
    _require(dma, nx, nu, lam.dtype)
    return launch(launcher(nx, nu, lam.dtype, dma), dma, config, N, nx, nu,
                  fields, Vx_T, Vxx_T, lam, ld)


def backward_fused(config: DDPConfig, D: StackedDerivs, Vx_T, Vxx_T, lam,
                   dma: str = "stage"):
    """Backward pass, batch-minor, by the fused CUDA kernel of ``dma``
    (``"stage"``: K1, ``"chunked"``: K2, ``"packed"``: K3 after
    :func:`pack_derivs`).

    Args: D with Fx [N,nx,nx,B], Fu [N,nx,nu,B], Lx [N,nx,B], Lu [N,nu,B],
    Lxx [N,nx,nx,B], Luu [N,nu,nu,B], Lxu [N,nx,nu,B]; Vx_T [nx,B],
    Vxx_T [nx,nx,B]; lam [B].
    Returns (ks [N,nu,B], Ks [N,nu,nx,B], dV [2,B], ok [B] bool).
    """
    if dma not in DMA_MODES:
        raise ValueError(f"dma must be one of {DMA_MODES}, got {dma!r}")
    N, nx = D.Fx.shape[0], D.Fx.shape[1]
    nu = D.Fu.shape[2]
    B = Vx_T.shape[-1]
    dtype, device = Vx_T.dtype, Vx_T.device
    shapes = {"Fx": (N, nx, nx, B), "Fu": (N, nx, nu, B), "Lx": (N, nx, B),
              "Lu": (N, nu, B), "Lxx": (N, nx, nx, B), "Luu": (N, nu, nu, B),
              "Lxu": (N, nx, nu, B)}
    for name, a in zip(StackedDerivs._fields, D):
        _check(name, a, shapes[name], dtype, device)
    _check_carry(nx, B, Vx_T, Vxx_T, lam)
    if dma == "packed":
        return backward_packed(config, pack_derivs(D), nx, nu, Vx_T, Vxx_T,
                               lam)
    if device.type == "cpu":
        return backward_stacked(config, D, Vx_T, Vxx_T, lam)
    if dma == "chunked":
        out = _launch(dma, config, N, nx, nu, D, Vx_T, Vxx_T, lam)
        if wide_shape(nx, nu):
            backward_fused.chunked_wide_launches += 1
        else:
            backward_fused.chunked_launches += 1
        return out
    fields, ld = tma_fields(D)
    out = _launch(dma, config, N, nx, nu, fields, Vx_T, Vxx_T, lam, ld)
    if wide_shape(nx, nu):
        backward_fused.wide_launches += 1
    else:
        backward_fused.launches += 1
    return out


backward_fused.launches = 0           # K1
backward_fused.wide_launches = 0      # K1 at a wide_shape: (9, 16)
backward_fused.chunked_launches = 0   # K2
backward_fused.chunked_wide_launches = 0   # K2 at a wide_shape: (9, 16)
backward_fused.padded_copies = 0      # a field copied to a TMA lane stride


def tma_takes(a: torch.Tensor) -> bool:
    """Whether a TMA tensor map takes ``a`` [..., B] as it is: at a
    16-byte aligned address with B a multiple of 16 bytes."""
    return (a.shape[-1] * a.element_size()) % 16 == 0 and (
        a.data_ptr() % 16 == 0)


def padded_lanes(a: torch.Tensor):
    """(a, its lane stride) where :func:`tma_takes` ``a``; else (a copy of
    ``a`` into [..., packed_lane_stride(B)] at a fresh address, that
    stride), the lanes past B left unset (the map's bounds stop at B)."""
    B = a.shape[-1]
    if tma_takes(a):
        return a, B
    per = 16 // a.element_size()
    ld = -(-B // per) * per   # packed_lane_stride(B, a.dtype)
    padded = torch.empty((*a.shape[:-1], ld), dtype=a.dtype, device=a.device)
    padded[..., :B] = a
    return padded, ld


def padded_fields(fields):
    """(``fields`` [..., B] as TMA tensor maps take them, their common lane
    stride, how many were copied), each by :func:`padded_lanes`: where B
    is a multiple of 16 bytes, each field as it is unless it lies at an
    address that is not 16-byte aligned (a view at an offset), which is
    copied once; else every field copied once into a buffer padded to
    :func:`packed_lane_stride`."""
    if all(map(tma_takes, fields)):
        return list(fields), fields[0].shape[-1], 0
    out = [padded_lanes(a) for a in fields]
    (ld,) = {ld for _, ld in out}
    return ([a for a, _ in out], ld,
            sum(p is not a for (p, _), a in zip(out, fields)))


def tma_fields(D: StackedDerivs):
    """(the seven fields as K1's tensor maps take them, their lane stride)
    by :func:`padded_fields`; each copy adds one to
    ``backward_fused.padded_copies``."""
    fields, ld, copies = padded_fields(D)
    backward_fused.padded_copies += copies
    return fields, ld


def padded_packed(P: torch.Tensor):
    """(P or a copy of it, its lane stride) as K3's tensor map takes them
    (:func:`padded_lanes`): a P whose B is not a multiple of 16 bytes
    (B=1023 at fp32) is copied once into ``[N, F,
    packed_lane_stride(B)]``; each such copy adds one to
    ``backward_packed.padded_copies``."""
    out, ld = padded_lanes(P)
    backward_packed.padded_copies += out is not P
    return out, ld


def backward_packed(config: DDPConfig, P, nx: int, nu: int, Vx_T, Vxx_T,
                    lam):
    """Backward pass from the packed buffer P [N, F, B] (:func:`pack_derivs`)
    by K3; other arguments and the result as :func:`backward_fused`'s.  On
    CPU tensors the plain version unpacks P and runs ``backward_stacked``.
    On CUDA tensors the kernel reads P through a TMA tensor map, which
    takes a lane stride of a multiple of 16 bytes: any other B is first
    copied into a padded buffer (:func:`padded_packed`, counted)."""
    N, B = P.shape[0], Vx_T.shape[-1]
    _, F = field_offsets(nx, nu)
    _check("P", P, (N, F, B), Vx_T.dtype, Vx_T.device)
    _check_carry(nx, B, Vx_T, Vxx_T, lam)
    if P.device.type == "cpu":
        return backward_stacked(config, unpack_derivs(P, nx, nu), Vx_T,
                                Vxx_T, lam)
    P, ld = padded_packed(P)
    out = _launch("packed", config, N, nx, nu, (P,), Vx_T, Vxx_T, lam, ld)
    if wide_shape(nx, nu):
        backward_packed.wide_launches += 1
    else:
        backward_packed.launches += 1
    return out


backward_packed.launches = 0          # K3
backward_packed.wide_launches = 0     # K3 at a wide_shape: (9, 16)
backward_packed.padded_copies = 0     # P copied to a 16-byte lane stride
