"""The sweep-fed DDP backward K1 at the centroidal model's (nx, nu) =
(9, 16), on the CPU: its wide stage (``csrc/ddp_backward_wide.cuh``,
``csrc/riccati_stage_wide.cuh``) against K1's one-thread-a-lane stage
(``csrc/ddp_backward.cuh``, ``riccati_stage_group`` at G = 1) and the
plain ``backward_stacked``.

Where ``g++`` is on PATH both launch functions are built as host C++
(``tests/host_shim.py``: each warp as 32 host threads, ``tma.cuh``
replaced by a stand-in that copies a box at once and checks every
barrier, shared memory poisoned and the bytes past a launch's checked,
no contraction, as the units' ``-fmad=false``) at fp32 and fp64, and run
on the stage fields of a centroidal rollout whose horizon crosses the
flight phase (every input masked there), with a non-PD and a NaN lane,
at B = 64, on its first 37 lanes and on lane 0 alone: the wide stage at
every G (threads per lane) equals G = 1 bit for bit (NaN lanes NaN where
they are), and G = 1 equals ``backward_stacked`` with a correctly
rounded sqrt on every lane it calls ok, with the same ok mask.  Also
held: the wide block's ring, field offsets and per-lane scratch
(within a block's 227 KB), the wrapper's units and limits, and the
solver's ``auto`` rule on the centroidal model (the code generator
refuses it, so K1 serves it on the card).
"""

import subprocess

import numpy as np
import pytest
import torch

from nmpc_tpu_torch import DDPConfig
from nmpc_tpu_torch.kernels import ddp_backward_fused as K
from nmpc_tpu_torch.kernels.ddp_backward import StackedDerivs, backward_stacked
from nmpc_tpu_torch.kernels.ddp_backward_remat import remat_supported
from nmpc_tpu_torch.kernels.ddp_forward_remat import forward_remat_supported
from nmpc_tpu_torch.models.centroidal import make_centroidal_problem
from nmpc_tpu_torch.solvers import ddp

from host_shim import (KERNELS_PRELUDE, SHIM, build_kernels_host,
                       exact_sqrt, same)

torch.set_num_threads(1)

NX, NU = 9, 16
DT = 0.03
BLOCK_SMEM = 227 * 1024
# the most threads of a wide block (csrc/ddp_backward_wide.cuh::
# kWideMaxThreads)
WIDE_THREADS = 256
# G = 1: K1's riccati_stage_group at one thread a lane, the reference;
# then the wide stage's threads per lane: the candidates measured on the
# card (8, 16, 32; kRowGroup<9, 16> = 32 among them) and 4
GROUPS = (1, 4, 8, 16, 32)
WIDE_GROUP = 32
# the batches: a case's lanes, its first 37 (a lane stride TMA does not
# take at fp32, a ragged last warp at G = 1 and block at G >= 8) and lane
# 0 alone (run_mpc's batch); the plain version's lanes (plain_lanes)
BATCHES = (64, 37, 1)
PLAIN_LANES = 64

_HARNESS = SHIM + KERNELS_PRELUDE + r"""
#include "ddp_backward_wide.cuh"

// in: the seven fields at lane stride ld (each [N][size][ld]), VxT, VxxT,
// lam; out: ks [N][NU][B], Ks [N][NU][NX][B], dV [2][B], ok [B]; K1 by
// launch (ddp_backward.cuh's at one thread a lane, or
// ddp_backward_wide.cuh's)
template <typename T, typename Launch>
int run(Launch launch, int N, int B, int reg_type, int ld, const T* in,
        T* out) {
  constexpr int NX = 9, NU = 16;
  const int sizes[7] = {NX * NX, NX * NU, NX, NU, NX * NX, NU * NU, NX * NU};
  const void* fields[7];
  const T* p = in;
  for (int f = 0; f < 7; ++f) {
    fields[f] = p;
    p += static_cast<size_t>(N) * sizes[f] * ld;
  }
  const T* VxT = p;
  const T* VxxT = VxT + static_cast<size_t>(NX) * B;
  const T* lam = VxxT + static_cast<size_t>(NX) * NX * B;
  std::vector<unsigned char> ok(B);
  T* dV = out + static_cast<size_t>(N) * NU * (NX + 1) * B;
  const int err = launch(N, B, ld, reg_type, fields, VxT, VxxT, lam, out,
                         out + static_cast<size_t>(N) * NU * B, dV,
                         ok.data(), nullptr);
  if (err) return 20 + err;
  for (int b = 0; b < B; ++b) dV[2 * B + b] = ok[b];
  return 0;
}

// the wide block's geometry at G and B: Layout offsets, F, R, the most
// and fewest lanes of a block, the lane stride and size of the scratch,
// the launch's lanes, a block's bytes at the most lanes and at the
// launch's
template <typename T, int G>
void geometry(int B) {
  constexpr int NX = 9, NU = 16;
  using L = nmpc::WideRingLayout<T, NX, NU, G>;
  using Block = nmpc::WideK1Block<T, NX, NU, G>;
  constexpr int R = Block::ring();
  constexpr int most = Block::max_lanes();
  const int lanes = Block::lanes(B);
  std::printf("%d %d %d %d %d %d %d %d %d %d %d %d %d %d %zu %zu\n", L::Fx,
              L::Fu, L::Lx, L::Lu, L::Lxx, L::Luu, L::Lxu, L::F, R, most,
              nmpc::wide_min_lanes<G>(),
              Block::stride,
              nmpc::WideScratch<NX, NU>::size, lanes,
              Block::bytes(R, most), Block::bytes(R, lanes));
}

template <typename T>
int main_t(int G, int N, int B, int reg_type, int ld, const char* in_path,
           const char* out_path) {
  constexpr int NX = 9, NU = 16;
  constexpr int F = 2 * NX * NX + 2 * NX * NU + NX + NU + NU * NU;
  const size_t n_in = static_cast<size_t>(N) * F * ld +
                      static_cast<size_t>(NX + NX * NX + 1) * B;
  const size_t n_out = static_cast<size_t>(N) * NU * (NX + 1) * B + 3 * B;
  std::vector<T> in(n_in), out(n_out);
  FILE* f = std::fopen(in_path, "rb");
  if (!f || std::fread(in.data(), sizeof(T), n_in, f) != n_in) return 4;
  std::fclose(f);
  int err = 2;
@DISPATCH@
  if (err) return err;
  f = std::fopen(out_path, "wb");
  if (!f || std::fwrite(out.data(), sizeof(T), n_out, f) != n_out) return 5;
  std::fclose(f);
  return 0;
}

// k1_wide G N B reg_type ld in out
int main(int argc, char** argv) {
  if (argc != 8) return 1;
  const int G = std::atoi(argv[1]), N = std::atoi(argv[2]),
            B = std::atoi(argv[3]), reg_type = std::atoi(argv[4]),
            ld = std::atoi(argv[5]);
  return main_t<@T@>(G, N, B, reg_type, ld, argv[6], argv[7]);
}
""".replace("@DISPATCH@", "\n".join(
    ["  if (G == 1) err = run<T>(nmpc::launch_ddp_backward<T, NX, NU, 1>, N, "
     "B, reg_type, ld, in.data(), out.data());"]
    + [f"  if (G == {g}) {{\n    err = run<T>(nmpc::launch_ddp_backward_wide"
       f"<T, NX, NU, {g}>, N, B, reg_type, ld, in.data(), out.data());\n"
       f"    geometry<T, {g}>(B);\n  }}" for g in GROUPS[1:]]))

DTYPES = {torch.float32: "float", torch.float64: "double"}


@pytest.fixture(scope="module")
def k1_wide_host(tmp_path_factory):
    """{dtype: the harness built by g++ (one executable per dtype)}."""
    return {dtype: build_kernels_host(
        tmp_path_factory.mktemp(f"k1_wide_{name}"),
        _HARNESS.replace("@T@", name), "k1_wide")
        for dtype, name in DTYPES.items()}


def _centroidal_case(dtype, B=64, N=9):
    """First-iteration stage fields of the centroidal model from t0 = 1.3
    (dt = 0.03: the horizon enters the flight phase at 1.4 s, where every
    input is masked), x0 about the standing pose and inputs about 60 N,
    made from a seed; lane 1 non-PD (Luu = -10), lane 2 NaN from stage N
    / 2."""
    rng = np.random.default_rng(11)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()
    p = make_centroidal_problem(DT)
    x0 = np.concatenate([[0.0, 0.0, 1.0], np.zeros(6)])
    x0s = np.tile(x0, (B, 1)) + 0.02 * rng.normal(size=(B, NX))
    us = 60.0 + 5.0 * rng.normal(size=(N, NU, B))
    cfg = DDPConfig(horizon_steps=N)
    t0, us = as_t(1.3), as_t(us)
    xs, _ = ddp._rollout_lanes(p, cfg, t0, as_t(x0s.T), us)
    D, VxT, VxxT = ddp._derivative_sweep_lanes(p, cfg, t0, xs, us)
    D = StackedDerivs(*(a.contiguous() for a in D[:7]))
    assert torch.all(D.Fu[-3:] == 0) and torch.any(D.Fu[0] != 0)
    D.Luu[:, :, :, 1] = -10.0
    D.Fx[N // 2, 0, 0, 2] = float("nan")
    return D, VxT.contiguous(), VxxT.contiguous()


def _run(exe, D, VxT, VxxT, lam, reg_type, G, workdir):
    """(ks, Ks, dV, ok) from the harness at G threads per lane, the fields
    fed as the wrapper feeds them (``tma_fields``), and the geometry line
    the harness printed."""
    N, B = D.Fx.shape[0], lam.shape[0]
    fields, ld = K.tma_fields(D)
    flat = torch.cat([a.flatten() for a in fields]
                     + [VxT.flatten(), VxxT.flatten(), lam])
    inp, outp = workdir / f"in{G}_{reg_type}", workdir / f"out{G}_{reg_type}"
    inp.write_bytes(flat.numpy().tobytes())
    proc = subprocess.run([str(exe), str(G), str(N), str(B), str(reg_type),
                           str(ld), str(inp), str(outp)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.returncode, proc.stderr)
    o = torch.from_numpy(np.frombuffer(
        outp.read_bytes(), dtype=np.float32 if lam.dtype == torch.float32
        else np.float64).copy())
    ks = o[:N * NU * B].reshape(N, NU, B)
    Ks = o[N * NU * B:N * NU * (NX + 1) * B].reshape(N, NU, NX, B)
    rest = o[N * NU * (NX + 1) * B:].reshape(3, B)
    return (ks, Ks, rest[:2], rest[2] != 0), list(
        map(int, proc.stdout.split()))


def plain_lanes(cfg, D, VxT, VxxT, lam):
    """``backward_stacked`` with a correctly rounded sqrt on the lanes
    padded to a multiple of PLAIN_LANES by repeating the last one, cut
    back: on fewer lanes, or on a ragged tail, torch's CPU reductions over
    the 16-wide axes sum in another order than one lane's left to right."""
    B = lam.shape[0]
    take = torch.arange(-(-B // PLAIN_LANES) * PLAIN_LANES).clamp(max=B - 1)
    pad = lambda a: a[..., take].contiguous()
    saved, torch.sqrt = torch.sqrt, exact_sqrt
    try:
        out = backward_stacked(cfg, StackedDerivs(*map(pad, D)), pad(VxT),
                               pad(VxxT), pad(lam))
    finally:
        torch.sqrt = saved
    return tuple(a[..., :B].contiguous() for a in out)


@pytest.fixture(scope="module")
def k1_wide_runs(k1_wide_host, tmp_path_factory):
    """The harness's runs by (dtype, reg_type): {B: (cfg, D, VxT, VxxT,
    lam, {G: (outputs, geometry)})} for B in BATCHES, each the first B
    lanes of one centroidal case (B = 37: its fields copied to a lane
    stride TMA takes, a ragged last warp and block; B = 1: lane 0
    alone)."""
    cache = {}

    def get(dtype, reg_type):
        if (dtype, reg_type) not in cache:
            D, VxT, VxxT = _centroidal_case(dtype, B=BATCHES[0])
            lam = torch.full((BATCHES[0],), 1e-6 if reg_type == 1 else 0.5,
                             dtype=dtype)
            cfg = DDPConfig(horizon_steps=D.Fx.shape[0], reg_type=reg_type)
            runs = {}
            for B in BATCHES:
                cut = lambda a: a[..., :B].contiguous()
                args = (StackedDerivs(*map(cut, D)), cut(VxT), cut(VxxT),
                        cut(lam))
                d = tmp_path_factory.mktemp(f"k1_wide_runs_{B}")
                runs[B] = (cfg, *args, {
                    G: _run(k1_wide_host[dtype], *args, reg_type, G, d)
                    for G in GROUPS})
            cache[dtype, reg_type] = runs
        return cache[dtype, reg_type]
    return get


@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_wide_as_host_cpp(k1_wide_runs, dtype, reg_type):
    """K1 at (9, 16) at one thread a lane (G = 1, ``riccati_stage_group``)
    through its launch function, at B = 64, on its first 37 lanes and on
    lane 0 alone: equal to ``backward_stacked`` with a correctly rounded
    sqrt (``plain_lanes``) bit for bit on every lane it calls ok, the ok
    masks equal (the non-PD and NaN lanes fail, no other), and the flight
    stages' gains exactly 0."""
    for B, (cfg, D, VxT, VxxT, lam, runs) in k1_wide_runs(dtype,
                                                          reg_type).items():
        out = runs[1][0]
        ref = plain_lanes(cfg, D, VxT, VxxT, lam)
        ok = ref[3]
        assert torch.equal(out[3], ok), B
        bad = {1, 2} & set(range(B))
        assert not any(ok[list(bad)]) and int(ok.sum()) == B - len(bad), B
        for name, a, b in zip(("ks", "Ks", "dV"), ref[:3], out[:3]):
            assert torch.equal(a[..., ok].contiguous().view(torch.uint8),
                               b[..., ok].contiguous().view(torch.uint8)), (
                B, name)
        assert torch.all(out[0][-3:][..., ok] == 0), B
        assert torch.all(out[1][-3:][..., ok] == 0), B


@pytest.mark.parametrize("G", GROUPS[1:])
@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_wide_groups(k1_wide_runs, dtype, reg_type, G):
    """The wide stage (``csrc/riccati_stage_wide.cuh``) at G threads a lane
    through ``launch_ddp_backward_wide`` equal to K1 at G = 1 bit for bit
    (NaN lanes NaN where they are) with the same ok mask, at B = 64, 37
    and 1, fp32 and fp64, both reg_types."""
    for B, (*_, runs) in k1_wide_runs(dtype, reg_type).items():
        ref, out = runs[1][0], runs[G][0]
        for name, a, b in zip(("ks", "Ks", "dV"), ref[:3], out[:3]):
            assert same(a, b), (B, name)
        assert torch.equal(ref[3], out[3]), B


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_wide_ring_fits(k1_wide_runs, dtype):
    """The wide block ``csrc/ddp_backward_wide.cuh`` lays out at (9, 16) at
    every G: each field of a ring buffer on a 128-byte boundary at any lane
    count the block takes (a multiple of its fewest lanes, 4 at G >= 8),
    with the packed order's sizes; the lanes' scratch (WideScratch) after
    the ring, one lane stride apart, within the launch's dynamic shared
    memory (the host shim checks the bytes past it); at the most lanes a
    block, at most 256 threads and the ring and scratch within 227 KB,
    where one more buffer would pass them, and twice the lanes one of the
    two; at kRowGroup (G = 32) 4 lanes and 8 buffers at fp32 (F = 752)
    and fp64 (F = 740), at G = 16 8 lanes and 7 buffers at fp32, 3 at
    fp64; a launch's lanes as row_lanes gives them (the fewest at B <=
    64)."""
    size = 4 if dtype == torch.float32 else 8
    sizes = (NX * NX, NX * NU, NX, NU, NX * NX, NU * NU, NX * NU)
    buffer = lambda F, L: -(-F * L * size // 128) * 128
    for B, (*_, runs) in k1_wide_runs(dtype, 1).items():
        for G in GROUPS[1:]:
            *off, F, R, most, least, stride, scratch, L, full, launched = (
                runs[G][1])
            assert least == max(32 // G, 4) and L % least == 0, G
            for o, o_next, n in zip(off, off[1:] + [F], sizes):
                assert (o * least * size) % 128 == 0 and o_next - o >= n, G
            assert stride >= scratch and (stride * size) % 8 == 0, G
            block = lambda R_, L_: 128 + R_ * buffer(F, L_) + L_ * stride * size
            assert launched == block(R, L) and full == block(R, most), G
            assert full <= BLOCK_SMEM, G
            assert R == 8 or block(R + 1, most) > BLOCK_SMEM, G
            assert most * G + 32 <= WIDE_THREADS, G
            assert most == least or most == 32 or (
                2 * most * G + 32 > WIDE_THREADS
                or block(2, 2 * most) > BLOCK_SMEM), G
            assert L == least, (G, B, L)   # B <= 64: the fewest lanes
            if G == WIDE_GROUP:
                assert (F, R, most) == ((752, 8, 4) if size == 4
                                        else (740, 8, 4))
            if G == 16:
                assert (F, R, most) == ((752, 7, 8) if size == 4
                                        else (740, 3, 8))


def test_k1_wide_unit_source():
    """The wrapper's unit: K1 at a wide shape (nx > 8 or nu > 4) from
    ``ddp_backward_wide.cuh``'s launch, at the header's G or another a
    measurement names, under its own library name; K1 at K2's shapes,
    K2 and K3 from their own headers."""
    assert K.wide_shape(9, 16) and K.wide_shape(2, 5)
    assert K.wide_shape(9, 1) and not K.wide_shape(8, 4)
    for dtype, name in DTYPES.items():
        text = K.unit_source(9, 16, dtype)
        assert '#include "ddp_backward_wide.cuh"' in text
        assert f"launch_ddp_backward_wide<{name}, 9, 16>(" in text
        text = K.unit_source(9, 16, dtype, group=8)
        assert f"launch_ddp_backward_wide<{name}, 9, 16, 8>(" in text
        assert K.unit_name(9, 16, dtype, group=8).endswith("_g8")
        text = K.unit_source(4, 1, dtype)
        assert '#include "ddp_backward.cuh"' in text
        assert f"launch_ddp_backward<{name}, 4, 1>(" in text
        for dma in ("chunked", "packed"):
            assert "_wide" not in K.unit_source(8, 4, dtype, dma)


def test_k1_wide_limits_and_auto_rule(monkeypatch):
    """K1, K2 and K3 take nx <= 9, nu <= 16 (the wide stage past nx 8, nu
    4) and their launch raises past them, naming the shape, before any
    unit is built.  The code generator refuses the centroidal model (its
    torch.linalg.cross), so neither remat kernel takes it and ``auto``
    picks the sweep-fed kernel of the solve's ``backward_dma`` for an
    unboxed first-order solve on a CUDA device (checking that kernel's
    limits, not K1's) and the sweep-fed K4 (its wide unit) for a boxed
    one; a second-order one takes the plain backward."""
    assert K.kernel_supports(9, 16, torch.float32)
    assert K.kernel_supports(9, 16, torch.float64, "stage")
    assert not K.kernel_supports(10, 16, torch.float32)
    assert not K.kernel_supports(9, 17, torch.float32)
    for dma in ("chunked", "packed"):
        assert K.kernel_supports(8, 4, torch.float32, dma)
        assert K.kernel_supports(9, 16, torch.float32, dma)
        assert K.kernel_supports(9, 16, torch.float64, dma)
        for shape in ((10, 16), (9, 17)):
            assert not K.kernel_supports(*shape, torch.float32, dma)
            with pytest.raises(ValueError, match=rf"\({shape[0]}, "
                                                 rf"{shape[1]}\)"):
                K._launch(dma, DDPConfig(), 3, *shape, (), None, None,
                          torch.zeros(4))
    p = make_centroidal_problem(DT)
    boxed = make_centroidal_problem(DT, force_limits=(0.0, 1000.0))
    cuda = torch.device("cuda")
    for dtype in (torch.float32, torch.float64):
        assert not remat_supported(p, NX, NU, dtype)
        assert not forward_remat_supported(p, NX, NU, dtype)
        assert ddp._resolve_backward_impl(DDPConfig(), p, dtype, cuda,
                                          False, False) == "pallas"
        for dma in ("chunked", "packed"):
            assert ddp._resolve_backward_impl(DDPConfig(), p, dtype, cuda,
                                              False, False, dma) == "pallas"
        assert ddp._resolve_backward_impl(DDPConfig(), boxed, dtype, cuda,
                                          True, False) == "pallas"
        assert ddp._resolve_backward_impl(DDPConfig(), p, dtype, cuda,
                                          False, True) == "stacked"
        assert ddp._resolve_backward_impl(DDPConfig(), p, dtype,
                                          torch.device("cpu"), False,
                                          False) == "stacked"
    # the rule asks about the kernel of the solve's dma: with a stand-in
    # that takes "stage" alone, only "stage" resolves to the kernel
    asked = []

    def stage_only(nx, nu, dtype, dma="stage"):
        asked.append(dma)
        return dma == "stage"
    monkeypatch.setattr(ddp, "kernel_supports", stage_only)
    for dma in ("stage", "chunked", "packed"):
        want = "pallas" if dma == "stage" else "stacked"
        assert ddp._resolve_backward_impl(DDPConfig(), p, torch.float32,
                                          cuda, False, False, dma) == want
    assert asked == ["stage", "chunked", "packed"]
