"""The chunked and packed DDP backward (K2, K3) at the wide shapes, on the
CPU: their wide units (``csrc/ddp_backward_chunked_wide.cuh``: K2's
cp.async slots feeding the wide stage; ``csrc/ddp_backward_packed_wide.cuh``:
a ring of two chunks of the packed buffer's rows by TMA) against K1's wide
unit (``csrc/ddp_backward_wide.cuh``) and the plain ``backward_stacked``.

Where ``g++`` is on PATH the three launch functions are built as host C++
in one harness per dtype (``tests/host_shim.py``: each warp as 32 host
threads, ``tma.cuh`` and ``cp_async.cuh`` replaced by stand-ins that copy
at once, every barrier checked, shared memory poisoned and the bytes past
a launch's checked, no contraction, as the units' ``-fmad=false``), and
run on the stage fields of a centroidal rollout whose horizon crosses the
flight phase, with a non-PD and a NaN lane, at B = 64, on its first 37
lanes and on lane 0 alone, fp32 and fp64, both reg_types; at N = 10 every
mode and dtype ends on a short chunk, and N = 12 holds a second one at
fp32.  K2 and K3 equal K1 bit for bit (NaN lanes NaN where they are) with
the same ok mask, and equal ``backward_stacked`` with a correctly rounded
sqrt on every lane it calls ok; so at (2, 5), on seeded data.  Also held:
the wide chunk rule's Python twin against the header's at every wide
shape, both blocks within 227 KB, and K3's boxes (each 256 rows of the
block's lanes, every row starting 16-byte aligned, landing 128-byte
aligned).
"""

import concurrent.futures
import subprocess

import numpy as np
import pytest
import torch

from nmpc_tpu_torch import DDPConfig
from nmpc_tpu_torch.kernels import ddp_backward_fused as K
from nmpc_tpu_torch.kernels.ddp_backward import StackedDerivs
from nmpc_tpu_torch.models.centroidal import make_centroidal_problem
from nmpc_tpu_torch.solvers import ddp

from host_shim import KERNELS_PRELUDE, SHIM, build_kernels_host, same
from test_torch_k1_wide import plain_lanes

torch.set_num_threads(1)

BLOCK_SMEM = 227 * 1024
MODES = ("stage", "chunked", "packed")
# the batches: a case's lanes, its first 37 (a lane stride TMA does not
# take at fp32, a ragged last block) and lane 0 alone
BATCHES = (64, 37, 1)
# N = 10: a short last chunk in every mode and dtype (C = 9, 4 for K2 and
# 8, 3 for K3 at fp32, fp64); N = 12: another at fp32
HORIZONS = (10, 12)
WIDE = [(nx, nu) for nx in range(1, K.MAX_NX + 1)
        for nu in range(1, K.MAX_NU + 1) if K.wide_shape(nx, nu)]
DTYPES = {torch.float32: "float", torch.float64: "double"}


def _rules(T):
    lines = []
    for nx, nu in WIDE:
        k2 = f"nmpc::WideChunkedBlock<{T}, {nx}, {nu}, 32>"
        k3 = f"nmpc::WidePackedBlock<{T}, {nx}, {nu}, 32>"
        lines.append(
            f'  std::printf("{nx} {nu} %d %d %d %zu %zu\\n", {k2}::chunk, '
            f"{k3}::chunk, {k2}::lanes, {k2}::bytes({k2}::chunk, {k2}::lanes),"
            f" {k3}::bytes({k3}::chunk, {k3}::lanes));")
    return "\n".join(lines)


_HARNESS = SHIM + KERNELS_PRELUDE + r"""
#include "ddp_backward_chunked_wide.cuh"
#include "ddp_backward_packed_wide.cuh"

// in: the fields as the mode's launch takes them (K1, K2: seven, each
// [N][size][ld], K2's at ld = B; K3: P [N][F][ld]), VxT, VxxT, lam; out:
// ks [N][NU][B], Ks [N][NU][NX][B], dV [2][B], ok [B]
template <typename T, int NX, int NU>
int run(int mode, int N, int B, int reg_type, int ld, const T* in, T* out) {
  constexpr int F = nmpc::PackedLayout<NX, NU>::F;
  const int sizes[7] = {NX * NX, NX * NU, NX, NU, NX * NX, NU * NU, NX * NU};
  const void* fields[7];
  const T* p = in;
  for (int f = 0; f < (mode == 2 ? 1 : 7); ++f) {
    fields[f] = p;
    p += static_cast<size_t>(N) * (mode == 2 ? F : sizes[f]) * ld;
  }
  const T* VxT = p;
  const T* VxxT = VxT + static_cast<size_t>(NX) * B;
  const T* lam = VxxT + static_cast<size_t>(NX) * NX * B;
  std::vector<unsigned char> ok(B);
  T* Ks = out + static_cast<size_t>(N) * NU * B;
  T* dV = out + static_cast<size_t>(N) * NU * (NX + 1) * B;
  int err;
  if (mode == 0)
    err = nmpc::launch_ddp_backward_wide<T, NX, NU>(
        N, B, ld, reg_type, fields, VxT, VxxT, lam, out, Ks, dV, ok.data(),
        nullptr);
  else if (mode == 1)
    err = nmpc::launch_ddp_backward_chunked_wide<T, NX, NU>(
        N, B, reg_type, fields, VxT, VxxT, lam, out, Ks, dV, ok.data(),
        nullptr);
  else
    err = nmpc::launch_ddp_backward_packed_wide<T, NX, NU>(
        N, B, ld, reg_type, fields, VxT, VxxT, lam, out, Ks, dV, ok.data(),
        nullptr);
  if (err) return 20 + err;
  for (int b = 0; b < B; ++b) dV[2 * B + b] = ok[b];
  return 0;
}

template <typename T>
int main_t(int mode, int nx, int N, int B, int reg_type, int ld,
           const char* in_path, const char* out_path) {
  const int nu = nx == 9 ? 16 : 5;
  const int F = 2 * nx * nx + 2 * nx * nu + nx + nu + nu * nu;
  const size_t n_in = static_cast<size_t>(N) * F * ld +
                      static_cast<size_t>(nx + nx * nx + 1) * B;
  const size_t n_out = static_cast<size_t>(N) * nu * (nx + 1) * B + 3 * B;
  std::vector<T> in(n_in), out(n_out);
  FILE* f = std::fopen(in_path, "rb");
  if (!f || std::fread(in.data(), sizeof(T), n_in, f) != n_in) return 4;
  std::fclose(f);
  const int err = nx == 9
      ? run<T, 9, 16>(mode, N, B, reg_type, ld, in.data(), out.data())
      : run<T, 2, 5>(mode, N, B, reg_type, ld, in.data(), out.data());
  if (err) return err;
  f = std::fopen(out_path, "wb");
  if (!f || std::fwrite(out.data(), sizeof(T), n_out, f) != n_out) return 5;
  std::fclose(f);
  return 0;
}

// k2k3 rules | k2k3 MODE NX N B reg_type ld in out log
int main(int argc, char** argv) {
  using T = @T@;
  if (argc == 2) {
@RULES@
    return 0;
  }
  if (argc != 10) return 1;
  nmpc::g_log = std::fopen(argv[9], "w");
  const int err = main_t<T>(std::atoi(argv[1]), std::atoi(argv[2]),
                            std::atoi(argv[3]), std::atoi(argv[4]),
                            std::atoi(argv[5]), std::atoi(argv[6]), argv[7],
                            argv[8]);
  std::fclose(nmpc::g_log);
  return err;
}
"""


@pytest.fixture(scope="module")
def k2k3_host(tmp_path_factory):
    """{dtype: the harness built by g++}, the two built side by side (their
    directories made first: two threads making a worker's first temporary
    directory at once race on its base directory)."""
    dirs = {dtype: tmp_path_factory.mktemp(f"k2k3_wide_{name}")
            for dtype, name in DTYPES.items()}

    def build(item):
        dtype, name = item
        return dtype, build_kernels_host(
            dirs[dtype],
            _HARNESS.replace("@T@", name).replace("@RULES@", _rules(name)),
            "k2k3")
    with concurrent.futures.ThreadPoolExecutor(len(DTYPES)) as pool:
        return dict(pool.map(build, DTYPES.items()))


def _poison(D, N):
    """Lane 1 non-PD (Luu = -10), lane 2 NaN from stage N / 2."""
    D.Luu[:, :, :, 1] = -10.0
    D.Fx[N // 2, 0, 0, 2] = float("nan")
    return D


def _centroidal(dtype, N, B=64):
    """First-iteration stage fields of the centroidal model from t0 = 1.3
    (dt = 0.03: the horizon enters the flight phase, every input masked,
    at 1.4 s), x0 about the standing pose and inputs about 60 N, made from
    a seed, poisoned (``_poison``)."""
    rng = np.random.default_rng(11)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()
    p = make_centroidal_problem(0.03)
    x0 = np.concatenate([[0.0, 0.0, 1.0], np.zeros(6)])
    x0s = np.tile(x0, (B, 1)) + 0.02 * rng.normal(size=(B, 9))
    us = as_t(60.0 + 5.0 * rng.normal(size=(N, 16, B)))
    cfg = DDPConfig(horizon_steps=N)
    t0 = as_t(1.3)
    xs, _ = ddp._rollout_lanes(p, cfg, t0, as_t(x0s.T), us)
    D, VxT, VxxT = ddp._derivative_sweep_lanes(p, cfg, t0, xs, us)
    D = StackedDerivs(*(a.contiguous() for a in D[:7]))
    assert torch.all(D.Fu[4:7] == 0) and torch.any(D.Fu[0] != 0)
    return _poison(D, N), VxT.contiguous(), VxxT.contiguous()


def _spd(rng, shape, n):
    """[*shape, n, n] positive definite matrices, from a seed."""
    a = rng.normal(size=(*shape, n, n))
    return np.einsum("...ij,...kj->...ik", a, a) / n + np.eye(n)


def _seeded(dtype, nx, nu, N, B=64):
    """Stage fields at (nx, nu) from a seed (Lxx, Luu positive definite),
    poisoned (``_poison``)."""
    rng = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()
    lanes_last = lambda a: np.moveaxis(a, -3, -1)   # [..., B, n, m] last B
    D = StackedDerivs(
        Fx=t(lanes_last(np.eye(nx) + 0.1 * rng.normal(size=(N, B, nx, nx)))),
        Fu=t(0.3 * rng.normal(size=(N, nx, nu, B))),
        Lx=t(0.1 * rng.normal(size=(N, nx, B))),
        Lu=t(0.1 * rng.normal(size=(N, nu, B))),
        Lxx=t(lanes_last(_spd(rng, (N, B), nx))),
        Luu=t(lanes_last(_spd(rng, (N, B), nu))),
        Lxu=t(0.05 * rng.normal(size=(N, nx, nu, B))))
    VxT = t(rng.normal(size=(nx, B)))
    VxxT = t(lanes_last(_spd(rng, (B,), nx)))
    return _poison(D, N), VxT, VxxT


def _feed(mode, D):
    """(the fields as the mode's launch takes them, their lane stride): K1's
    by ``tma_fields``, K2's as they are, K3's buffer by ``pack_derivs``
    and ``padded_packed``."""
    if mode == "stage":
        return K.tma_fields(D)
    if mode == "chunked":
        return list(D), D.Fx.shape[-1]
    P, ld = K.padded_packed(K.pack_derivs(D))
    return [P], ld


def _run(exe, mode, D, VxT, VxxT, lam, reg_type, workdir):
    """(ks, Ks, dV, ok) of the harness's ``mode`` unit and its TMA log's
    box lines (K3: (lane start, box bytes, shared offset))."""
    N, nx, nu, B = D.Fx.shape[0], D.Fx.shape[1], D.Fu.shape[2], lam.shape[0]
    fields, ld = _feed(mode, D)
    flat = torch.cat([a.flatten() for a in fields]
                     + [VxT.flatten(), VxxT.flatten(), lam])
    tag = f"{mode}_{nx}_{N}_{B}_{reg_type}"
    inp, outp, logp = (workdir / f"{k}_{tag}" for k in ("in", "out", "log"))
    inp.write_bytes(flat.numpy().tobytes())
    proc = subprocess.run([str(exe), str(MODES.index(mode)), str(nx),
                           str(N), str(B), str(reg_type), str(ld), str(inp),
                           str(outp), str(logp)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (mode, proc.returncode, proc.stderr)
    o = torch.from_numpy(np.frombuffer(
        outp.read_bytes(), dtype=np.float32 if lam.dtype == torch.float32
        else np.float64).copy())
    ks = o[:N * nu * B].reshape(N, nu, B)
    Ks = o[N * nu * B:N * nu * (nx + 1) * B].reshape(N, nu, nx, B)
    rest = o[N * nu * (nx + 1) * B:].reshape(3, B)
    boxes = [tuple(int(ln.split()[j]) for j in (3, 6, 5))
             for ln in logp.read_text().splitlines() if ln.startswith("L ")]
    return (ks, Ks, rest[:2], rest[2] != 0), boxes


@pytest.fixture(scope="module")
def k2k3_runs(k2k3_host, tmp_path_factory):
    """The harness's runs by (dtype, reg_type, shape, N): {B: (cfg, D, VxT,
    VxxT, lam, {mode: (outputs, boxes)})}, each B the first B lanes of one
    case (the centroidal rollout at (9, 16), seeded data at (2, 5))."""
    cache = {}

    def get(dtype, reg_type, shape=(9, 16), N=HORIZONS[0],
            batches=BATCHES):
        key = (dtype, reg_type, shape, N, batches)
        if key not in cache:
            if shape == (9, 16):
                D, VxT, VxxT = _centroidal(dtype, N)
            else:
                D, VxT, VxxT = _seeded(dtype, *shape, N)
            lam = torch.full((BATCHES[0],), 1e-6 if reg_type == 1 else 0.5,
                             dtype=dtype)
            cfg = DDPConfig(horizon_steps=N, reg_type=reg_type)
            d = tmp_path_factory.mktemp("k2k3_wide_runs")
            runs = {}
            for B in batches:
                cut = lambda a: a[..., :B].contiguous()
                args = (StackedDerivs(*map(cut, D)), cut(VxT), cut(VxxT),
                        cut(lam))
                runs[B] = (cfg, *args, {
                    mode: _run(k2k3_host[dtype], mode, *args, reg_type, d)
                    for mode in MODES})
            cache[key] = runs
        return cache[key]
    return get


def _hold(runs, label):
    """K2 and K3 equal K1 bit for bit with the same ok mask, and K1 equals
    ``backward_stacked`` with a correctly rounded sqrt on its ok lanes,
    the non-PD and NaN lanes failing and no other."""
    for B, (cfg, D, VxT, VxxT, lam, out) in runs.items():
        ref = out["stage"][0]
        for mode in MODES[1:]:
            got = out[mode][0]
            for name, a, b in zip(("ks", "Ks", "dV"), ref[:3], got[:3]):
                assert same(a, b), (label, B, mode, name)
            assert torch.equal(ref[3], got[3]), (label, B, mode)
        plain = plain_lanes(cfg, D, VxT, VxxT, lam)
        ok = plain[3]
        assert torch.equal(ref[3], ok), (label, B)
        bad = {1, 2} & set(range(B))
        assert not any(ok[list(bad)]) and int(ok.sum()) == B - len(bad)
        for name, a, b in zip(("ks", "Ks", "dV"), plain[:3], ref[:3]):
            assert torch.equal(a[..., ok].contiguous().view(torch.uint8),
                               b[..., ok].contiguous().view(torch.uint8)), (
                label, B, name)


@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2k3_wide_as_host_cpp(k2k3_runs, dtype, reg_type):
    """K2 and K3 at (9, 16) through their launch functions on the
    centroidal case (N = 10, a short last chunk in each) at B = 64, 37 and
    1: bit for bit with K1-wide (NaN lanes NaN where they are) and its ok
    mask, and K1-wide bit for bit with ``backward_stacked`` (correctly
    rounded sqrt) on every ok lane."""
    for dma in ("chunked", "packed"):
        C = (K.chunk_stages(9, 16, HORIZONS[0], dtype) if dma == "chunked"
             else K.wide_chunk_stages(9, 16, dtype, K.WIDE_BOX_ROWS))
        assert HORIZONS[0] % C != 0, (dma, C)
    _hold(k2k3_runs(dtype, reg_type), f"(9, 16) {dtype} reg {reg_type}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2k3_wide_second_horizon(k2k3_runs, dtype):
    """N = 12 at B = 64 (fp32: 9 + 3 stages for K2, 8 + 4 for K3): held as
    at N = 10."""
    if dtype == torch.float32:
        assert K.chunk_stages(9, 16, 12, dtype) == 9
        assert K.wide_chunk_stages(9, 16, dtype, K.WIDE_BOX_ROWS) == 8
    _hold(k2k3_runs(dtype, 1, N=HORIZONS[1], batches=(64,)),
          f"(9, 16) N=12 {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2k3_wide_seeded_shape(k2k3_runs, dtype):
    """(2, 5), a wide shape by its inputs, on seeded data with a non-PD
    and a NaN lane, at B = 64 and 37: held as at (9, 16)."""
    assert K.wide_shape(2, 5)
    _hold(k2k3_runs(dtype, 2, shape=(2, 5), batches=(64, 37)),
          f"(2, 5) {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k3_wide_boxes(k2k3_runs, dtype):
    """K3's TMA boxes at (9, 16): each kWideBoxRows (256) rows of the
    block's 4 lanes (the map's extents, all <= 256, checked by the shim's
    encode), every box row starting at a lane 16 bytes aligned (the shim
    also refuses any other), every box landing 128-byte aligned, and as
    many boxes as the chunks' rows need (a box wholly before stage 0 not
    issued)."""
    size = torch.empty((), dtype=dtype).element_size()
    C = K.wide_chunk_stages(9, 16, dtype, K.WIDE_BOX_ROWS)
    _, F = K.field_offsets(9, 16)
    rows = -(-C * F // K.WIDE_BOX_ROWS) * K.WIDE_BOX_ROWS
    for B, run in k2k3_runs(dtype, 1).items():
        boxes = run[-1]["packed"][1]
        blocks = -(-B // 4)
        for c0, nbytes, offset in boxes:
            assert c0 % 4 == 0 and (c0 * size) % 16 == 0
            assert nbytes == K.WIDE_BOX_ROWS * 4 * size
            assert offset % 128 == 0
        N = HORIZONS[0]
        want = 0
        for c in range(-(-N // C)):
            first = (N - (c + 1) * C) * F
            skip = -first // K.WIDE_BOX_ROWS if first < 0 else 0
            want += rows // K.WIDE_BOX_ROWS - skip
        assert len(boxes) == blocks * want, (B, len(boxes))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_chunk_rule_is_the_header_rule(k2k3_host, dtype):
    """The wrapper's ``wide_chunk_stages`` (K2's and K3's) equals the
    header's ``WideChunkBlock::chunk`` at every wide (nx, nu) <= (9, 16),
    and both blocks at that chunk and their most lanes (4) fit 227 KB."""
    proc = subprocess.run([str(k2k3_host[dtype]), "rules"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    lines = [list(map(int, ln.split())) for ln in proc.stdout.splitlines()]
    assert [tuple(v[:2]) for v in lines] == WIDE
    for nx, nu, c2, c3, lanes, bytes2, bytes3 in lines:
        assert K.wide_chunk_stages(nx, nu, dtype) == c2, (nx, nu)
        assert K.wide_chunk_stages(nx, nu, dtype, K.WIDE_BOX_ROWS) == c3
        assert lanes == 4
        assert bytes2 <= BLOCK_SMEM and bytes3 <= BLOCK_SMEM, (nx, nu)
        assert K.chunk_stages(nx, nu, 1000, dtype) == c2
    at = {tuple(v[:2]): v[2:4] for v in lines}
    assert at[9, 16] == ([9, 8] if dtype == torch.float32 else [4, 3])


def test_k2k3_wide_units_and_limits():
    """The wrapper builds each mode's wide header at a wide shape, under
    its own library name, and the narrow one elsewhere; every mode takes
    nx <= 9, nu <= 16 at fp32 and fp64 and raises past them, naming the
    shape, before any unit is built."""
    for dtype, name in DTYPES.items():
        for dma in ("chunked", "packed"):
            text = K.unit_source(9, 16, dtype, dma)
            assert f'#include "ddp_backward_{dma}_wide.cuh"' in text
            assert f"launch_ddp_backward_{dma}_wide<{name}, 9, 16>(" in text
            assert f"_{dma}_wide" not in K.unit_source(8, 4, dtype, dma)
            assert K.unit_name(9, 16, dtype, dma) != K.unit_name(
                9, 16, dtype)
        for dma in MODES:
            assert K.kernel_supports(9, 16, dtype, dma)
            assert not K.kernel_supports(10, 16, dtype, dma)
            assert not K.kernel_supports(9, 17, dtype, dma)
    for dma in MODES:
        for shape in ((10, 16), (9, 17)):
            with pytest.raises(ValueError, match=rf"\({shape[0]}, "
                                                 rf"{shape[1]}\)"):
                K._launch(dma, DDPConfig(), 3, *shape, (), None, None,
                          torch.zeros(4))
