"""The sweep-fed DDP backward K1 (``csrc/ddp_backward.cuh``) at the
centroidal model's (nx, nu) = (9, 16), on the CPU.

Where ``g++`` is on PATH the kernel is built as host C++ through its
launch function (``tests/host_shim.py``: each warp as 32 host threads,
``tma.cuh`` replaced by a stand-in that copies a box at once and checks
every barrier, no contraction, as the units' ``-fmad=false``) at fp32 and
fp64, and run on the stage fields of a centroidal rollout whose horizon
crosses the flight phase (every input masked there), with a non-PD and a
NaN lane: every G (threads per lane) equals G = 1 bit for bit (NaN lanes
NaN where they are), and G = 1 equals ``backward_stacked`` with a
correctly rounded sqrt on every lane it calls ok, with the same ok mask.
Also held: the ring and field offsets ``csrc/row_group.cuh`` gives at
(9, 16) (two buffers at fp32, one at fp64, within a block's 227 KB),
the wrapper's limits, and the solver's ``auto`` rule on the centroidal
model (the code generator refuses it, so K1 serves it on the card).
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
# kRowGroup<9, 16> and the other group sizes held against G = 1
GROUPS = (1, 2, 4)
# the lanes of the ragged run: a lane stride TMA does not take at fp32, a
# ragged last warp (G = 4: 8 lanes a warp) and block (G = 1: 32 a block)
RAGGED = 37

_HARNESS = SHIM + KERNELS_PRELUDE + r"""
#include "ddp_backward.cuh"

// in: the seven fields at lane stride ld (each [N][size][ld]), VxT, VxxT,
// lam; out: ks [N][NU][B], Ks [N][NU][NX][B], dV [2][B], ok [B]; then the
// ring's geometry: Layout offsets, F, R, bytes of a 32-lane ring
template <typename T, int G>
int run(int N, int B, int reg_type, int ld, const T* in, T* out) {
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
  const int err = nmpc::launch_ddp_backward<T, NX, NU, G>(
      N, B, ld, reg_type, fields, VxT, VxxT, lam, out,
      out + static_cast<size_t>(N) * NU * B, dV, ok.data(), nullptr);
  if (err) return 20 + err;
  for (int b = 0; b < B; ++b) dV[2 * B + b] = ok[b];
  using L = nmpc::StageRingLayout<T, NX, NU, G>;
  constexpr int R = nmpc::stage_ring<T>(L::F);
  std::printf("%d %d %d %d %d %d %d %d %d %zu\n", L::Fx, L::Fu, L::Lx, L::Lu,
              L::Lxx, L::Luu, L::Lxu, L::F, R,
              nmpc::ring_bytes<T>(R, 1, L::F, nmpc::kMaxRowLanes));
  return 0;
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
  if (G == 1) err = run<T, 1>(N, B, reg_type, ld, in.data(), out.data());
  if (G == 2) err = run<T, 2>(N, B, reg_type, ld, in.data(), out.data());
  if (G == 4) err = run<T, 4>(N, B, reg_type, ld, in.data(), out.data());
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
"""

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


@pytest.fixture(scope="module")
def k1_wide_runs(k1_wide_host, tmp_path_factory):
    """The harness's runs by (dtype, reg_type): (D, VxT, VxxT, lam, {G:
    (outputs, geometry)}, {G: outputs}), the last of the first RAGGED lanes
    alone (their fields copied to a lane stride TMA takes, a ragged last
    warp and block)."""
    cache = {}

    def get(dtype, reg_type):
        if (dtype, reg_type) not in cache:
            D, VxT, VxxT = _centroidal_case(dtype)
            lam = torch.full((VxT.shape[1],), 1e-6 if reg_type == 1 else 0.5,
                             dtype=dtype)
            d = tmp_path_factory.mktemp("k1_wide_runs")
            (d / "ragged").mkdir()
            cut = lambda a: a[..., :RAGGED].contiguous()
            Dr = StackedDerivs(*map(cut, D))
            cache[dtype, reg_type] = (D, VxT, VxxT, lam, {
                G: _run(k1_wide_host[dtype], D, VxT, VxxT, lam, reg_type, G,
                        d) for G in GROUPS}, {
                G: _run(k1_wide_host[dtype], Dr, cut(VxT), cut(VxxT),
                        cut(lam), reg_type, G, d / "ragged")[0]
                for G in GROUPS})
        return cache[dtype, reg_type]
    return get


@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_wide_as_host_cpp(k1_wide_runs, monkeypatch, dtype, reg_type):
    """K1 at (9, 16) through its launch function: every G equal to G = 1
    bit for bit (NaN lanes NaN where they are), at B = 64 and on its first
    37 lanes alone; G = 1 equal to ``backward_stacked`` with a correctly
    rounded sqrt bit for bit on every lane it calls ok, the ok masks equal
    (the non-PD and NaN lanes fail, no other), and the flight stages'
    gains exactly 0.  (B = 64: torch's CPU float32 sums over the 16-wide
    axes take another order on lanes past a multiple of its vector
    width, as the B = 37 plain run would.)"""
    D, VxT, VxxT, lam, runs, ragged = k1_wide_runs(dtype, reg_type)
    ref1 = runs[1][0]
    for G, (out, _) in runs.items():
        for name, a, b in zip(("ks", "Ks", "dV"), ref1[:3], out[:3]):
            assert same(a, b), (G, name)
        assert torch.equal(ref1[3], out[3]), G
    for G, out in ragged.items():
        for name, a, b in zip(("ks", "Ks", "dV"), ref1[:3], out[:3]):
            assert same(a[..., :RAGGED].contiguous(), b), (G, name)
        assert torch.equal(ref1[3][:RAGGED], out[3]), G
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", exact_sqrt)
        ref = backward_stacked(DDPConfig(horizon_steps=D.Fx.shape[0],
                                         reg_type=reg_type), D, VxT, VxxT,
                               lam)
    ok = ref[3]
    assert torch.equal(ref1[3], ok)
    assert not ok[1] and not ok[2] and int(ok.sum()) == lam.shape[0] - 2
    for name, a, b in zip(("ks", "Ks", "dV"), ref[:3], ref1[:3]):
        assert torch.equal(a[..., ok].contiguous().view(torch.uint8),
                           b[..., ok].contiguous().view(torch.uint8)), name
    assert torch.all(ref1[0][-3:][..., ok] == 0)
    assert torch.all(ref1[1][-3:][..., ok] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_wide_ring_fits(k1_wide_runs, dtype):
    """The ring ``row_group.cuh::stage_ring`` gives K1 at (9, 16): every
    field on a 128-byte boundary of a warp's lanes with the packed order's
    sizes, two one-stage buffers at fp32 (F = 740) and one at fp64 (F =
    734), where two would pass a block's 227 KB, and a 32-lane block's
    ring within it."""
    size = 4 if dtype == torch.float32 else 8
    sizes = (NX * NX, NX * NU, NX, NU, NX * NX, NU * NU, NX * NU)
    for G, (_, geo) in k1_wide_runs(dtype, 1)[4].items():
        *off, F, R, ring = geo
        W = 32 // G
        for o, o_next, n in zip(off, off[1:] + [F], sizes):
            assert (o * W * size) % 128 == 0 and o_next - o >= n, G
        assert ring <= BLOCK_SMEM, G
        assert 128 + (R + 1) * F * 32 * size > BLOCK_SMEM or R == 8, G
        if G == 4:
            assert (F, R) == ((740, 2) if size == 4 else (734, 1))


def test_k1_wide_limits_and_auto_rule():
    """K1 takes nx <= 9, nu <= 16; K2 and K3 stay at nx <= 8, nu <= 4 and
    their launch raises, naming the shape, before any unit is built.  The
    code generator refuses the centroidal model (its torch.linalg.cross),
    so neither remat kernel takes it and ``auto`` picks the sweep-fed K1
    for an unboxed first-order solve on a CUDA device; a boxed one (nu =
    16 > 4) and a second-order one take the plain backward."""
    assert K.kernel_supports(9, 16, torch.float32)
    assert K.kernel_supports(9, 16, torch.float64, "stage")
    assert not K.kernel_supports(10, 16, torch.float32)
    assert not K.kernel_supports(9, 17, torch.float32)
    for dma in ("chunked", "packed"):
        assert K.kernel_supports(8, 4, torch.float32, dma)
        assert not K.kernel_supports(9, 16, torch.float32, dma)
        with pytest.raises(ValueError, match=r"\(9, 16\)"):
            K._launch(dma, DDPConfig(), 3, 9, 16, (), None, None,
                      torch.zeros(4))
    p = make_centroidal_problem(DT)
    boxed = make_centroidal_problem(DT, force_limits=(0.0, 1000.0))
    cuda = torch.device("cuda")
    for dtype in (torch.float32, torch.float64):
        assert not remat_supported(p, NX, NU, dtype)
        assert not forward_remat_supported(p, NX, NU, dtype)
        assert ddp._resolve_backward_impl(DDPConfig(), p, dtype, cuda,
                                          False, False) == "pallas"
        assert ddp._resolve_backward_impl(DDPConfig(), boxed, dtype, cuda,
                                          True, False) == "stacked"
        assert ddp._resolve_backward_impl(DDPConfig(), p, dtype, cuda,
                                          False, True) == "stacked"
        assert ddp._resolve_backward_impl(DDPConfig(), p, dtype,
                                          torch.device("cpu"), False,
                                          False) == "stacked"
