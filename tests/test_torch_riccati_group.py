"""The group Riccati stage of the unboxed DDP backward kernels, on the CPU.

The packed backward (K3, ``csrc/ddp_backward_packed.cuh``) and the unboxed
remat backward (K5, ``csrc/ddp_backward_remat.cuh``) run each lane's stage
on a group of G threads with ``csrc/riccati_stage.cuh::
riccati_stage_group``: each thread owns rows of the NX-row products, the
group exchanges Vn by whole-warp shuffles, and every value is computed by
one thread in the order of the one-thread stage.  Held here:

* where ``g++`` is on PATH, ``riccati_stage.cuh`` compiled as host C++
  without contraction (the units' ``-fmad=false``), with a shim that runs
  each 32-thread warp as 32 host threads meeting at every shuffle (the
  lanes of a warp are 32 / G consecutive lanes, a ragged last warp runs
  the last lane without storing, as on the card), through the whole
  N-stage recursion on cart-pole (4, 1) and bipedal (2, 1) stage fields
  with a non-PD and a NaN lane, both ``reg_type``s, fp32 and fp64: every
  thread of a group ends with the same bits, every G equals G = 1 bit for
  bit, and G = 1 equals ``backward_stacked`` run with a correctly rounded
  ``sqrt`` (torch's vectorized CPU ``sqrt`` is not; the card's and the
  host build's are);
* the size rules of ``csrc/row_group.cuh``, built by g++ as host code:
  K3's chunk schedule (``packed_chunk``) covers every stage once, from
  the end of the horizon, at the chunk sizes its launch picks, within a
  block's shared memory; K5's field slab stays within it at every shape
  the generator takes (fewer lanes a block, or one thread per lane with
  the fields in registers); and the lane stride K3's tensor map takes
  (``padded_packed``).
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from nmpc_tpu_torch import DDPConfig
from nmpc_tpu_torch.kernels import ddp_backward_fused as K
from nmpc_tpu_torch.kernels.build import CSRC
from nmpc_tpu_torch.kernels.ddp_backward import StackedDerivs, backward_stacked
from nmpc_tpu_torch.models.bipedal import (example_omega2_func,
                                           example_ref_zmp_func,
                                           make_bipedal_problem)
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.solvers import ddp

from host_shim import (KERNELS_PRELUDE, SHIM as _SHIM, bits as _bits,
                       build_kernels_host, exact_sqrt as _exact_sqrt,
                       same as _same)

torch.set_num_threads(1)

DT = 0.01
# the group sizes measured on the card, per (nx, nu)
GROUPS = {(4, 1): (1, 2, 4, 8), (2, 1): (1, 2)}


_HARNESS = _SHIM + r"""
#include "riccati_stage.cuh"

// in: P [N][F][B], VxT [NX][B], VxxT [NX][NX][B], lam [B]; out: per rank
// and lane ks [N][NU], Ks [N][NU][NX], dV0, dV1, ok
template <typename T, int NX, int NU, int G>
void run(int N, int B, int reg_type, const T* P, const T* VxT,
         const T* VxxT, const T* lam, T* out) {
  constexpr int F = nmpc::PackedLayout<NX, NU>::F;
  const size_t W = static_cast<size_t>(N) * NU * (NX + 1) + 3;
  std::vector<std::thread> warp;
  for (unsigned t = 0; t < 32; ++t) {
    warp.emplace_back([&, t] {
      threadIdx.x = t;
      for (int blk = 0; blk * (32 / G) < B; ++blk) {
        // a slot past the end runs the last lane and stores nothing, as
        // the kernels' ragged last block does
        const int slot = blk * (32 / G) + static_cast<int>(t) / G;
        const int b = slot < B ? slot : B - 1;
        nmpc::Carry<T, NX> carry;
        for (int a = 0; a < NX; ++a) {
          carry.Vx[a] = VxT[a * B + b];
          for (int e = 0; e < NX; ++e)
            carry.Vxx[a][e] = VxxT[(a * NX + e) * B + b];
        }
        carry.dV0 = T(0);
        carry.dV1 = T(0);
        carry.ok = true;
        T* o = out + (static_cast<size_t>(t % G) * B + b) * W;
        for (int i = N - 1; i >= 0; --i) {
          T k[NU], Kg[NU][NX];
          nmpc::riccati_stage_group<T, NX, NU, G>(
              P + static_cast<size_t>(i) * F * B + b, B, lam[b], reg_type,
              carry, k, Kg);
          if (slot >= B) continue;
          for (int a = 0; a < NU; ++a) {
            o[i * NU + a] = k[a];
            for (int e = 0; e < NX; ++e)
              o[static_cast<size_t>(N) * NU + (i * NU + a) * NX + e] =
                  Kg[a][e];
          }
        }
        if (slot >= B) continue;
        o[W - 3] = carry.dV0;
        o[W - 2] = carry.dV1;
        o[W - 1] = carry.ok ? T(1) : T(0);
      }
    });
  }
  for (auto& th : warp) th.join();
}

template <typename T, int NX, int NU>
int dispatch(int G, int N, int B, int reg_type, const T* P, const T* VxT,
             const T* VxxT, const T* lam, T* out) {
  switch (G) {
    case 1: run<T, NX, NU, 1>(N, B, reg_type, P, VxT, VxxT, lam, out); return 0;
    case 2: run<T, NX, NU, 2>(N, B, reg_type, P, VxT, VxxT, lam, out); return 0;
    case 4: run<T, NX, NU, 4>(N, B, reg_type, P, VxT, VxxT, lam, out); return 0;
    case 8: run<T, NX, NU, 8>(N, B, reg_type, P, VxT, VxxT, lam, out); return 0;
  }
  return 2;
}

template <typename T>
int main_t(int nx, int G, int N, int B, int reg_type, const char* in_path,
           const char* out_path) {
  const int nu = 1;
  const int F = 2 * nx * nx + 2 * nx * nu + nx + nu + nu * nu;
  const size_t nP = static_cast<size_t>(N) * F * B;
  const size_t n_in = nP + static_cast<size_t>(nx + nx * nx + 1) * B;
  const size_t n_out = static_cast<size_t>(G) * B *
                       (static_cast<size_t>(N) * nu * (nx + 1) + 3);
  std::vector<T> in(n_in), out(n_out);
  FILE* f = std::fopen(in_path, "rb");
  if (!f || std::fread(in.data(), sizeof(T), n_in, f) != n_in) return 4;
  std::fclose(f);
  const T* P = in.data();
  const T* VxT = P + nP;
  const T* VxxT = VxT + static_cast<size_t>(nx) * B;
  const T* lam = VxxT + static_cast<size_t>(nx) * nx * B;
  int err = 2;
  if (nx == 4)
    err = dispatch<T, 4, 1>(G, N, B, reg_type, P, VxT, VxxT, lam, out.data());
  else if (nx == 2)
    err = dispatch<T, 2, 1>(G, N, B, reg_type, P, VxT, VxxT, lam, out.data());
  if (err) return err;
  f = std::fopen(out_path, "wb");
  if (!f || std::fwrite(out.data(), sizeof(T), n_out, f) != n_out) return 5;
  std::fclose(f);
  return 0;
}

// riccati_group_host float|double nx G N B reg_type in out  (nu = 1)
int main(int argc, char** argv) {
  if (argc != 9) return 1;
  const int nx = std::atoi(argv[2]), G = std::atoi(argv[3]),
            N = std::atoi(argv[4]), B = std::atoi(argv[5]),
            reg_type = std::atoi(argv[6]);
  if (std::strcmp(argv[1], "float") == 0)
    return main_t<float>(nx, G, N, B, reg_type, argv[7], argv[8]);
  return main_t<double>(nx, G, N, B, reg_type, argv[7], argv[8]);
}
"""


@pytest.fixture(scope="module")
def group_host(tmp_path_factory):
    """The harness executable: ``riccati_stage.cuh`` built by g++ as host
    code, without contraction (the kernels' ``-fmad=false``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ on PATH")
    d = tmp_path_factory.mktemp("riccati_group_host")
    (d / "riccati_group_host.cpp").write_text(_HARNESS)
    exe = d / "riccati_group_host"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-pthread", f"-I{CSRC}", "-o", str(exe),
                    str(d / "riccati_group_host.cpp")], check=True,
                   capture_output=True, timeout=600)
    return exe


def _stage_case(model, dtype, B=37, N=12):
    """First-iteration stage fields (D, Vx_T, Vxx_T) of ``model`` from a
    rollout made from a seed: the cart-pole from t0 = 0.3, the bipedal
    CoM-ZMP model from t0 = 1.45 (the horizon crosses the footstep at
    1.5 s); lane 1 non-PD (Luu = -10), lane 2 NaN from stage N / 2."""
    rng = np.random.default_rng(7)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()
    if model == "cart-pole":
        p, t0 = make_cartpole_problem(DT), 0.3
        x0s = (np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
               + 0.05 * rng.normal(size=(B, 4)))
        us = 0.2 * rng.normal(size=(N, 1, B))
    else:
        p = make_bipedal_problem(DT, example_ref_zmp_func(20.0),
                                 example_omega2_func())
        t0 = 1.45
        x0s = 0.05 * rng.normal(size=(B, 2))
        us = 0.02 * rng.normal(size=(N, 1, B))
    cfg = DDPConfig(horizon_steps=N)
    t0, us = as_t(t0), as_t(us)
    xs, _ = ddp._rollout_lanes(p, cfg, t0, as_t(x0s.T), us)
    D, VxT, VxxT = ddp._derivative_sweep_lanes(p, cfg, t0, xs, us)
    D = StackedDerivs(*(a.contiguous() for a in D[:7]))
    D.Luu[:, :, :, 1] = -10.0
    D.Fx[N // 2, 0, 0, 2] = float("nan")
    return D, VxT.contiguous(), VxxT.contiguous()


def _host_run(exe, D, VxT, VxxT, lam, reg_type, group, workdir: Path):
    """(ks, Ks, dV, ok) of every lane from the harness with ``group``
    threads per lane, after asserting that every thread of a group ended
    with the same bits."""
    N, nx, B = D.Fx.shape[0], D.Fx.shape[1], lam.shape[0]
    dtype = lam.dtype
    flat = torch.cat([K.pack_derivs(D).flatten(), VxT.flatten(),
                      VxxT.flatten(), lam])
    inp, outp = workdir / f"in{group}.bin", workdir / f"out{group}.bin"
    inp.write_bytes(flat.numpy().tobytes())
    subprocess.run([str(exe), "float" if dtype == torch.float32 else
                    "double", str(nx), str(group), str(N), str(B),
                    str(reg_type), str(inp), str(outp)], check=True,
                   timeout=300)
    W = N * (nx + 1) + 3
    out = torch.from_numpy(np.frombuffer(
        outp.read_bytes(), dtype=np.float32 if dtype == torch.float32
        else np.float64).copy()).reshape(group, B, W)
    for rank in range(1, group):
        assert _same(out[rank], out[0]), rank
    o = out[0].T
    ks = o[:N].reshape(N, 1, B)
    Ks = o[N:N + N * nx].reshape(N, 1, nx, B)
    return ks, Ks, o[-3:-1], o[-1] != 0


@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", ["cart-pole", "bipedal"])
def test_group_stage_as_host_cpp(group_host, tmp_path, monkeypatch, model,
                                 dtype, reg_type):
    """``riccati_stage_group`` on the host through the whole recursion at
    every G measured on the card: the group's threads agree bit for bit,
    every G equals G = 1 bit for bit (the NaN lane NaN where it is), and
    G = 1 equals
    ``backward_stacked`` with a correctly rounded sqrt on every lane it
    calls ok, with the same ok mask (the non-PD and NaN lanes fail)."""
    D, VxT, VxxT = _stage_case(model, dtype)
    B, nx = VxT.shape[1], VxT.shape[0]
    lam = torch.full((B,), 1e-4 if reg_type == 1 else 0.5, dtype=dtype)
    runs = {G: _host_run(group_host, D, VxT, VxxT, lam, reg_type, G,
                         tmp_path) for G in GROUPS[nx, 1]}
    for G, out in runs.items():
        for name, a, b in zip(("ks", "Ks", "dV"), runs[1][:3], out[:3]):
            assert _same(a, b), (G, name)
        assert torch.equal(runs[1][3], out[3]), G
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", _exact_sqrt)
        ref = backward_stacked(DDPConfig(horizon_steps=D.Fx.shape[0],
                                         reg_type=reg_type), D, VxT, VxxT,
                               lam)
    ok = ref[3]
    assert torch.equal(runs[1][3], ok)
    assert not ok[1] and not ok[2] and int(ok.sum()) == B - 2
    for name, a, b in zip(("ks", "Ks", "dV"), ref[:3], runs[1][:3]):
        assert torch.equal(_bits(a[..., ok]), _bits(b[..., ok])), name


# (nx, nu) of the geometry checks: the models' shapes, the largest K3
# takes, and K5 shapes up to the generator's 16 x 16 fields
REMAT_SHAPES = ((4, 1), (2, 1), (8, 1), (8, 4), (12, 4), (16, 1), (16, 9),
                (16, 10), (16, 16))
PACKED_SHAPES = ((4, 1), (2, 1), (1, 1), (8, 4))
# the smem budget of a block (row_group.cuh::kMaxBlockSmem, the H100's)
BLOCK_SMEM = 227 * 1024

_GEOMETRY = _SHIM + r"""
// remat_common.cuh's rounding intrinsics (parsed, never called here)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
#include "row_group.cuh"

template <typename T, int NX, int NU>
void remat_line(int B) {
  constexpr int F = nmpc::PackedLayout<NX, NU>::F;
  constexpr int G = nmpc::kRematLaneGroup<T, NX, NU>;
  const int L = nmpc::remat_lanes<T, G>(F, B);
  const int Lx = nmpc::row_lanes<(G > 0 ? G : 1)>(B);
  std::printf("remat %d %d %d %d %d %d %d %d %zu\n", int(sizeof(T)), NX, NU,
              B, F, G, L, Lx, nmpc::remat_smem_bytes<T, G>(F, L));
}

template <typename T, int NX, int NU, int G>
void packed_line(int N, int B) {
  constexpr int F = nmpc::PackedLayout<NX, NU>::F;
  const int C = nmpc::packed_chunk_stages<T>(F, N);
  const int L = nmpc::row_lanes<G>(B);
  std::printf("packed %d %d %d %d %d %d %d %zu\n", int(sizeof(T)), NX, NU, G,
              N, B, C, (L / (32 / G)) * nmpc::ring_bytes<T>(
                                             nmpc::kPackedRing, C, F, 32 / G));
}

// K1's padded stage (its offsets), ring and block bytes; K2's chunk and
// block bytes, at (N, B)
template <typename T, int NX, int NU, int G>
void sweep_line(int N, int B) {
  using S = nmpc::StageRingLayout<T, NX, NU, G>;
  constexpr int F = nmpc::PackedLayout<NX, NU>::F;
  constexpr int W = 32 / G;
  const int R = nmpc::stage_ring<T>(S::F);
  const int C = nmpc::chunked_chunk_stages<T>(F, N);
  const int L = nmpc::row_lanes<G>(B);
  std::printf("sweep %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %zu %d "
              "%zu\n", int(sizeof(T)), NX, NU, G, N, B, S::Fx, S::Fu, S::Lx,
              S::Lu, S::Lxx, S::Luu, S::Lxu, S::F, R, L,
              nmpc::ring_bytes<T>(R, 1, S::F, L), C,
              (L / W) * nmpc::chunked_warp_bytes<T>(C, F, W));
}

template <typename T>
void threshold_line() {
  int F = 1;
  while (nmpc::slab_warps<T, 8>(F) > 0 && nmpc::slab_warps<T, 1>(F) > 0) ++F;
  std::printf("threshold %d %d\n", int(sizeof(T)), F);
}

void chunks_line(int N, int C) {
  std::printf("chunks %d %d", N, C);
  for (int c = 0; c < nmpc::packed_chunks(N, C); ++c) {
    const nmpc::PackedChunk k = nmpc::packed_chunk(c, N, C);
    std::printf(" %d:%d:%d", k.start, k.lo, k.hi);
  }
  std::printf("\n");
}

int main() {
@BODY@
  return 0;
}
"""


def _geometry_body():
    """The calls of the geometry harness: K5 per shape, type and B; K3 per
    shape, type, G and (N, B); the slab threshold; K3's chunks of every N
    at the C it picks and at C = 1 and C past N."""
    lines = []
    for T in ("float", "double"):
        for nx, nu in REMAT_SHAPES:
            for B in (4096, 2048, 256, 1):
                lines.append(f"remat_line<{T}, {nx}, {nu}>({B});")
        for nx, nu in PACKED_SHAPES:
            for G in (1, 2, 4, 8):
                for N, B in ((100, 4096), (300, 2048), (5, 300)):
                    lines.append(f"packed_line<{T}, {nx}, {nu}, {G}>({N}, "
                                 f"{B});")
        for nx in range(1, 9):
            for nu in range(1, 5):
                for G in (1, 2, 4, 8):
                    for N, B in ((100, 4096), (300, 2048), (7, 37)):
                        lines.append(f"sweep_line<{T}, {nx}, {nu}, {G}>({N}, "
                                     f"{B});")
        lines.append(f"threshold_line<{T}>();")
        for nx, nu in PACKED_SHAPES:
            for N in (100, 300, 7):
                for C in (f"nmpc::packed_chunk_stages<{T}>(nmpc::"
                          f"PackedLayout<{nx}, {nu}>::F, {N})", "1",
                          str(N + 3)):
                    lines.append(f"chunks_line({N}, {C});")
    return "\n".join("  " + line for line in lines)


@pytest.fixture(scope="module")
def geometry(tmp_path_factory):
    """What ``csrc/row_group.cuh``'s size rules give, from the header built
    by g++ as host code: {"remat": {(itemsize, nx, nu, B): (F, G, L,
    row_lanes, smem)}, "packed": {(itemsize, nx, nu, G, N, B): (C, smem)},
    "threshold": {itemsize: F}, "chunks": {(N, C): [(start, lo, hi)]},
    "sweep": {(itemsize, nx, nu, G, N, B): (Fx, Fu, Lx, Lu, Lxx, Luu, Lxu,
    F, R, L, smem, C, smem)} (K1's padded stage, ring and block bytes, K2's
    chunk and block bytes)}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ on PATH")
    d = tmp_path_factory.mktemp("row_group_host")
    (d / "cuda_runtime.h").write_text("#pragma once\n")
    (d / "geometry.cpp").write_text(
        _GEOMETRY.replace("@BODY@", _geometry_body()))
    exe = d / "geometry"
    subprocess.run([gxx, "-std=c++20", "-O0", "-pthread", f"-I{d}",
                    f"-I{CSRC}", "-o", str(exe), str(d / "geometry.cpp")],
                   check=True, capture_output=True, timeout=600)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, timeout=60).stdout
    found = {"remat": {}, "packed": {}, "threshold": {}, "chunks": {},
             "sweep": {}}
    for line in out.splitlines():
        kind, *rest = line.split()
        if kind == "chunks":
            found[kind].setdefault((int(rest[0]), int(rest[1])), [
                tuple(map(int, c.split(":"))) for c in rest[2:]])
            continue
        v = list(map(int, rest))
        if kind == "remat":
            found[kind][tuple(v[:4])] = tuple(v[4:])
        elif kind in ("packed", "sweep"):
            found[kind][tuple(v[:6])] = tuple(v[6:])
        else:
            found[kind][v[0]] = v[1]
    return found


@pytest.mark.parametrize("N", [100, 300, 7])
def test_packed_chunks_cover_every_stage(geometry, N):
    """K3's chunks as the kernel walks them (``row_group.cuh::
    packed_chunk``), at every C its launch picks for the shapes K3 takes
    (and C = 1, and C past N): every stage once, from the end of the
    horizon, each box of C stages holding its chunk."""
    cases = {key: chunks for key, chunks in geometry["chunks"].items()
             if key[0] == N}
    assert {1, N + 3} < {C for _, C in cases}
    for (_, C), chunks in cases.items():
        stages = [i for _, lo, hi in chunks for i in reversed(range(lo, hi))]
        assert stages == list(reversed(range(N))), C
        for start, lo, hi in chunks:
            assert lo == max(0, start) and hi - start == C and hi > lo


def test_packed_chunk_stages_and_lane_stride(geometry):
    """The chunk sizes K3's launch picks (``packed_chunk_stages``) within a
    block's shared memory at every G and shape it takes, the largest
    ((8, 4), fp64) included, and the lane stride of its tensor map: a
    multiple of 16 bytes."""
    C = {(size, nx, nu, N): v[0]
         for (size, nx, nu, _, N, _), v in geometry["packed"].items()}
    assert (C[4, 4, 1, 100], C[8, 4, 1, 100]) == (4, 2)
    assert (C[4, 2, 1, 300], C[8, 2, 1, 300]) == (12, 6)
    assert C[4, 1, 1, 5] == 5 and C[8, 8, 4, 100] == 1
    assert all(1 <= c <= 32 for c in C.values())
    for key, (_, smem) in geometry["packed"].items():
        assert smem <= BLOCK_SMEM, key
    assert [K.packed_lane_stride(B, torch.float32)
            for B in (4096, 1023, 1, 4)] == [4096, 1024, 4, 4]
    assert [K.packed_lane_stride(B, torch.float64)
            for B in (2048, 1023, 1)] == [2048, 1024, 2]


@pytest.mark.parametrize("itemsize", [4, 8])
def test_remat_slab_fits_shared_memory(geometry, itemsize):
    """K5's field slab stays within a block's shared memory at every shape
    the generator takes: lanes per block halved from ``row_lanes`` as far
    as the slab needs (the cart-pole's geometry unchanged; (8, 1) at fp64,
    F = 154, 16 lanes at B=4096), and one thread per lane with the fields
    in registers (G = 0, no shared memory) where not even a warp's slab
    fits (F from 906 at fp64, from 1810 at fp32, past the generator's
    largest, 1312)."""
    remat = {key[1:]: v for key, v in geometry["remat"].items()
             if key[0] == itemsize}
    threshold = geometry["threshold"][itemsize]
    assert threshold == {8: 906, 4: 1810}[itemsize]
    for (nx, nu, B), (F, G, L, row, smem) in remat.items():
        assert smem <= BLOCK_SMEM, (nx, nu, B)
        if F >= threshold:
            assert (G, L, smem) == (0, 32, 0), (nx, nu, B)
            continue
        assert G == (8 if nx >= 4 else 2 if nx >= 2 else 1), (nx, nu)
        assert L <= row and L % (32 // G) == 0 and L & (L - 1) == 0
        # halved no further than the slab needs
        assert L == row or 2 * smem > BLOCK_SMEM, (nx, nu, B)
    assert remat[4, 1, 4096][1:4] == (8, 32, 32)
    assert remat[4, 1, 256][1:4] == (8, 4, 4)
    if itemsize == 8:
        assert remat[8, 1, 4096][:3] == (154, 8, 16)
        assert remat[16, 10, 4096][1] == 0
    else:   # every shape the generator takes has a slab at fp32
        assert remat[16, 16, 4096][:3] == (1312, 8, 4)


def test_padded_packed_copies_only_a_ragged_stride():
    """``padded_packed`` hands a buffer whose lane stride TMA takes back as
    it is, and copies any other once into a padded one (counted), with the
    same values in the first B lanes."""
    P = torch.arange(3 * 16 * 1024, dtype=torch.float32).reshape(3, 16, 1024)
    before = K.backward_packed.padded_copies
    same, ld = K.padded_packed(P)
    assert same is P and ld == 1024
    assert K.backward_packed.padded_copies == before
    ragged = P[..., :1023].contiguous()
    padded, ld = K.padded_packed(ragged)
    assert ld == 1024 and padded.shape == (3, 16, 1024)
    assert torch.equal(padded[..., :1023], ragged)
    assert K.backward_packed.padded_copies == before + 1


@pytest.mark.parametrize("itemsize", [4, 8])
def test_stage_ring_and_chunk_slots_fit_shared_memory(geometry, itemsize):
    """K1's ring of one-stage buffers and K2's two chunk slots
    (``row_group.cuh::stage_ring``, ``chunked_chunk_stages``) keep a block
    within its shared memory at every (nx <= 8, nu <= 4) and G the kernels
    are built at, with at least two buffers or one stage a slot; K1's
    padded stage puts every field on a 128-byte boundary (TMA lands a box
    only there) with the packed order's sizes, and pads nothing where a
    value's row of lanes already takes 128 bytes."""
    seen = 0
    for (size, nx, nu, G, N, B), v in geometry["sweep"].items():
        if size != itemsize:
            continue
        seen += 1
        *off, F, R, L, smem1, C, smem2 = v
        sizes = (nx * nx, nx * nu, nx, nu, nx * nx, nu * nu, nx * nu)
        W = 32 // G
        for o, o_next, n in zip(off, off[1:] + [F], sizes):
            assert (o * W * size) % 128 == 0 and o_next - o >= n
            if W * size >= 128:
                assert o_next - o == n
        assert 2 <= R <= 8 and smem1 <= BLOCK_SMEM, (nx, nu, G, N, B)
        assert 1 <= C <= min(N, 32) and smem2 <= BLOCK_SMEM, (nx, nu, G, N)
        assert L <= 32 and L % W == 0
    assert seen == 8 * 4 * 4 * 3
    cart = geometry["sweep"][itemsize, 4, 1, 4, 100, 4096]
    bip = geometry["sweep"][itemsize, 2, 1, 2, 300, 2048]
    if itemsize == 4:
        assert (cart[7], cart[8], cart[11]) == (52, 8, 8)
        assert (bip[7], bip[8], bip[11]) == (18, 8, 24)
    else:
        assert (cart[7], cart[8], cart[11]) == (48, 8, 4)
        assert geometry["sweep"][8, 8, 4, 4, 100, 4096][7:9] == (220, 2)


def test_chunk_stages_is_the_header_rule(geometry):
    """The wrapper's ``chunk_stages`` (labels, tests) equals the chunk K2's
    launch picks (``row_group.cuh::chunked_chunk_stages``) at every shape
    and N."""
    for (size, nx, nu, _, N, _), v in geometry["sweep"].items():
        dtype = torch.float32 if size == 4 else torch.float64
        assert K.chunk_stages(nx, nu, N, dtype) == v[11], (size, nx, nu, N)


def test_tma_fields_pad_as_padded_packed():
    """K1's fields as its tensor maps take them (``tma_fields``): at a B
    whose lanes are a multiple of 16 bytes every field as it is; at B=1023
    every field copied once to the lane stride ``padded_packed`` gives K3's
    buffer; a field given as a view at a 4-byte offset copied alone, at
    the same stride; each copy counted and equal to its field."""
    rng = np.random.default_rng(3)
    shapes = ((4, 4), (4, 1), (4,), (1,), (4, 4), (1, 1), (4, 1))

    def fields(B, dtype):
        return StackedDerivs(*(torch.as_tensor(rng.normal(
            size=(5, *s, B)), dtype=dtype) for s in shapes))

    for dtype in (torch.float32, torch.float64):
        D = fields(1024, dtype)
        before = K.backward_fused.padded_copies
        out, ld = K.tma_fields(D)
        assert ld == 1024 and all(a is b for a, b in zip(out, D))
        assert K.backward_fused.padded_copies == before
        D = fields(1023, dtype)
        out, ld = K.tma_fields(D)
        assert ld == K.padded_packed(K.pack_derivs(D))[1] == 1024
        assert K.backward_fused.padded_copies == before + 7
        for a, b in zip(D, out):
            assert b.shape[-1] == ld and torch.equal(a, b[..., :1023])
        D = fields(1024, dtype)
        flat = torch.empty(D.Lxx.numel() + 1, dtype=dtype)
        view = flat[1:].view(D.Lxx.shape)
        view.copy_(D.Lxx)
        assert view.data_ptr() % 16 != 0
        out, ld = K.tma_fields(D._replace(Lxx=view))
        assert ld == 1024
        assert K.backward_fused.padded_copies == before + 8
        assert out[4] is not view and torch.equal(out[4], view)
        assert all(a is b for j, (a, b) in enumerate(zip(out, D)) if j != 4)


# The sweep-fed kernels (K1, K2, K3) on the host: the headers of csrc/
# copied with the launch syntax turned into a call of host_launch (every
# block, each warp as 32 threads, in turn), tma.cuh and cp_async.cuh
# replaced by stand-ins that copy at once, and the launch functions called
# as the units call them.



_KERNELS_HOST = _SHIM + KERNELS_PRELUDE + r"""
#include "ddp_backward_chunked.cuh"
#include "ddp_backward_packed.cuh"

// in: K1's fields at lane stride ld1 (each [N][size][ld1]), K3's P
// [N][F][ld3], K2's fields at B, VxT, VxxT, lam; out: per kernel ks [N][B], Ks [N][NX][B],
// dV [2][B], ok [B]
template <typename T, int NX, int G>
int run(int N, int B, int reg_type, int ld1, int ld3, const T* in, T* out,
        FILE* log) {
  constexpr int F = nmpc::PackedLayout<NX, 1>::F;
  const int sizes[7] = {NX * NX, NX, NX, 1, NX * NX, 1, NX};
  const void* k1[7];
  const void* k2[7];
  const T* p = in;
  for (int f = 0; f < 7; ++f) {
    k1[f] = p;
    p += static_cast<size_t>(N) * sizes[f] * ld1;
  }
  const void* P[1] = {p};
  p += static_cast<size_t>(N) * F * ld3;
  for (int f = 0; f < 7; ++f) {
    k2[f] = p;
    p += static_cast<size_t>(N) * sizes[f] * B;
  }
  const T* VxT = p;
  const T* VxxT = VxT + static_cast<size_t>(NX) * B;
  const T* lam = VxxT + static_cast<size_t>(NX) * NX * B;
  const size_t each = static_cast<size_t>(N) * (NX + 1) * B + 3 * B;
  std::vector<unsigned char> ok(B);
  for (int k = 0; k < 3; ++k) {
    T* o = out + k * each;
    nmpc::g_log = k == 1 ? nullptr : log;
    if (log) std::fprintf(log, "K %d\n", k + 1);
    int err;
    if (k == 0)
      err = nmpc::launch_ddp_backward<T, NX, 1, G>(
          N, B, ld1, reg_type, k1, VxT, VxxT, lam, o, o + N * B,
          o + N * (NX + 1) * B, ok.data(), nullptr);
    else if (k == 1)
      err = nmpc::launch_ddp_backward_chunked<T, NX, 1, G>(
          N, B, reg_type, k2, VxT, VxxT, lam, o, o + N * B,
          o + N * (NX + 1) * B, ok.data(), nullptr);
    else
      err = nmpc::launch_ddp_backward_packed<T, NX, 1, G>(
          N, B, ld3, reg_type, P, VxT, VxxT, lam, o, o + N * B,
          o + N * (NX + 1) * B, ok.data(), nullptr);
    if (err) return 20 + err;
    for (int b = 0; b < B; ++b) o[N * (NX + 1) * B + 2 * B + b] = ok[b];
  }
  return 0;
}

template <typename T>
int main_t(int nx, int G, int N, int B, int reg_type, int ld1, int ld3,
           const char* in_path, const char* out_path, FILE* log) {
  const int F = 2 * nx * nx + 2 * nx + nx + 1 + 1;
  const size_t n_in = static_cast<size_t>(N) * F * (ld1 + B + ld3) +
                      static_cast<size_t>(nx + nx * nx + 1) * B;
  const size_t n_out = 3 * (static_cast<size_t>(N) * (nx + 1) * B + 3 * B);
  std::vector<T> in(n_in), out(n_out);
  FILE* f = std::fopen(in_path, "rb");
  if (!f || std::fread(in.data(), sizeof(T), n_in, f) != n_in) return 4;
  std::fclose(f);
  int err = 2;
#define RUN(NX_, G_)                                                   \
  if (nx == NX_ && G == G_)                                            \
    err = run<T, NX_, G_>(N, B, reg_type, ld1, ld3, in.data(), out.data(), \
                          log);
  RUN(4, 1) RUN(4, 4) RUN(2, 1) RUN(2, 2)
#undef RUN
  if (err) return err;
  f = std::fopen(out_path, "wb");
  if (!f || std::fwrite(out.data(), sizeof(T), n_out, f) != n_out) return 5;
  std::fclose(f);
  return 0;
}

// kernels_host float|double nx G N B reg_type ld1 ld3 in out log
int main(int argc, char** argv) {
  if (argc != 12) return 1;
  const int nx = std::atoi(argv[2]), G = std::atoi(argv[3]),
            N = std::atoi(argv[4]), B = std::atoi(argv[5]),
            reg_type = std::atoi(argv[6]), ld1 = std::atoi(argv[7]),
            ld3 = std::atoi(argv[8]);
  FILE* log = std::fopen(argv[11], "w");
  int err;
  if (std::strcmp(argv[1], "float") == 0)
    err = main_t<float>(nx, G, N, B, reg_type, ld1, ld3, argv[9], argv[10],
                        log);
  else
    err = main_t<double>(nx, G, N, B, reg_type, ld1, ld3, argv[9], argv[10],
                         log);
  std::fclose(log);
  return err;
}
"""

# the kernels' threads per lane on the host: one, and kRowGroup
HOST_GROUPS = {4: (1, 4), 2: (1, 2)}


@pytest.fixture(scope="module")
def kernels_host(tmp_path_factory):
    """The sweep-fed kernels' harness (``_KERNELS_HOST``) built by g++ from
    a copy of csrc/ with the host stand-ins, without contraction."""
    return build_kernels_host(tmp_path_factory.mktemp("kernels_host"),
                              _KERNELS_HOST, "kernels_host")


def _kernels_run(exe, D, VxT, VxxT, lam, reg_type, G, workdir: Path):
    """{kernel: (ks, Ks, dV, ok)} of K1, K2, K3 from the harness at G
    threads per lane, fed as the wrappers feed them (K1's fields by
    ``tma_fields``, K3's buffer by ``padded_packed``), and the log of the
    TMA kernels' first threads."""
    N, nx, B = D.Fx.shape[0], D.Fx.shape[1], lam.shape[0]
    dtype = lam.dtype
    k1, ld1 = K.tma_fields(D)
    P, ld3 = K.padded_packed(K.pack_derivs(D))
    flat = torch.cat([a.flatten() for a in k1] + [P.flatten()]
                     + [a.flatten() for a in D]
                     + [VxT.flatten(), VxxT.flatten(), lam])
    tag = f"{G}_{reg_type}"
    inp, outp, logp = (workdir / f"k{tag}.in", workdir / f"k{tag}.out",
                       workdir / f"k{tag}.log")
    inp.write_bytes(flat.numpy().tobytes())
    proc = subprocess.run(
        [str(exe), "float" if dtype == torch.float32 else "double", str(nx),
         str(G), str(N), str(B), str(reg_type), str(ld1), str(ld3),
         str(inp), str(outp), str(logp)], capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, (proc.returncode, proc.stderr)
    each = N * (nx + 1) * B + 3 * B
    o = torch.from_numpy(np.frombuffer(
        outp.read_bytes(), dtype=np.float32 if dtype == torch.float32
        else np.float64).copy()).reshape(3, each)
    outs = {}
    for k, name in enumerate(("K1", "K2", "K3")):
        ks = o[k, :N * B].reshape(N, 1, B)
        Ks = o[k, N * B:N * (nx + 1) * B].reshape(N, 1, nx, B)
        dV = o[k, N * (nx + 1) * B:N * (nx + 1) * B + 2 * B].reshape(2, B)
        outs[name] = (ks, Ks, dV, o[k, -B:] != 0)
    return outs, logp.read_text().splitlines()


@pytest.fixture(scope="module")
def kernel_runs(kernels_host, tmp_path_factory):
    """The harness's runs, by (model, dtype, reg_type, G): B=37 lanes (a
    lane stride TMA does not take: K1's fields and K3's buffer copied; not
    a multiple of a warp's lanes), N=13 (not a multiple of K1's ring, K2's
    or K3's chunk), with a non-PD and a NaN lane."""
    cache = {}

    def get(model, dtype, reg_type, G):
        key = (model, dtype, reg_type, G)
        if key not in cache:
            D, VxT, VxxT = _stage_case(model, dtype, N=13)
            lam = torch.full((VxT.shape[1],), 1e-4 if reg_type == 1 else 0.5,
                             dtype=dtype)
            cache[key] = (D, VxT, VxxT, lam) + _kernels_run(
                kernels_host, D, VxT, VxxT, lam, reg_type, G,
                tmp_path_factory.mktemp("runs"))
        return cache[key]
    return get


@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", ["cart-pole", "bipedal"])
def test_sweep_kernels_as_host_cpp(kernel_runs, monkeypatch, model, dtype,
                                   reg_type):
    """K1, K2 and K3 on the host through their launch functions, at one
    thread per lane and at kRowGroup: every kernel and G equal to K1 at one
    thread bit for bit (NaN lanes NaN where they are), and that equal to
    ``backward_stacked`` with a correctly rounded sqrt on every lane it
    calls ok, with the same ok mask; no block touches shared memory past
    its launch's size, no box lands off a 128-byte boundary, and every
    barrier wait completes on the buffer's own fill."""
    nx = 4 if model == "cart-pole" else 2
    runs = {G: kernel_runs(model, dtype, reg_type, G)
            for G in HOST_GROUPS[nx]}
    D, VxT, VxxT, lam, ref1, _ = runs[1]
    for G, run in runs.items():
        for name, out in run[4].items():
            for field, a, b in zip(("ks", "Ks", "dV"), ref1["K1"][:3],
                                   out[:3]):
                assert _same(a, b), (G, name, field)
            assert torch.equal(ref1["K1"][3], out[3]), (G, name)
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", _exact_sqrt)
        ref = backward_stacked(DDPConfig(horizon_steps=D.Fx.shape[0],
                                         reg_type=reg_type), D, VxT, VxxT,
                               lam)
    ok = ref[3]
    assert torch.equal(ref1["K1"][3], ok)
    assert not ok[1] and not ok[2] and int(ok.sum()) == lam.shape[0] - 2
    for name, a, b in zip(("ks", "Ks", "dV"), ref[:3], ref1["K1"][:3]):
        assert torch.equal(_bits(a[..., ok]), _bits(b[..., ok])), name


def _events(log):
    """{kernel: {(block, warp): [(kind, values...)]}} from the harness's
    log (each thread's events in its own order)."""
    out, kernel = {}, None
    for line in log:
        kind, *v = line.split()
        if kind == "K":
            kernel = out.setdefault(int(v[0]), {})
            continue
        blk, warp, *rest = map(int, v)
        kernel.setdefault((blk, warp), []).append((kind, *rest))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", ["cart-pole", "bipedal"])
def test_stage_ring_issues_every_stage_once(kernel_runs, geometry, model,
                                            dtype):
    """K1's ring as its blocks ran it on the host: each block's producer
    issues every stage once, from the end of the horizon, as seven boxes of
    the block's lanes (one per field, at the padded offsets of
    ``StageRingLayout``, into one buffer) under one arm of the stage's
    bytes on the buffer's full barrier (stage c in buffer c % R); it waits
    on an empty barrier only from the ring's (R + 1)-th stage on, once a
    stage; each consumer warp waits once a stage.  K3's rings issue each
    chunk of C stages once, from the end."""
    nx = 4 if model == "cart-pole" else 2
    size = 4 if dtype == torch.float32 else 8
    packed = 2 * nx * nx + 3 * nx + 2
    for G in HOST_GROUPS[nx]:
        D, *_, log = kernel_runs(model, dtype, 1, G)
        N, B = D.Fx.shape[0], D.Fx.shape[-1]
        Fx, Fu, Lx, Lu, Lxx, Luu, Lxu, _, R, L = geometry["sweep"][
            size, nx, 1, G, 7, 37][:10]
        W = 32 // G
        offsets = sorted(o * L * size for o in (Fx, Fu, Lx, Lu, Lxx, Luu,
                                                Lxu))
        events = _events(log)
        producer = L * G // 32
        blocks = -(-B // L)
        assert {blk for blk, _ in events[1]} == set(range(blocks))
        for blk in range(blocks):
            ev = events[1][blk, producer]
            arms = [j for j, e in enumerate(ev) if e[0] == "A"]
            assert len(arms) == N
            stages = []
            for c, j in enumerate(arms):
                assert ev[j][1:3] == (8 * (c % R), packed * L * size)
                boxes = ev[j + 1:j + 8]
                assert [e[0] for e in boxes] == ["L"] * 7
                assert {e[1] for e in boxes} == {blk * L}
                (stage,) = {e[2] for e in boxes}
                stages.append(stage)
                base = min(e[3] for e in boxes)
                assert sorted(e[3] - base for e in boxes) == offsets
            assert stages == list(reversed(range(N))), (G, blk)
            waits = [j for j, e in enumerate(ev) if e[0] == "W"]
            assert len(waits) == max(0, N - R)
            assert all(ev[j][1] >= 8 * R for j in waits)
            assert not waits or waits[0] == arms[R] - 1
            warps = -(-min(L, B - blk * L) // W)
            for w in range(warps):
                full = [e for e in events[1][blk, w] if e[0] == "W"]
                assert len(full) == N and all(e[1] < 8 * R for e in full)
        for events3 in events[3].values():
            starts = [e[2] for e in events3 if e[0] == "L"]
            assert len(starts) == sum(e[0] == "A" for e in events3)
            (C,) = {a - b for a, b in zip(starts, starts[1:])}
            assert starts[0] == N - C and len(starts) == -(-N // C)
