"""The boxed sweep-fed DDP backward K4 at the centroidal model's (nx, nu)
= (9, 16), on the CPU: its wide unit (``csrc/ddp_backward_boxed_wide.cuh``
with the stage and QP of ``csrc/boxqp_wide.cuh``) against K4's
one-group unit at one thread a lane (``csrc/ddp_backward_boxed.cuh``,
``riccati_stage_boxed`` and ``boxqp.cuh::boxqp`` at G = 1) and the plain
``backward_stacked_boxed``; the port's boxed backward against the JAX
package's ``backward_stacked_boxed`` at that shape.

Where ``g++`` is on PATH both launch functions are built as host C++
(``tests/host_shim.py``: each warp as 32 host threads, ``tma.cuh``
replaced by a stand-in that copies a box at once and checks every
barrier, shared memory poisoned and the bytes past a launch's checked,
no contraction, as the units' ``-fmad=false``) at fp32 and fp64, and run
on the boxed stage fields of a centroidal rollout whose horizon crosses
the flight phase (every input masked there), with a non-PD lane, a NaN
lane and a lane whose Armijo searches run past a block of 32 candidates,
at B = 64, on its first 37 lanes and on lane 0 alone, both reg_types: the
wide unit at every G (threads per lane) equals G = 1 bit for bit (NaN
lanes NaN where they are), G = 1 equals ``backward_stacked_boxed`` with a
correctly rounded sqrt on every lane it calls ok, with the same ok mask,
and the wide unit's QP iterations, free sets and Armijo candidates
equal the plain version's.  Also held: the wide block's ring, field offsets, per-lane
scratch and step table (within a block's 227 KB), the wrapper's units and
limits, and the solver's rule on the boxed centroidal model (the code
generator refuses it, so K4 serves it on the card).
"""

import concurrent.futures
import re
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmpc_tpu import DDPConfig as JaxConfig
from nmpc_tpu.kernels.ddp_backward import (
    StackedBounds as JaxBounds, StackedDerivs as JaxDerivs,
    backward_stacked_boxed as jax_backward_stacked_boxed)
from nmpc_tpu_torch import BoxQPConfig, DDPConfig
from nmpc_tpu_torch.convert import ddp_config_from_reference
from nmpc_tpu_torch.kernels import ddp_backward_boxed as K4
from nmpc_tpu_torch.kernels.ddp_backward import (StackedBounds,
                                                 StackedDerivs,
                                                 backward_stacked_boxed)
from nmpc_tpu_torch.kernels.ddp_backward_fused import padded_fields
from nmpc_tpu_torch.kernels.ddp_backward_remat import (MAX_NU_BOXED,
                                                       remat_supported)
from nmpc_tpu_torch.models.centroidal import make_centroidal_problem
from nmpc_tpu_torch.models.vertical import make_vertical_problem
from nmpc_tpu_torch.solvers import ddp

from host_shim import (KERNELS_PRELUDE, SHIM, build_kernels_host,
                       exact_sqrt, first_apart, host_fma_flags)

torch.set_num_threads(1)

NX, NU = 9, 16
DT = 0.03
FORCE = (0.0, 1000.0)
N = 8
BLOCK_SMEM = 227 * 1024
# the most threads of a wide block (csrc/ddp_backward_wide.cuh::
# kWideMaxThreads) and the step table's steps (ddp_backward_boxed_wide.
# cuh::kWideStepTable)
WIDE_THREADS = 256
STEP_TABLE = 512
# G = 1: K4's one-group unit at one thread a lane, the reference; then the
# wide unit's threads per lane (kWideGroup = 32 among them); PROFILE: the
# harness's G for the wide unit's profile build (at kWideGroup)
GROUPS = (1, 4, 8, 16, 32)
WIDE_GROUP = 32
PROFILE = 0
# the batches: a case's lanes, its first 37 (a lane stride TMA does not
# take at fp32, a ragged last warp at G = 1 and block at G >= 8) and lane
# 0 alone (run_mpc's batch); the plain version's lanes (plain_lanes)
BATCHES = (64, 37, 1)
PLAIN_LANES = 64
# the lanes made non-PD, NaN, long-searching and tiny (_centroidal_case)
NON_PD, NAN_LANE, LONG, TINY = 1, 2, 3, 4
DTYPES = {torch.float32: "float", torch.float64: "double"}

_HARNESS = SHIM + KERNELS_PRELUDE + r"""
#include "ddp_backward_boxed.cuh"
#include "ddp_backward_boxed_wide.cuh"

constexpr int NX = 9, NU = 16;
constexpr int SIZES[10] = {NX * NX, NX * NU, NX, NU, NX * NX,
                           NU * NU, NX * NU, NU, NU, NU};

// in: the ten fields at lane stride ld (each [N][size][ld]), VxT, VxxT,
// lam; out: ks [N][NU][B], Ks [N][NU][NX][B], dV [2][B], ok [B], then the
// wide kernel's QP iterations, free sets and Armijo candidates [3][N][B]
// (0 at G = 1, K4's one-group kernel at one thread a lane, fed the fields
// at lane stride B)
template <typename T, int G, bool P = false>
int run(int N, int B, int reg_type, int ld, const nmpc::BoxQPParams& qp,
        const T* in, T* out) {
  const void* fields[10];
  std::vector<T> packed;
  const T* p = in;
  for (int f = 0; f < 10; ++f) {
    fields[f] = p;
    p += static_cast<size_t>(N) * SIZES[f] * ld;
  }
  const T* VxT = p;
  const T* VxxT = VxT + static_cast<size_t>(NX) * B;
  const T* lam = VxxT + static_cast<size_t>(NX) * NX * B;
  T* ks = out;
  T* Ks = ks + static_cast<size_t>(N) * NU * B;
  T* dV = Ks + static_cast<size_t>(N) * NU * NX * B;
  T* rest = dV + 2 * static_cast<size_t>(B);
  std::vector<unsigned char> ok(B);
  const size_t NB = static_cast<size_t>(N) * B;
  std::vector<int> stats((3 + (P ? nmpc::kWidePhases : 0)) * NB, 0);
  int err;
  if constexpr (G == 1) {
    size_t n = 0;
    for (int f = 0; f < 10; ++f) n += static_cast<size_t>(N) * SIZES[f] * B;
    packed.resize(n);
    T* q = packed.data();
    for (int f = 0; f < 10; ++f) {
      const T* src = static_cast<const T*>(fields[f]);
      for (size_t row = 0; row < static_cast<size_t>(N) * SIZES[f]; ++row)
        for (int b = 0; b < B; ++b) q[row * B + b] = src[row * ld + b];
      fields[f] = q;
      q += static_cast<size_t>(N) * SIZES[f] * B;
    }
    err = nmpc::launch_backward_boxed<T, NX, NU, 1>(
        N, B, reg_type, qp, fields, VxT, VxxT, lam, ks, Ks, dV, ok.data(),
        nullptr);
  } else {
    err = nmpc::launch_backward_boxed_wide<T, NX, NU, G, P>(
        N, B, ld, reg_type, qp, fields, VxT, VxxT, lam, ks, Ks, dV,
        ok.data(), stats.data(), nullptr);
  }
  if (err) return 20 + err;
  for (int b = 0; b < B; ++b) rest[b] = ok[b];
  for (size_t e = 0; e < 3 * NB; ++e) rest[B + e] = T(stats[e]);
  if constexpr (P) {   // each phase's cycles over every (stage, lane)
    for (int q = 0; q < nmpc::kWidePhases; ++q) {
      long long sum = 0;
      for (size_t e = 0; e < NB; ++e) sum += stats[(3 + q) * NB + e];
      std::printf("%lld ", sum);
    }
    std::printf("\n");
  }
  return 0;
}

// the wide block's geometry at G: the layout's offsets and F, the ring's
// buffers, the block's lanes and box lanes, the lane stride and size of
// the scratch and its factor buffers' offsets and column stride, a
// block's bytes and threads
template <typename T, int G>
void geometry(int) {
  using L = nmpc::BoxedWideLayout<T, NX, NU, G>;
  using Blk = nmpc::WideBoxedBlock<T, NX, NU, G>;
  using S = nmpc::WideBoxedScratch<NX, NU>;
  std::printf("%d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %zu "
              "%d\n",
              L::Fx, L::Fu, L::Lx, L::Lu, L::Lxx, L::Luu, L::Lxu, L::lower,
              L::upper, L::u, L::F, Blk::ring, Blk::lanes, Blk::box,
              Blk::stride, S::size, S::L0, S::L1, S::FS, Blk::bytes,
              Blk::threads);
}

template <typename T>
int main_t(int G, int N, int B, int reg_type, int ld,
           const nmpc::BoxQPParams& qp, const char* in_path,
           const char* out_path) {
  size_t n_in = static_cast<size_t>(NX + NX * NX + 1) * B;
  for (int f = 0; f < 10; ++f) n_in += static_cast<size_t>(N) * SIZES[f] * ld;
  const size_t n_out = static_cast<size_t>(N) * NU * (NX + 1) * B + 3 * B +
                       3 * static_cast<size_t>(N) * B;
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

// k4_wide G N B reg_type ld max_iter max_ls_iter grad_thre
//   (G = 0: the profile build at kWideGroup, its phases' cycles printed
//   before the geometry)
//   rel_improve_thre step_factor min_step armijo_param in out
int main(int argc, char** argv) {
  if (argc != 15) return 1;
  const int G = std::atoi(argv[1]), N = std::atoi(argv[2]),
            B = std::atoi(argv[3]), reg_type = std::atoi(argv[4]),
            ld = std::atoi(argv[5]);
  const nmpc::BoxQPParams qp{std::atoi(argv[6]), std::atoi(argv[7]),
                             std::strtod(argv[8], nullptr),
                             std::strtod(argv[9], nullptr),
                             std::strtod(argv[10], nullptr),
                             std::strtod(argv[11], nullptr),
                             std::strtod(argv[12], nullptr)};
  return main_t<@T@>(G, N, B, reg_type, ld, qp, argv[13], argv[14]);
}
""".replace("@DISPATCH@", "\n".join(
    ["  if (G == 1) err = run<T, 1>(N, B, reg_type, ld, qp, in.data(), "
     "out.data());"]
    + [f"  if (G == {g}) {{\n    err = run<T, {g}>(N, B, reg_type, ld, qp, "
       f"in.data(), out.data());\n    geometry<T, {g}>(B);\n  }}"
       for g in GROUPS[1:]]
    + ["  if (G == 0) {\n    err = run<T, nmpc::kWideGroup, true>(N, B, "
       "reg_type, ld, qp, in.data(), out.data());\n    geometry<T, "
       "nmpc::kWideGroup>(B);\n  }"]))


@pytest.fixture(scope="module")
def host_builds(tmp_path_factory):
    """{dtype: a future of the harness built by g++}, started at once so
    that the builds run beside the JAX comparison."""
    pool = concurrent.futures.ThreadPoolExecutor(len(DTYPES))
    builds = {dtype: pool.submit(
        build_kernels_host, tmp_path_factory.mktemp(f"k4_wide_{name}"),
        _HARNESS.replace("@T@", name), "k4_wide", extra=host_fma_flags())
        for dtype, name in DTYPES.items()}
    yield builds
    pool.shutdown()


def _centroidal_case(dtype, B=64):
    """First-iteration boxed stage fields of the centroidal model with
    force limits (0, 1000) from t0 = 1.3 (dt = 0.03: the horizon enters
    the flight phase at 1.4 s, where every input is masked), x0 about the
    standing pose and inputs about 60 N, made from a seed: (D, bounds,
    VxT, VxxT).  Lane NON_PD is non-PD (Luu = -10), lane NAN_LANE NaN from
    stage N / 2, lane LONG's Lu moved by 1e6 N(0, 1), so that its Armijo
    searches run long, lane TINY's linear terms (Lx, Lu, the terminal Vx)
    scaled to 1e-40 (fp32: subnormal) or 1e-280 (fp64), so that the wide
    QP's straight-line divisions give quotients it marks (csrc/rn_ops.cuh)
    and computes again natively."""
    rng = np.random.default_rng(11)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()
    p = make_centroidal_problem(DT, force_limits=FORCE)
    x0 = np.concatenate([[0.0, 0.0, 1.0], np.zeros(6)])
    x0s = np.tile(x0, (B, 1)) + 0.02 * rng.normal(size=(B, NX))
    us = 60.0 + 5.0 * rng.normal(size=(N, NU, B))
    cfg = DDPConfig(horizon_steps=N, with_input_constraint=True)
    t0, us = as_t(1.3), as_t(us)
    xs, _ = ddp._rollout_lanes(p, cfg, t0, as_t(x0s.T), us)
    D, VxT, VxxT = ddp._derivative_sweep_lanes(p, cfg, t0, xs, us)
    derivs = StackedDerivs(*(a.contiguous() for a in D[:7]))
    bounds = StackedBounds(*(a.contiguous() for a in D[7:]))
    assert torch.all(derivs.Fu[-3:] == 0) and torch.any(derivs.Fu[0] != 0)
    derivs.Luu[:, :, :, NON_PD] = -10.0
    derivs.Fx[N // 2, 0, 0, NAN_LANE] = float("nan")
    derivs.Lu[:, :, LONG] += as_t(1e6 * rng.normal(size=(N, NU)))
    VxT = VxT.contiguous()
    if B > TINY:
        tiny = 1e-40 if dtype == torch.float32 else 1e-280
        derivs.Lu[:, :, TINY] *= tiny
        derivs.Lx[:, :, TINY] *= tiny
        VxT[:, TINY] *= tiny
    return derivs, bounds, VxT, VxxT.contiguous()


def _config(reg_type):
    return DDPConfig(horizon_steps=N, reg_type=reg_type,
                     with_input_constraint=True)


def _run(exe, cfg, D, bnd, VxT, VxxT, lam, G, workdir):
    """(ks, Ks, dV, ok, qp_iters, free bits, Armijo candidates) from the
    harness at G threads per lane, the fields fed as the wrapper feeds the wide unit
    (``padded_fields``), and the geometry line it printed."""
    B = lam.shape[0]
    fields, ld, _ = padded_fields((*D, *bnd))
    flat = torch.cat([a.flatten() for a in fields]
                     + [VxT.flatten(), VxxT.flatten(), lam])
    tag = f"{G}_{cfg.reg_type}"
    inp, outp = workdir / f"in{tag}", workdir / f"out{tag}"
    inp.write_bytes(flat.numpy().tobytes())
    q = cfg.boxqp
    args = [G, N, B, cfg.reg_type, ld, q.max_iter, q.max_ls_iter] + [
        repr(float(v)) for v in (q.grad_thre, q.rel_improve_thre,
                                 q.step_factor, q.min_step, q.armijo_param)]
    try:
        proc = subprocess.run([str(exe), *map(str, args), str(inp),
                               str(outp)], capture_output=True, text=True,
                              timeout=300)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the harness at G={G} B={B} reg_type={cfg.reg_type} "
                    f"ran past 300 s")
    assert proc.returncode == 0, (G, B, proc.returncode, proc.stderr)
    o = torch.from_numpy(np.frombuffer(
        outp.read_bytes(), dtype=np.float32 if lam.dtype == torch.float32
        else np.float64).copy())
    sizes = [N * NU * B, N * NU * NX * B, 2 * B, B, N * B, N * B, N * B]
    ks, Ks, dV, ok, iters, free, evals = torch.split(o, sizes)
    return ((ks.reshape(N, NU, B), Ks.reshape(N, NU, NX, B),
             dV.reshape(2, B), ok != 0, iters.reshape(N, B).int(),
             free.reshape(N, B).int(), evals.reshape(N, B).int()),
            list(map(int, proc.stdout.split())))


def plain_lanes(cfg, D, bnd, VxT, VxxT, lam):
    """``backward_stacked_boxed`` with a correctly rounded sqrt on the lanes
    padded to a multiple of PLAIN_LANES by repeating the last one, cut
    back (on fewer lanes, or on a ragged tail, torch's CPU reductions over
    the 16-wide axes sum in another order than one lane's left to right):
    (ks, Ks, dV, ok, qp_iters, free bits, Armijo candidates)."""
    B = lam.shape[0]
    take = torch.arange(-(-B // PLAIN_LANES) * PLAIN_LANES).clamp(max=B - 1)
    pad = lambda a: a[..., take].contiguous()
    stats = {}
    saved, torch.sqrt = torch.sqrt, exact_sqrt
    try:
        out = backward_stacked_boxed(
            cfg, StackedDerivs(*map(pad, D)), StackedBounds(*map(pad, bnd)),
            pad(VxT), pad(VxxT), pad(lam), stats=stats)
    finally:
        torch.sqrt = saved
    weights = (2 ** torch.arange(NU, dtype=torch.int64))[None, :, None]
    free = (stats["free"].to(torch.int64) * weights).sum(1).int()
    return tuple(a[..., :B].contiguous()
                 for a in (*out, stats["qp_iters"], free, stats["ls_evals"]))


@pytest.fixture(scope="module")
def k4_wide_runs(host_builds, tmp_path_factory):
    """The harness's runs by (dtype, reg_type): {B: (cfg, D, bounds, VxT,
    VxxT, lam, {G: (outputs, geometry)}, plain_lanes' outputs)} for B in
    BATCHES, each the first B lanes of one centroidal case."""
    cache = {}

    def get(dtype, reg_type):
        if (dtype, reg_type) not in cache:
            exe = host_builds[dtype].result()
            D, bnd, VxT, VxxT = _centroidal_case(dtype, B=BATCHES[0])
            lam = torch.full((BATCHES[0],), 1e-6 if reg_type == 1 else 0.5,
                             dtype=dtype)
            cfg = _config(reg_type)
            runs = {}
            for B in BATCHES:
                cut = lambda a: a[..., :B].contiguous()
                args = (StackedDerivs(*map(cut, D)),
                        StackedBounds(*map(cut, bnd)), cut(VxT), cut(VxxT),
                        cut(lam))
                d = tmp_path_factory.mktemp(f"k4_wide_runs_{B}")
                runs_at = GROUPS + (PROFILE,)
                with concurrent.futures.ThreadPoolExecutor(2) as pool:
                    outs = dict(zip(runs_at, pool.map(
                        lambda G: _run(exe, cfg, *args, G, d), runs_at)))
                runs[B] = (cfg, *args, outs, plain_lanes(cfg, *args))
            cache[dtype, reg_type] = runs
        return cache[dtype, reg_type]
    return get


def _jax_case(B=8):
    """The first B lanes of the fp64 centroidal case, stages N / 2 - 1 to
    N / 2 + 1 (the last of the stance, the NaN stage and the first of the
    flight), as numpy arrays."""
    D, bnd, VxT, VxxT = _centroidal_case(torch.float64, B=B)
    cut = lambda a: a[N // 2 - 1:N // 2 + 2].numpy()
    return ([cut(a) for a in D], [cut(a) for a in bnd], VxT.numpy(),
            VxxT.numpy())


@pytest.mark.parametrize("reg_type,lam", [(1, 1e-6), (2, 0.5)])
def test_k4_wide_module_matches_jax(host_builds, reg_type, lam):
    """The port's boxed backward at (9, 16) (``backward_fused_boxed`` on
    CPU tensors: its plain version) against the JAX package's
    ``backward_stacked_boxed`` (which JAX's own tests hold its K4 to in
    interpret mode) on the same fp64 centroidal inputs, B = 8, N = 3
    across the flight's start, the non-PD, NaN and long-search lanes among
    them: ok masks equal, ks, Ks
    and dV within 1e-10 normalized (max|a-b| / (1 + max|a|)) on the ok
    lanes."""
    D, bnd, VxT, VxxT = _jax_case()
    B, Nj = VxT.shape[-1], D[0].shape[0]
    jc = JaxConfig(horizon_steps=Nj, reg_type=reg_type,
                   with_input_constraint=True)
    lam_np = np.full(B, lam)
    want = jax_backward_stacked_boxed(
        jc, JaxDerivs(*map(jnp.asarray, D)), JaxBounds(*map(jnp.asarray, bnd)),
        jnp.asarray(VxT), jnp.asarray(VxxT), jnp.asarray(lam_np))
    t = lambda a: torch.as_tensor(a).contiguous()
    got = K4.backward_fused_boxed(
        ddp_config_from_reference(jc), StackedDerivs(*map(t, D)),
        StackedBounds(*map(t, bnd)), t(VxT), t(VxxT), t(lam_np))
    ok = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), ok)
    assert not ok[NON_PD] and not ok[NAN_LANE] and ok.sum() == B - 2
    for a, b in zip(want[:3], got[:3]):
        a, b = np.asarray(a)[..., ok], b.numpy()[..., ok]
        assert np.abs(a - b).max() / (1.0 + np.abs(a).max()) <= 1e-10


@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_wide_as_host_cpp(k4_wide_runs, dtype, reg_type):
    """K4 at (9, 16) at one thread a lane (G = 1, the one-group unit's
    ``riccati_stage_boxed``) through its launch function, at B = 64, on
    its first 37 lanes and on lane 0 alone: equal to
    ``backward_stacked_boxed`` with a correctly rounded sqrt
    (``plain_lanes``) bit for bit on every lane it calls ok, the ok masks
    equal (the non-PD and NaN lanes fail, no other), and every flight
    stage's K exactly 0 (every input clamped there).  The case's QPs run
    past one iteration and the long lane's Armijo searches past a block of
    32 candidates."""
    for B, (cfg, D, bnd, VxT, VxxT, lam, runs, ref) in k4_wide_runs(
            dtype, reg_type).items():
        out = runs[1][0]
        ok = ref[3]
        assert torch.equal(out[3], ok), B
        bad = {NON_PD, NAN_LANE} & set(range(B))
        assert not any(ok[list(bad)]) and int(ok.sum()) == B - len(bad), B
        for name, a, b in zip(("ks", "Ks", "dV"), ref[:3], out[:3]):
            at = first_apart(a[..., ok].contiguous(), b[..., ok].contiguous())
            assert at is None, (B, name, at)
        assert torch.all(out[1][-3:][..., ok] == 0), B
        if B > LONG:
            stats = {}
            backward_stacked_boxed(cfg, D, bnd, VxT, VxxT, lam, stats=stats)
            assert int(stats["qp_iters"].max()) > 2, B
            assert int(stats["ls_candidates"][:, LONG].max()) > WIDE_GROUP


@pytest.mark.parametrize("G", GROUPS[1:])
@pytest.mark.parametrize("reg_type", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_wide_groups(k4_wide_runs, dtype, reg_type, G):
    """The wide unit (``csrc/ddp_backward_boxed_wide.cuh``) at G threads a
    lane through ``launch_backward_boxed_wide`` equal to K4 at G = 1 bit
    for bit (NaN lanes NaN where they are) with the same ok mask, and its
    QP iterations, free sets and Armijo candidates equal to
    ``backward_stacked_boxed``'s on every ok lane, at B = 64, 37 and 1, fp32 and fp64, both reg_types."""
    for B, (*_, runs, plain) in k4_wide_runs(dtype, reg_type).items():
        ref, out = runs[1][0], runs[G][0]
        for name, a, b in zip(("ks", "Ks", "dV"), ref[:3], out[:3]):
            at = first_apart(a, b)
            assert at is None, (B, name, at)
        assert torch.equal(ref[3], out[3]), B
        ok = plain[3]
        for name, a, b in zip(("qp_iters", "free", "ls_evals"), plain[4:],
                              out[4:]):
            assert torch.equal(a[:, ok], b[:, ok]), (B, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_wide_ring_fits(k4_wide_runs, dtype):
    """The wide boxed block lays out at (9, 16) at every G: one consumer
    warp (32 / G lanes) and the producer warp; its TMA boxes as many lanes
    as make at least 16 bytes (the block's first), each of a ring
    buffer's ten fields on a 128-byte boundary of the box, with the packed
    order's sizes and the bounds last; two buffers; the lane's scratch
    (WideBoxedScratch, its two factor buffers 16-byte aligned, columns a
    multiple of 4 values apart) after the ring, one lane stride apart, and
    the step table of STEP_TABLE steps after it, within the launch's
    dynamic shared memory (the host shim checks the bytes past it) and
    within a third of 227 KB at kWideGroup (three blocks an SM, where
    B=256 takes two); at kWideGroup one lane and boxes of 4 lanes at fp32
    (F = 800), 2 at fp64 (F = 800)."""
    size = 4 if dtype == torch.float32 else 8
    sizes = (NX * NX, NX * NU, NX, NU, NX * NX, NU * NU, NX * NU, NU, NU, NU)
    buffer = lambda F, L: -(-F * L * size // 128) * 128
    for B, (*_, runs, _) in k4_wide_runs(dtype, 1).items():
        for G in GROUPS[1:]:
            (*off, F, R, lanes, box, stride, scratch, L0, L1, FS, full,
             threads) = runs[G][1]
            assert lanes == 32 // G and box >= lanes, G
            assert box * size >= 16 and (box == lanes or box * size == 16), G
            for o, o_next, n in zip(off, off[1:] + [F], sizes):
                assert (o * box * size) % 128 == 0 and o_next - o >= n, G
            assert stride >= scratch and (stride * size) % 16 == 0, G
            assert L0 % 4 == 0 and L1 % 4 == 0 and FS % 4 == 0, G
            assert FS >= NU and abs(L1 - L0) >= NU * FS, G
            assert scratch >= max(L0, L1) + NU * FS, G
            assert R == 2 and threads == lanes * G + 32, G
            assert full == (128 + R * buffer(F, box) + lanes * stride * size
                            + STEP_TABLE * size), G
            assert full <= BLOCK_SMEM, G
            if G == WIDE_GROUP:
                assert (lanes, box, F) == ((1, 4, 800) if size == 4
                                           else (1, 2, 800))
                assert 3 * full <= BLOCK_SMEM, full


def test_k4_wide_unit_source():
    """The wrapper's units: K4 at a wide shape (4 < nu <= 16 at nx <= 9,
    where the one-group unit cannot serve) from
    ``ddp_backward_boxed_wide.cuh``'s launch, at the header's G or another
    a measurement names, under its own library name; at nu <= 4, at any
    nx, from ``ddp_backward_boxed.cuh``'s, one C interface for both."""
    assert K4.boxed_wide(9, 16) and K4.boxed_wide(2, 5)
    assert K4.boxed_wide(1, 16) and K4.boxed_wide(9, 5)
    assert not K4.boxed_wide(9, 1) and not K4.boxed_wide(9, 4)
    assert not K4.boxed_wide(8, 4) and not K4.boxed_wide(10, 2)
    assert not K4.boxed_wide(10, 16) and not K4.boxed_wide(9, 17)
    for dtype, name in DTYPES.items():
        text = K4.unit_source(9, 16, dtype)
        assert '#include "ddp_backward_boxed_wide.cuh"' in text
        assert f"launch_backward_boxed_wide<{name}, 9, 16>(" in text
        assert "qp_stats, stream" in text
        assert K4.unit_name(9, 16, dtype).startswith(
            "ddp_backward_boxed_wide_9x16_")
        text = K4.unit_source(9, 16, dtype, group=8)
        assert f"launch_backward_boxed_wide<{name}, 9, 16, 8>(" in text
        assert K4.unit_name(9, 16, dtype, group=8).endswith("_g8")
        text = K4.unit_source(2, 2, dtype)
        assert '#include "ddp_backward_boxed.cuh"' in text
        assert f"launch_backward_boxed<{name}, 2, 2>(" in text
        assert "(void)qp_stats;" in text
        assert "_wide" not in K4.unit_name(2, 2, dtype)
        text = K4.unit_source(9, 4, dtype)
        assert f"launch_backward_boxed<{name}, 9, 4>(" in text
        assert "_wide" not in K4.unit_name(9, 4, dtype)


def test_k4_wide_limits_and_auto_rule():
    """K4 takes nu <= 4 at any nx and the wide shapes up to (9, 16), at
    float32/float64; the boxed remat kernel keeps nu <= 4.  The code
    generator refuses the centroidal model, so on a CUDA device ``auto``
    picks K4 for its boxed first-order solve, as an explicit ``"pallas"``
    does; ``"remat"`` there raises; on CPU tensors ``auto`` stays on the
    plain path; the boxed vertical model still takes the remat kernel."""
    for dtype in DTYPES:
        assert K4.boxed_kernel_supports(9, 16, dtype)
        assert K4.boxed_kernel_supports(2, 2, dtype)
        assert K4.boxed_kernel_supports(12, 3, dtype)
        assert K4.boxed_kernel_supports(9, 1, dtype)
        assert not K4.boxed_kernel_supports(9, 17, dtype)
        assert not K4.boxed_kernel_supports(10, 5, dtype)
    assert not K4.boxed_kernel_supports(9, 16, torch.float16)
    assert MAX_NU_BOXED == 4
    boxed = make_centroidal_problem(DT, force_limits=FORCE)
    vertical = make_vertical_problem(0.01)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    resolve = ddp._resolve_backward_impl
    for dtype in DTYPES:
        assert not remat_supported(boxed, NX, NU, dtype, True)
        assert remat_supported(vertical, 2, 2, dtype, True)
        assert resolve(DDPConfig(), boxed, dtype, cuda, True,
                       False) == "pallas"
        assert resolve(DDPConfig(backward_impl="pallas"), boxed, dtype, cuda,
                       True, False) == "pallas"
        assert resolve(DDPConfig(), boxed, dtype, cpu, True,
                       False) == "stacked"
        assert resolve(DDPConfig(), vertical, dtype, cuda, True,
                       False) == "remat"
        with pytest.raises(NotImplementedError, match="nu <= 4"):
            resolve(DDPConfig(backward_impl="remat"), boxed, dtype, cuda,
                    True, False)
    with pytest.raises(ValueError, match="step table holds 512"):
        cfg = DDPConfig(boxqp=BoxQPConfig(max_ls_iter=STEP_TABLE,
                                          step_factor=0.95))
        D, bnd, VxT, VxxT = _centroidal_case(torch.float64, B=4)
        K4.launch(None, cfg, D, bnd, VxT, VxxT,
                  torch.zeros(4, dtype=torch.float64))


def test_k4_wide_profile_build(k4_wide_runs):
    """The wide unit's profile build (``launch_backward_boxed_wide<...,
    kWideGroup, true>``: each stage's phases timed, boxqp_wide.cuh::
    WidePhase) equal to the normal build at kWideGroup bit for bit, with
    the same QP stats and geometry, at B = 64, 37 and 1, fp32 and fp64,
    both reg_types; every phase's cycles counted, the QP's phases and the
    expansion above 0; the wrapper's phase names in the header's order
    and number."""
    enum = (K4.CSRC / "boxqp_wide.cuh").read_text()
    body = enum.split("enum WidePhase : int {", 1)[1].split("};", 1)[0]
    names = re.findall(r"\bkPh(\w+)", body)
    assert len(names) == len(K4.WIDE_PHASES) and "kWidePhases" in body
    assert [n.lower() for n in names[:2]] == ["wait", "expand"]
    for dtype in DTYPES:
        for reg_type in (1, 2):
            for B, (*_, runs, _) in k4_wide_runs(dtype, reg_type).items():
                (out, geo), (prof, pgeo) = runs[WIDE_GROUP], runs[PROFILE]
                for name, a, b in zip(("ks", "Ks", "dV"), out[:3], prof[:3]):
                    assert first_apart(a, b) is None, (B, name)
                for a, b in zip(out[3:], prof[3:]):
                    assert torch.equal(a, b), B
                phases = dict(zip(K4.WIDE_PHASES, pgeo[:len(K4.WIDE_PHASES)]))
                assert pgeo[len(K4.WIDE_PHASES):] == geo, B
                assert all(v >= 0 for v in phases.values()), phases
                assert all(phases[k] > 0 for k in (
                    "expand", "gradient", "cholesky", "solve", "armijo")), (
                    B, phases)


@pytest.mark.parametrize("cfg", [
    BoxQPConfig(),
    BoxQPConfig(max_ls_iter=600),
    BoxQPConfig(max_ls_iter=600, step_factor=0.95),
], ids=["defaults", "max_ls_iter=600", "step_factor=0.95"])
def test_k4_wide_step_table_rule(cfg):
    """The Armijo steps a search can visit (``armijo_steps``: the schedule
    cut at its first step below min_step, where the search stops) decide
    whether the wide unit's step table takes a configuration: with the
    defaults (0.6, 1e-22) 101 steps at both dtypes, whatever max_ls_iter
    past 100, so ``auto`` runs the kernel on the boxed centroidal model;
    with step_factor = 0.95 and max_ls_iter = 600 all 601 steps, past the
    table's 512, so ``auto`` takes the plain path and an explicit
    ``"pallas"`` raises at the launch, naming the table."""
    boxed = make_centroidal_problem(DT, force_limits=FORCE)
    cuda = torch.device("cuda")
    fits = cfg.step_factor == 0.6
    for dtype in DTYPES:
        steps = K4.armijo_steps(cfg, dtype)
        assert steps == (101 if fits else 601), (cfg, dtype)
        assert K4.boxed_kernel_supports(NX, NU, dtype, cfg) == fits
        # the one-group unit's table is sized by the launch
        assert K4.boxed_kernel_supports(4, 2, dtype, cfg)
        resolve = lambda impl: ddp._resolve_backward_impl(
            DDPConfig(backward_impl=impl, boxqp=cfg), boxed, dtype, cuda,
            True, False)
        assert resolve("auto") == ("pallas" if fits else "stacked")
        assert resolve("pallas") == "pallas"
        D, bnd, VxT, VxxT = _centroidal_case(dtype, B=4)
        if not fits:
            with pytest.raises(ValueError, match="holds 512 Armijo steps"):
                K4.launch(None, DDPConfig(boxqp=cfg), D, bnd, VxT, VxxT,
                          torch.zeros(4, dtype=dtype))
    # no step below min_step: the whole schedule (a fixed point included);
    # else up to the first step below it
    assert K4.armijo_steps(BoxQPConfig(max_ls_iter=5), torch.float32) == 6
    assert K4.armijo_steps(BoxQPConfig(min_step=0.5, max_ls_iter=5),
                           torch.float64) == 3
    assert K4.armijo_steps(BoxQPConfig(step_factor=1.0, max_ls_iter=700),
                           torch.float64) == 701


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_wide_long_schedule_as_host_cpp(host_builds, k4_wide_runs,
                                           tmp_path, dtype):
    """The wide unit at max_ls_iter = 600 with the default step factor
    and min_step (its launch cuts the schedule to armijo_steps, 101, which
    the table holds) through its launch function at kWideGroup, on the
    case's first 37 lanes (the long-search lane among them): equal to
    ``backward_stacked_boxed`` at max_ls_iter = 600 bit for bit on its ok
    lanes with the same ok mask and QP stats, and to the default
    configuration's run bit for bit."""
    runs = k4_wide_runs(dtype, 1)
    B = 37
    cfg0, D, bnd, VxT, VxxT, lam, outs, _ = runs[B]
    cfg = DDPConfig(horizon_steps=N, reg_type=1, with_input_constraint=True,
                    boxqp=BoxQPConfig(max_ls_iter=600))
    out, _ = _run(host_builds[dtype].result(), cfg, D, bnd, VxT, VxxT, lam,
                  WIDE_GROUP, tmp_path)
    ref = plain_lanes(cfg, D, bnd, VxT, VxxT, lam)
    ok = ref[3]
    assert torch.equal(out[3], ok) and int(ok.sum()) == B - 2
    for name, a, b in zip(("ks", "Ks", "dV"), ref[:3], out[:3]):
        at = first_apart(a[..., ok].contiguous(), b[..., ok].contiguous())
        assert at is None, (name, at)
    for name, a, b in zip(("qp_iters", "free", "ls_evals"), ref[4:], out[4:]):
        assert torch.equal(a[:, ok], b[:, ok]), name
    assert int(ref[6][:, LONG].max()) > WIDE_GROUP
    for a, b in zip(outs[WIDE_GROUP][0], out):
        assert (first_apart(a, b) is None if a.is_floating_point()
                else torch.equal(a, b))


_RN_HARNESS = SHIM + r"""
#include <cuda_runtime.h>
#include "rn_ops.cuh"
using T = @T@;
// rn_ops in out: in holds n pairs (a, b) then n values x; out gets a / b
// by RnOps<T>, its mark, sqrt_pos(x), its mark
int main(int argc, char** argv) {
  if (argc != 3) return 1;
  FILE* f = std::fopen(argv[1], "rb");
  std::vector<T> in;
  T v;
  while (f && std::fread(&v, sizeof v, 1, f) == 1) in.push_back(v);
  if (!f || in.size() % 3 != 0) return 2;
  std::fclose(f);
  const size_t n = in.size() / 3;
  std::vector<T> out(4 * n);
  for (size_t i = 0; i < n; ++i) {
    bool tiny = false, stiny = false;
    const T b = in[2 * i + 1];
    out[i] = nmpc::RnOps<T>::div(in[2 * i], nmpc::RnOps<T>::rcp(b), tiny);
    out[n + i] = tiny ? T(1) : T(0);
    out[2 * n + i] = nmpc::RnOps<T>::sqrt_pos(in[2 * n + i], stiny);
    out[3 * n + i] = stiny ? T(1) : T(0);
  }
  f = std::fopen(argv[2], "wb");
  if (!f || std::fwrite(out.data(), sizeof(T), out.size(), f) != out.size())
    return 3;
  std::fclose(f);
  return 0;
}
"""


def _rn_cases(dtype, n=1 << 20):
    """(a, b, x) arrays of ``dtype``: random finite bit patterns (every
    exponent; b > 0), and at float32 quotients at and beside midpoints of
    the subnormal grid and of normal binades (a = b m for a midpoint m,
    where exact); zero, infinite and NaN numerators, b = +inf, powers of
    two, and the positive extremes for the root."""
    rng = np.random.default_rng(16)
    top, ity = ((0x7f800000, np.uint32) if dtype == np.float32
                else (0x7ff0000000000000, np.uint64))
    bits = lambda k: rng.integers(0, top, k, dtype=np.int64).astype(
        ity).view(dtype)
    a = bits(n) * np.where(rng.random(n) < 0.5, -1, 1).astype(dtype)
    b = bits(n)
    tie_a, tie_b = [], []
    if dtype == np.float32:
        # b = 2^e odd, a = b m: m a midpoint (2j + 1) 2^-150 (subnormal
        # grid) or (2j + 1) 2^-24 2^e2 (a normal binade's), where a is
        # exact, and the floats beside a
        k = n // 4
        odd = (2 * rng.integers(1, 1 << 6, k) + 1).astype(np.float64)
        bd = odd * 2.0 ** rng.integers(-20, 20, k)
        m_sub = (2 * rng.integers(0, 1 << 10, k) + 1) * 2.0 ** -150
        m_nrm = ((2 * rng.integers(1 << 23, 1 << 24, k) + 1) * 2.0 ** -25
                 * 2.0 ** rng.integers(-100, 100, k))
        for m in (m_sub, m_nrm):
            prod = bd * m
            exact = prod.astype(np.float32).astype(np.float64) == prod
            near = prod[exact].astype(np.float32)
            tie_a += [near, np.nextafter(near, np.float32(np.inf)),
                      np.nextafter(near, np.float32(0))]
            tie_b += [bd[exact].astype(np.float32)] * 3
    special_a = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                          1e-45, -1e-45, 3.4e38], dtype)
    special_b = np.array([1.0, 3.0, 7.0, 0.1, np.inf, 1e-45, 2.0 ** -126,
                          3.4e38, np.inf, 1e-30], dtype)
    pairs_a = np.concatenate([a, *tie_a, special_a,
                              np.repeat(special_a, len(special_b))])
    pairs_b = np.concatenate([b, *tie_b, special_b,
                              np.tile(special_b, len(special_a))])
    x = np.concatenate([bits(len(pairs_a) - 6),
                        np.array([np.inf, 1e-45, 2.0 ** -126, 3.4e38, 1.0,
                                  2.0], dtype)])
    return (pairs_a.astype(dtype), pairs_b.astype(dtype), x.astype(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rn_ops_as_host_cpp(tmp_path, dtype):
    """``csrc/rn_ops.cuh``'s division and square root (RnOps<T>: fp32
    straight-line through fp64, from seeds cut to 20 bits as the host
    build's stand-ins give them; fp64 the native operations) against IEEE
    (numpy) on about 1.3 M quotients: random bit patterns over every
    exponent, at float32 quotients that are midpoints of the subnormal
    grid or of a normal binade and their neighbours, zeros, infinities,
    NaN and b = +inf: every result not marked equal bit for bit (NaN where
    NaN); every marked float32 quotient under 2^-125 (a nonzero numerator)
    or NaN, or b = +inf (the caller computes marked work natively); the root of
    every positive value tried equal bit for bit where not marked (fp32:
    marked only at +inf; fp64: never)."""
    name = "float" if dtype == np.float32 else "double"
    exe = build_kernels_host(tmp_path, _RN_HARNESS.replace("@T@", name),
                             "rn_ops", extra=host_fma_flags())
    a, b, x = _rn_cases(dtype)
    n = len(a)
    inp, outp = tmp_path / "in", tmp_path / "out"
    inp.write_bytes(np.stack([a, b], 1).tobytes() + x.tobytes())
    proc = subprocess.run([str(exe), str(inp), str(outp)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = np.frombuffer(outp.read_bytes(), dtype)
    q, tiny, s, stiny = (out[:n], out[n:2 * n] != 0, out[2 * n:3 * n],
                         out[3 * n:] != 0)
    with np.errstate(all="ignore"):
        want_q, want_s = a / b, np.sqrt(x)
    ity = np.uint32 if dtype == np.float32 else np.uint64
    same = lambda u, v: (u.view(ity) == v.view(ity)) | (
        np.isnan(u) & np.isnan(v))
    assert same(q, want_q)[~tiny].all()
    assert same(s, want_s)[~stiny].all()
    if dtype == np.float32:
        # marked: a quotient under 2^-125 (a nonzero a) or NaN (b = +inf
        # or NaN, or a NaN a)
        with np.errstate(all="ignore"):
            why = ((a != 0) & (np.abs(want_q) < 2.0 ** -125)) | np.isnan(
                want_q) | np.isinf(b) | np.isnan(a)
        assert why[tiny].all()
        assert tiny.sum() > 100 and (~same(q, want_q)).any()  # marks matter
        assert (stiny == np.isinf(x)).all()
    else:   # the native operations: nothing marked
        assert not tiny.any() and not stiny.any()
