"""The forward recursions' ring, on the CPU.

The FMPC Δx/Δu recursion (K11, ``csrc/fmpc_forward.cuh``) and the DDP
line-search rollouts at each lane's alpha and at every alpha (K6, K7,
``csrc/ddp_forward_remat.cuh`` on the cart-pole's generated unit) read
each stage's fields from a ring of chunks of C stages in shared memory
(``csrc/fwd_ring.cuh``), filled by a producer warp's TMA boxes; K11 runs
a lane on a group of G threads, K7 a lane on its A alpha-threads, and K6
and K7 at C = 0 keep the one-stage register prefetch.  Held here, with
the kernels built by g++ as host code
through their launch functions (``tests/host_shim.py``: each warp as 32
host threads, TMA by a stand-in that copies at once), without contraction
(the units' ``-fmad=false``; K6's unit keeps nvcc's default, which the
host build cannot mirror, so its bits are held on the card):

* every (C, G) bit-equal to the one-stage design (K11: C = 1, G = 1; K6:
  its register prefetch) at fp32 and fp64: the oscillator-sized (2, 1),
  the cart-pole (4, 1) and a two-input (2, 2) K11 at B=1023 (a ragged last
  warp; a lane stride TMA does not take: its fields copied to a padded
  one, as the wrappers do) and N=37 (a last chunk shorter than C), B=32 at
  N=1 and C-1 (fewer stages than a chunk), and the cart-pole at B=4096,
  N=100; K6 the same at (4, 1); K7 at every C at the sweep's 11 alphas
  and the head path's 10 (B=1023, N=37) and at 130 (blocks along y), and
  its column of each alpha equal to K6's cost sum at that alpha;
* each within the kernel contract of its plain version
  (``forward_fmpc_deltas_plain``, ``_forward_selected_lanes``): 2e-4
  normalized at fp32, 1e-10 at fp64 (not bits: torch's CPU sums and
  ``sin``/``cos`` may round otherwise; the card holds the bits);
* the wrappers' copies (``ddp_backward_fused.padded_fields``): none where
  TMA takes the fields as they are, one per field it does not (B=1023, a
  field at an offset);
* the size rules of ``fwd_ring.cuh`` at every (nx <= 8, nu <= 4) of both
  kernels at fp32 and fp64: every ring within a block's 227 KB at the
  lanes the launch picks and at the fewest a block takes; K7's blocks of
  lanes and alphas within 384 threads.
"""

import concurrent.futures
import functools
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from nmpc_tpu_torch import DDPConfig
from nmpc_tpu_torch.kernels import fmpc_forward as K11
from nmpc_tpu_torch.kernels.ddp_backward_fused import padded_fields
from nmpc_tpu_torch.kernels import tileval
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.solvers import ddp
from nmpc_tpu_torch.solvers.stages import (_forward_costs_lanes,
                                           _forward_selected_lanes)

from host_shim import (KERNELS_PRELUDE, SHIM, build_kernels_host,
                       first_apart, same)

torch.set_num_threads(1)

DT = 0.01
CHUNKS = (1, 2, 4, 8)
K6_CHUNKS = (0,) + CHUNKS   # K6 at 0: the one-stage register prefetch
# K11's (nx, nu) and the group sizes measured on the card
GROUPS = {(4, 1): (1, 2, 4), (2, 1): (1, 2, 4), (2, 2): (1, 2, 4)}
# normalized max|a-b| / (1 + max|a|) of a kernel vs its plain version
# (benchmarks/parity_gate.py:61)
TOL = {torch.float32: 2e-4, torch.float64: 1e-10}
BLOCK_SMEM = 227 * 1024
# harness processes run at once (each runs a launch's blocks one after
# another, a block's threads together)
RUNS = 3
ALPHAS = DDPConfig().alpha_list
CTYPE = {torch.float32: "float", torch.float64: "double"}


def _dispatch(dtype):
    """The harness's switch over every instantiated configuration."""
    T = CTYPE[dtype]
    lines = []
    for (nx, nu), groups in GROUPS.items():
        for g in groups:
            for c in CHUNKS:
                lines.append(
                    f"  if (nx == {nx} && nu == {nu} && G == {g} && "
                    f"C == {c}) return run_k11<{T}, {nx}, {nu}, {g}, {c}>"
                    f"(N, B, ld, in, out);")
    # the widest shape at the default G and C
    lines.append(f"  if (nx == 8 && nu == 4 && G == 0) return "
                 f"run_k11_default<{T}, 8, 4>(N, B, ld, in, out);")
    k11 = "\n".join(lines)
    k6 = "\n".join(
        f"  if (C == {c}) return run_k6<{T}, {c}>(N, B, ld, dt, n_dt, in, "
        f"out);" for c in K6_CHUNKS)
    k7 = "\n".join(
        f"  if (C == {c}) return nmpc::launch_forward_costs<T, 4, 1, {c}>("
        f"N, B, A, ld, dt, n_dt, xs, us, ks, Ks, t0 + 1, t0, out, nullptr);"
        for c in K6_CHUNKS)
    return k11, k6, k7


def _harness(dtype):
    """The harness for one dtype: the cart-pole's generated forward unit
    (its constants are the dtype's), K6/K7 and K11 at every configuration
    of that dtype, and the size rules."""
    T = CTYPE[dtype]
    unit = tileval.generate(make_cartpole_problem(DT), "forward", 4, 1, dtype)
    k11, k6, k7 = _dispatch(dtype)
    return SHIM + KERNELS_PRELUDE + unit.cpp + r"""
#include "ddp_forward_remat.cuh"
#include "fmpc_forward.cuh"

using T = """ + T + r""";

// in: A [N][NX*NX][ld], Bm [N][NX*NU][ld], xb [N][NX][ld], ks [N][NU][ld],
// Ks [N][NU*NX][ld], dx0 [NX][B]; out: dxs [N+1][NX][B], dus [N][NU][B]
template <typename S, int NX, int NU, int G, int C>
int run_k11(int N, int B, int ld, const S* in, S* out) {
  const int sizes[5] = {NX * NX, NX * NU, NX, NU, NU * NX};
  const void* f[5];
  const S* p = in;
  for (int j = 0; j < 5; ++j) {
    f[j] = p;
    p += static_cast<size_t>(N) * sizes[j] * ld;
  }
  return nmpc::launch_fmpc_forward<S, NX, NU, G, C>(
      N, B, ld, f[0], f[1], f[2], f[3], f[4], p, out,
      out + static_cast<size_t>(N + 1) * NX * B, nullptr);
}
template <typename S, int NX, int NU>
int run_k11_default(int N, int B, int ld, const S* in, S* out) {
  const int sizes[5] = {NX * NX, NX * NU, NX, NU, NU * NX};
  const void* f[5];
  const S* p = in;
  for (int j = 0; j < 5; ++j) {
    f[j] = p;
    p += static_cast<size_t>(N) * sizes[j] * ld;
  }
  return nmpc::launch_fmpc_forward<S, NX, NU>(
      N, B, ld, f[0], f[1], f[2], f[3], f[4], p, out,
      out + static_cast<size_t>(N + 1) * NX * B, nullptr);
}

int k11(int nx, int nu, int G, int C, int N, int B, int ld, const T* in,
        T* out) {
""" + k11 + r"""
  return 2;
}

// in: xs [N+1][4][ld], us, ks [N][1][ld], Ks [N][4][ld], alpha [B], t0;
// out: K6's xs [N+1][4][B], us [N][1][B], costs [N+1][B], sum [B]
template <typename S, int C>
int run_k6(int N, int B, int ld, double dt, double n_dt, const S* in,
           S* out) {
  const S* xs = in;
  const S* us = xs + static_cast<size_t>(N + 1) * 4 * ld;
  const S* ks = us + static_cast<size_t>(N) * ld;
  const S* Ks = ks + static_cast<size_t>(N) * ld;
  const S* alpha = Ks + static_cast<size_t>(N) * 4 * ld;
  const S* t0 = alpha + B;
  S* xo = out;
  S* uo = xo + static_cast<size_t>(N + 1) * 4 * B;
  S* co = uo + static_cast<size_t>(N) * B;
  S* cs = co + static_cast<size_t>(N + 1) * B;
  return nmpc::launch_forward_selected<S, 4, 1, C>(
      N, B, ld, dt, n_dt, xs, us, ks, Ks, alpha, t0, xo, uo, co, cs,
      nullptr);
}

int k6(int C, int N, int B, int ld, double dt, double n_dt, const T* in,
       T* out) {
""" + k6 + r"""
  return 2;
}

// K7 at chunk C (0: each thread's own one-stage prefetch) on K6's inputs
// at lane stride ld, at the alphas [A] after t0; out [A][B]
int k7(int C, int N, int B, int A, int ld, double dt, double n_dt,
       const T* in, T* out) {
  const T* xs = in;
  const T* us = xs + static_cast<size_t>(N + 1) * 4 * ld;
  const T* ks = us + static_cast<size_t>(N) * ld;
  const T* Ks = ks + static_cast<size_t>(N) * ld;
  const T* t0 = Ks + static_cast<size_t>(N) * 4 * ld + B;
""" + k7 + r"""
  return 2;
}

// "costs": K7's ring geometry per B and A: lanes a block, alphas a block,
// the blocks along y, threads a block
void costs_geometry() {
  for (int B : {4096, 1024, 1023, 256, 32})
    for (int A : {1, 10, 11, 31, 32, 130}) {
      const int L = nmpc::fwd_costs_lanes(B);
      const int AB = nmpc::fwd_costs_alphas(L, A);
      std::printf("costs %d %d %d %d %d %d\n", B, A, L, AB,
                  (A + AB - 1) / AB, (L * AB + 31) / 32 * 32 + 32);
    }
}

// "geometry": per kernel (11, 6) and (nx <= 8, nu <= 4) at the default G
// and C: G, C, the ring's buffers, F, the lanes at B = 4096, 1023, 256 and
// 32, the fewest lanes, and the block's bytes at each
template <typename Fs, int G>
void geometry_line(int kernel, int nx, int nu, int C) {
  const int Bs[4] = {4096, 1023, 256, 32};
  std::printf("geometry %d %d %d %d %d %d %d", kernel, nx, nu, G, C,
              nmpc::fwd_ring<T>(Fs::F, C), Fs::F);
  for (int B : Bs) {
    const int L = nmpc::fwd_lanes<T, Fs, G>(C, B);
    std::printf(" %d %zu", L, nmpc::fwd_smem<T, Fs>(C, L));
  }
  const int least = nmpc::fwd_least_lanes<G>();
  std::printf(" %d %zu\n", least, nmpc::fwd_smem<T, Fs>(C, least));
}

template <int NX, int NU>
void geometry_shape() {
  geometry_line<nmpc::FmpcFwdFields<NX, NU>, nmpc::kFmpcFwdGroup<T, NX, NU>>(
      11, NX, NU, nmpc::fmpc_fwd_chunk<T, NX, NU>());
  geometry_line<nmpc::RefFields<NX, NU>, 1>(
      6, NX, NU, nmpc::fwd_chunk<T>(nmpc::RefFields<NX, NU>::F, 8));
}

template <int NX>
void geometry_nx() {
  geometry_shape<NX, 1>();
  geometry_shape<NX, 2>();
  geometry_shape<NX, 3>();
  geometry_shape<NX, 4>();
}

void geometry() {
  geometry_nx<1>();
  geometry_nx<2>();
  geometry_nx<3>();
  geometry_nx<4>();
  geometry_nx<5>();
  geometry_nx<6>();
  geometry_nx<7>();
  geometry_nx<8>();
}

// forward_ring_host geometry
// forward_ring_host k11 nx nu G C N B ld n_in n_out in out
// forward_ring_host k6 C N B ld dt n_dt n_in n_out in out
// forward_ring_host k7 C N B A ld dt n_dt n_in n_out in out
int main(int argc, char** argv) {
  if (argc == 2 && std::strcmp(argv[1], "geometry") == 0) {
    geometry();
    costs_geometry();
    return 0;
  }
  if (argc < 6) return 1;
  const size_t n_in = std::strtoull(argv[argc - 4], nullptr, 10);
  const size_t n_out = std::strtoull(argv[argc - 3], nullptr, 10);
  std::vector<T> in(n_in), out(n_out);
  FILE* f = std::fopen(argv[argc - 2], "rb");
  if (!f || std::fread(in.data(), sizeof(T), n_in, f) != n_in) return 4;
  std::fclose(f);
  auto i = [&](int j) { return std::atoi(argv[j]); };
  auto d = [&](int j) { return std::atof(argv[j]); };
  int err = 1;
  if (std::strcmp(argv[1], "k11") == 0 && argc == 13)
    err = k11(i(2), i(3), i(4), i(5), i(6), i(7), i(8), in.data(),
              out.data());
  else if (std::strcmp(argv[1], "k6") == 0 && argc == 12)
    err = k6(i(2), i(3), i(4), i(5), d(6), d(7), in.data(), out.data());
  else if (std::strcmp(argv[1], "k7") == 0 && argc == 13)
    err = k7(i(2), i(3), i(4), i(5), i(6), d(7), d(8), in.data(),
             out.data());
  if (err) return 20 + err;
  f = std::fopen(argv[argc - 1], "wb");
  if (!f || std::fwrite(out.data(), sizeof(T), n_out, f) != n_out) return 5;
  std::fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """The harness of each dtype built by g++ from a copy of csrc/ with
    the host stand-ins, without contraction."""
    dtypes = (torch.float32, torch.float64)
    dirs = [tmp_path_factory.mktemp(f"forward_ring_{CTYPE[d]}")
            for d in dtypes]
    texts = [_harness(d) for d in dtypes]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        exes = pool.map(lambda a: build_kernels_host(*a, "forward_ring_host"),
                        zip(dirs, texts))
        return dict(zip(dtypes, exes))


def _run(exe, args, inputs, n_out, dtype, workdir: Path):
    """Run the harness on ``inputs`` (flattened, concatenated) and return
    its ``n_out`` outputs."""
    flat = torch.cat([a.reshape(-1) for a in inputs])
    tag = "_".join(map(str, args)).replace(".", "")
    inp, outp = workdir / f"{tag}.in", workdir / f"{tag}.out"
    inp.write_bytes(flat.numpy().tobytes())
    try:
        proc = subprocess.run([str(exe), *map(str, args), str(flat.numel()),
                               str(n_out), str(inp), str(outp)],
                              capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the harness at {args} ran past 300 s")
    assert proc.returncode == 0, (args, proc.returncode, proc.stderr)
    return torch.from_numpy(np.frombuffer(
        outp.read_bytes(), dtype=np.float32 if dtype == torch.float32
        else np.float64).copy())


def _assert_same(what, names, refs, outs):
    """Each output of ``outs`` :func:`same` as its ``refs``; else fail
    naming the configuration, the output and the first index apart."""
    for name, a, b in zip(names, refs, outs):
        at = first_apart(a, b)
        assert at is None, (f"{what}: {name} parts first at flat index "
                            f"{at}: {a.flatten()[at].item()!r} vs "
                            f"{b.flatten()[at].item()!r}")


def norm_err(ref, out):
    d = (ref.double() - out.double()).abs().max().item()
    return d / (1.0 + ref.double().abs().max().item())


def _taken(fields, ring=True):
    """(``fields`` as the wrappers pass them, their lane stride): for the
    TMA ring, copied to a lane stride it takes where B is not a multiple
    of 16 bytes (``padded_fields``); for K6's register prefetch, as they
    are."""
    if ring:
        fields = padded_fields(fields)[0]
    return fields, fields[0].shape[-1]


@functools.lru_cache(maxsize=None)
def _k11_case(shape, dtype, B, N):
    """(A, Bm, xb, ks, Ks, dx0) of a stable recursion at ``shape``, made
    from a seed: A near the identity, K a damping feedback."""
    nx, nu = shape
    rng = np.random.default_rng(nx * 10 + nu + B + N)
    t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()
    A = np.eye(nx)[None, :, :, None] + 0.05 * rng.normal(size=(N, nx, nx, B))
    return (t(A), t(0.1 * rng.normal(size=(N, nx, nu, B))),
            t(0.01 * rng.normal(size=(N, nx, B))),
            t(0.1 * rng.normal(size=(N, nu, B))),
            t(-0.3 * rng.uniform(size=(N, nu, nx, B))),
            t(rng.normal(size=(nx, B))))


def _k11(exe, shape, dtype, B, N, G, C, workdir):
    """The harness's (dxs, dus) at one configuration (G = 0: the default
    G and C at (8, 4)), its fields as the wrapper feeds them."""
    nx, nu = shape
    A, Bm, xb, ks, Ks, dx0 = _k11_case(shape, dtype, B, N)
    fields, ld = _taken((A, Bm, xb, ks, Ks))
    n_out = (N + 1) * nx * B + N * nu * B
    o = _run(exe, ["k11", nx, nu, G, C, N, B, ld],
             list(fields) + [dx0], n_out, dtype, workdir)
    return o[:(N + 1) * nx * B].reshape(N + 1, nx, B), \
        o[(N + 1) * nx * B:].reshape(N, nu, B)


def _check_k11(hosts, tmp_path, shape, dtype, B, N, configs):
    """Every configuration bit-equal to (G = 1, C = 1) and that within TOL
    of the plain version."""
    exe = hosts[dtype]
    ref = _k11(exe, shape, dtype, B, N, 1, 1, tmp_path)
    plain = K11.forward_fmpc_deltas_plain(*_k11_case(shape, dtype, B, N))
    for a, b in zip(plain, ref):
        assert norm_err(a, b) <= TOL[dtype]
    with concurrent.futures.ThreadPoolExecutor(RUNS) as pool:
        outs = pool.map(lambda v: _k11(exe, shape, dtype, B, N, *v,
                                       tmp_path), configs)
        for v, out in zip(configs, outs):
            _assert_same(f"K11 (G, C) = {v} vs (1, 1)", ("dxs", "dus"), ref,
                         out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", list(GROUPS))
def test_k11_every_config_ragged(hosts, tmp_path, shape, dtype):
    """K11 at every (G, C) on B=1023 (its fields copied to a padded lane
    stride, a ragged last warp) and N=37 (a last chunk shorter than C):
    bit-equal to the one-stage design, within TOL of
    ``forward_fmpc_deltas_plain``."""
    _check_k11(hosts, tmp_path, shape, dtype, 1023, 37,
               [(g, c) for g in GROUPS[shape] for c in CHUNKS])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [1, 3, 7])
def test_k11_short_horizons(hosts, tmp_path, N, dtype):
    """K11 at (4, 1), B=32, with fewer stages than a chunk (N = 1, and C -
    1 for C = 4, 8): every (G, C) bit-equal to the one-stage design,
    within TOL of the plain version."""
    _check_k11(hosts, tmp_path, (4, 1), dtype, 32, N,
               [(g, c) for g in GROUPS[4, 1] for c in CHUNKS])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k11_serving_shape(hosts, tmp_path, dtype):
    """K11 at the cart-pole serving shape (4, 1), B=4096, N=100: C = 4 at
    G = 1 and 2, and C = 8 at G = 4, bit-equal to the one-stage design and
    within TOL of the plain version."""
    _check_k11(hosts, tmp_path, (4, 1), dtype, 4096, 100,
               [(1, 4), (2, 4), (4, 8)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k11_widest_shape(hosts, tmp_path, dtype):
    """K11 at (8, 4), its default G and C (at fp64 the ring at its fewest
    stages), B=37 (a lane stride TMA does not take), N=9: within TOL of
    the plain version."""
    dxs, dus = _k11(hosts[dtype], (8, 4), dtype, 37, 9, 0, 0, tmp_path)
    plain = K11.forward_fmpc_deltas_plain(*_k11_case((8, 4), dtype, 37, 9))
    assert norm_err(plain[0], dxs) <= TOL[dtype]
    assert norm_err(plain[1], dus) <= TOL[dtype]


@functools.lru_cache(maxsize=None)
def _k6_case(dtype, B, N):
    """(problem, t0, xs, us, ks, Ks, alpha) of a cart-pole line search near
    the hanging state, made from a seed: xs the rollout of us."""
    p = make_cartpole_problem(DT)
    rng = np.random.default_rng(B + N)
    t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()
    x0 = t((np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
            + 0.05 * rng.normal(size=(B, 4))).T)
    us = t(0.2 * rng.normal(size=(N, 1, B)))
    t0 = torch.tensor(0.3, dtype=dtype)
    xs, _ = ddp._rollout_lanes(p, DDPConfig(horizon_steps=N), t0, x0, us)
    return (p, t0, xs.contiguous(), us, t(0.1 * rng.normal(size=(N, 1, B))),
            t(0.1 * rng.normal(size=(N, 1, 4, B))),
            t(rng.uniform(0.1, 1.0, size=B)))


def _k6(exe, dtype, B, N, C, workdir, alpha=None):
    """The harness's K6 (xs, us, costs, sum) at one chunk of stages (0:
    the register prefetch), its references as the wrapper feeds them."""
    p, t0, xs, us, ks, Ks, a = _k6_case(dtype, B, N)
    refs, ld = _taken((xs, us, ks, Ks), ring=C > 0)
    alpha = a if alpha is None else alpha
    n_out = (N + 1) * 4 * B + N * B + (N + 1) * B + B
    o = _run(exe, ["k6", C, N, B, ld, repr(p.dt),
                   repr(N * p.dt)], list(refs) + [alpha, t0.reshape(1)],
             n_out, dtype, workdir)
    return tuple(part.reshape(shape) for part, shape in zip(
        torch.split(o, [(N + 1) * 4 * B, N * B, (N + 1) * B, B]),
        ((N + 1, 4, B), (N, 1, B), (N + 1, B), (B,))))


def _check_k6(hosts, tmp_path, dtype, B, N, chunks):
    """Every chunk of ``chunks`` bit-equal to the register prefetch (C =
    0), that within TOL of ``_forward_selected_lanes``."""
    exe = hosts[dtype]
    p, t0, xs, us, ks, Ks, alpha = _k6_case(dtype, B, N)
    ref = _k6(exe, dtype, B, N, 0, tmp_path)
    plain = _forward_selected_lanes(p, DDPConfig(horizon_steps=N), t0, xs,
                                    us, ks, Ks, alpha, dtype)
    for a, b in zip(plain, ref):
        assert norm_err(a, b) <= TOL[dtype]
    with concurrent.futures.ThreadPoolExecutor(RUNS) as pool:
        outs = pool.map(lambda c: _k6(exe, dtype, B, N, c, tmp_path), chunks)
        for c, out in zip(chunks, outs):
            _assert_same(f"K6 C = {c} vs C = 0", ("xs", "us", "costs", "sum"),
                         ref, out)
    return ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_every_config_ragged(hosts, tmp_path, dtype):
    """K6 at every C on B=1023, N=37: bit-equal to the one-stage design,
    within TOL of ``_forward_selected_lanes``; K7's column of each alpha
    equal to K6's cost sum at that alpha (its register prefetch and its
    ring at C = 4), bit for bit, and within TOL of
    ``_forward_costs_lanes``."""
    B, N = 1023, 37
    _check_k6(hosts, tmp_path, dtype, B, N, CHUNKS)
    p, t0, xs, us, ks, Ks, _ = _k6_case(dtype, B, N)
    alphas = torch.tensor(ALPHAS, dtype=dtype)
    k7 = _k7(hosts[dtype], dtype, B, N, 0, alphas, tmp_path)
    plain = _forward_costs_lanes(p, DDPConfig(horizon_steps=N), t0, xs, us,
                                 ks, Ks, alphas, dtype)
    assert norm_err(plain, k7) <= TOL[dtype]
    for j in (0, 3, len(ALPHAS) - 1):
        for c in (0, 4):
            sel = _k6(hosts[dtype], dtype, B, N, c, tmp_path,
                      alpha=alphas[j].expand(B).contiguous())
            assert same(k7[j], sel[3]), (j, c)


def _k7(exe, dtype, B, N, C, alphas, workdir):
    """The harness's K7 cost sums [A, B] at one chunk of stages (0: each
    thread's own one-stage prefetch) on ``_k6_case``'s references as the
    wrapper feeds them."""
    p, t0, xs, us, ks, Ks, _ = _k6_case(dtype, B, N)
    refs, ld = _taken((xs, us, ks, Ks), ring=C > 0)
    A = alphas.shape[0]
    return _run(exe, ["k7", C, N, B, A, ld, repr(p.dt), repr(N * p.dt)],
                list(refs) + [torch.zeros(B, dtype=dtype), t0.reshape(1),
                              alphas], A * B, dtype, workdir).reshape(A, B)


@pytest.mark.parametrize("A", [10, 11])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7_every_config_ragged(hosts, tmp_path, dtype, A):
    """K7 at every chunk of its ring on B=1023 (its references copied to a
    padded lane stride, a ragged last block) and N=37 (a last chunk shorter
    than C), at the sweep's 11 alphas and the head path's 10 (all but the
    first): bit-equal to the one-stage build (C = 0), that within TOL of
    ``_forward_costs_lanes``, and the first and last alpha's columns equal
    to K6's cost sums at those alphas, bit for bit."""
    B, N = 1023, 37
    exe = hosts[dtype]
    p, t0, xs, us, ks, Ks, _ = _k6_case(dtype, B, N)
    alphas = torch.tensor(ALPHAS[len(ALPHAS) - A:], dtype=dtype)
    ref = _k7(exe, dtype, B, N, 0, alphas, tmp_path)
    plain = _forward_costs_lanes(p, DDPConfig(horizon_steps=N), t0, xs, us,
                                 ks, Ks, alphas, dtype)
    assert norm_err(plain, ref) <= TOL[dtype]
    with concurrent.futures.ThreadPoolExecutor(RUNS) as pool:
        outs = pool.map(lambda c: _k7(exe, dtype, B, N, c, alphas, tmp_path),
                        CHUNKS)
        for c, out in zip(CHUNKS, outs):
            assert same(ref, out), c
    for j in (0, A - 1):
        sel = _k6(exe, dtype, B, N, 0, tmp_path,
                  alpha=alphas[j].expand(B).contiguous())
        assert same(ref[j], sel[3]), j


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7_alphas_past_a_block(hosts, tmp_path, dtype):
    """K7's ring with more alphas than a block's threads take (130 at 8
    lanes a block: three blocks along y) and fewer stages than a chunk
    (B=32, N=7, C = 8): bit-equal to the one-stage build at every
    alpha."""
    alphas = torch.linspace(1.0, 0.001, 130, dtype=dtype)
    ref = _k7(hosts[dtype], dtype, 32, 7, 0, alphas, tmp_path)
    assert same(ref, _k7(hosts[dtype], dtype, 32, 7, 8, alphas, tmp_path))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [1, 3, 7])
def test_k6_short_horizons(hosts, tmp_path, N, dtype):
    """K6 at B=32 with fewer stages than a chunk: every C bit-equal to the
    one-stage design, within TOL of the plain version."""
    _check_k6(hosts, tmp_path, dtype, 32, N, CHUNKS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_headline_shape(hosts, tmp_path, dtype):
    """K6 at the headline shape B=4096, N=100: C = 4 and 8 bit-equal to the
    one-stage design, within TOL of the plain version."""
    _check_k6(hosts, tmp_path, dtype, 4096, 100, (4, 8))


def test_padded_fields():
    """The wrappers' copies for TMA (``padded_fields``): none where every
    field lies at a 16-byte aligned address with B a multiple of 16 bytes;
    every field, to one padded lane stride, where B is not (1021); only
    the field at an offset, at B, where one is a view at one value's
    offset; each copy's lanes equal to its field's."""
    for dtype in (torch.float32, torch.float64):
        fields = [torch.rand(3, 2, 32, dtype=dtype) for _ in range(5)]
        out, ld, copies = padded_fields(fields)
        assert (ld, copies) == (32, 0)
        assert all(a is b for a, b in zip(fields, out))
        ragged = [torch.rand(3, 2, 1021, dtype=dtype) for _ in range(5)]
        out, ld, copies = padded_fields(ragged)
        assert (ld, copies) == (1024 if dtype == torch.float32 else 1022, 5)
        assert all(torch.equal(a, b[..., :1021])
                   for a, b in zip(ragged, out))
        fields[1] = torch.rand(3 * 2 * 32 + 1, dtype=dtype)[1:].reshape(
            3, 2, 32)
        out, ld, copies = padded_fields(fields)
        assert (ld, copies) == (32, 1)
        assert out[1] is not fields[1] and torch.equal(out[1], fields[1])
        assert all(out[j] is fields[j] for j in (0, 2, 3, 4))


@pytest.fixture(scope="module")
def geometry(hosts):
    """What ``csrc/fwd_ring.cuh``'s rules give, per (itemsize, kernel, nx,
    nu): (G, C, R, F, then lanes and block bytes at B = 4096, 1023, 256,
    32, then the fewest lanes and their bytes)."""
    found, costs = {}, {}
    for dtype, exe in hosts.items():
        size = torch.empty((), dtype=dtype).element_size()
        out = subprocess.run([str(exe), "geometry"], check=True,
                             capture_output=True, text=True,
                             timeout=60).stdout
        for line in out.splitlines():
            kind, *v = line.split()
            v = list(map(int, v))
            if kind == "geometry":
                found[(size, *v[:3])] = tuple(v[3:])
            else:   # K7's: (B, A) -> (lanes, alphas a block, blocks along
                costs[tuple(v[:2])] = tuple(v[2:])   # y, threads a block)
    found["costs"] = costs
    return found


@pytest.mark.parametrize("itemsize", [4, 8])
def test_rings_fit_shared_memory(geometry, itemsize):
    """At every (nx <= 8, nu <= 4) and both kernels, at the default G and
    C: the ring of R >= 2 chunks fits a block's 227 KB at
    the lanes the launch picks and at the fewest a block takes; the lanes
    are a whole number of warps (and of 16 bytes a box row); C is at
    least 1 and the ring holds at most kMaxFwdDepth stages, or two
    chunks."""
    seen = 0
    for key, v in geometry.items():
        if key == "costs" or key[0] != itemsize:
            continue
        size, kernel, nx, nu = key
        seen += 1
        G, C, R, F = v[:4]
        lanes = v[4:12]
        least, smem_least = v[12:]
        assert F == (nx * nx + nx * nu + nx + nu + nu * nx if kernel == 11
                     else nx + 2 * nu + nu * nx)
        assert C >= 1 and R >= 2 and (R * C <= 16 or R == 2)
        assert smem_least <= BLOCK_SMEM, (kernel, nx, nu)
        for L, smem in zip(lanes[::2], lanes[1::2]):
            assert smem <= BLOCK_SMEM, (kernel, nx, nu, L)
            assert least <= L <= 32 and L % (32 // G) == 0
            assert (L * itemsize) % 16 == 0
    assert seen == 2 * 8 * 4
    # the cart-pole's rings: both kernels take 32 lanes a block at B=4096
    for kernel in (6, 11):
        assert geometry[itemsize, kernel, 4, 1][4] == 32


def test_k7_ring_geometry(geometry):
    """K7's ring blocks (``fwd_costs_lanes``, ``fwd_costs_alphas``): 32
    lanes a block at B=4096, 8 at B <= 1024 (the tick's B=256 in 32
    blocks); a block's alphas and the blocks along y cover every alpha,
    within 384 threads with the producer warp, all of them in one block
    at the sweep's 11."""
    costs = geometry["costs"]
    for (B, A), (L, AB, blocks_y, threads) in costs.items():
        assert L == (32 if B >= 4096 else 8), B
        assert 1 <= AB <= A and blocks_y == -(-A // AB)
        assert threads <= 384 and threads % 32 == 0
        assert threads >= L * AB + 32
        assert (blocks_y == 1) == (A <= 352 // L)
    assert costs[256, 11][:3] == (8, 11, 1)
    assert costs[4096, 11][:3] == (32, 11, 1)
