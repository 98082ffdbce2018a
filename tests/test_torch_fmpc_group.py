"""The group stage of the FMPC backward kernels, on the CPU.

The streaming backward (K8, ``csrc/fmpc_backward.cuh``), the resident one
(K9, ``csrc/fmpc_backward_resident.cuh``: K8's kernel with the whole
horizon in one buffer) and the packed one (K10,
``csrc/fmpc_backward_packed.cuh``) run each lane's stage on a group of G
threads with ``csrc/fmpc_stage.cuh::fmpc_stage_group`` in one loop
(``fmpc_group_backward``); K8 and K9 form the (s, nu) condensation
themselves (``fmpc_condense_group``) and are fed by a producer warp's TMA
boxes, K10 reads its packed buffer by a TMA ring of chunks per warp.
Held here, with the kernels built by g++ as host code through their
launch functions
(``tests/host_shim.py``: each warp as 32 host threads, TMA by a stand-in
that copies at once), without contraction (the units' ``-fmad=false``):

* on the oscillator (2, 1, 3), the constrained cart-pole (4, 1, 4), a
  two-input (2, 2, 2) problem whose non-PD lanes pivot in the
  Gauss-Jordan fallback and a synthetic (6, 2, 16) one (K10's stage past
  a 256-value box, K8's ring of two buffers), with masked inequality rows
  (their s and nu left at random values), a non-PD and a NaN lane, both
  ``break_if_llt_fails``, fp32 and fp64 (the synthetic shape once, at
  fp64), B=37 (a lane stride TMA does not take: the fields copied to a
  padded one, a ragged last warp) and N=9 (past K8's ring of 8):
  every G bit-equal to G = 1 (K8 and K10, with the group's rows of P A,
  P B and P x_bar exchanged or computed by every thread), K10 bit-equal to
  K8, and G = 1 bit-equal to ``_backward_bm`` run with a correctly
  rounded ``sqrt`` on every finite lane (a zero's sign aside: torch.sum
  starts from +0; the synthetic shape within the kernel tolerance: torch
  adds its 16-term sums in another order), with the same ok and finite
  masks; the folded nu/s and tilde bit-equal to ``condensation()``;
* K9 at every G and 8, 16 or 32 lanes a block (and its lane rule) at N =
  1, 7, 20 and 32, both dtypes and ``break_if_llt_fails``: bit-equal to K8
  at G = 1 where its horizon fits a block, refused where it does not;
* the producer's ring and K10's chunks as the host run issued them: every
  stage once, from the end of the horizon (K9: the whole horizon at once);
* the size rules of ``csrc/fmpc_group.cuh``: K8's ring, K9's horizon and
  K10's chunk rings within a block's 227 KB at every (nx, nu, ng) <= (8,
  4, 16) at both dtypes; ``resident_fits`` equal to the kernel's rule and
  a superset of the shapes it took before.
"""

import functools
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from nmpc_tpu_torch import FmpcConfig, FmpcVariable
from nmpc_tpu_torch.core.problem import Problem
from nmpc_tpu_torch.kernels import fmpc_backward as K8
from nmpc_tpu_torch.models.cartpole import make_cartpole_fmpc_problem
from nmpc_tpu_torch.models.oscillator import make_oscillator_problem
from nmpc_tpu_torch.solvers import fmpc

from host_shim import (KERNELS_PRELUDE, SHIM, bits, build_kernels_host,
                       exact_sqrt, same)

torch.set_num_threads(1)

DT = 0.01
# (nx, nu, ng) -> the group sizes run here (those measured on the card, and
# the default at the synthetic shape)
GROUPS = {(2, 1, 3): (1, 2, 4), (4, 1, 4): (1, 2, 4, 8), (2, 2, 2): (1, 2),
          (6, 2, 16): (4,)}
# the variant run with every thread computing the rows of P A, P B, P x_bar
REDUNDANT_G = {(2, 1, 3): 2, (4, 1, 4): 4, (2, 2, 2): 2}
SYNTHETIC = (6, 2, 16)
B_HOST, N_HOST = 37, 9
# normalized max|a-b| / (1 + max|a|) of a kernel vs its plain version
# (benchmarks/parity_gate.py:61)
TOL = {torch.float32: 2e-4, torch.float64: 1e-10}
# the smem budget of a block (row_group.cuh::kMaxBlockSmem, the H100's)
BLOCK_SMEM = 227 * 1024

_HARNESS = SHIM + KERNELS_PRELUDE + r"""
#include "fmpc_backward_packed.cuh"
#include "fmpc_backward_resident.cuh"

// in: K8's 13 fields at lane stride ld (each [N][size][ld]), K10's P_in
// [N][Fin][ld3] (every array 16-byte aligned, as TMA asks), gms [N][NG],
// eps [B], Lx_bar_term [NX][B], P_T [NX][NX][B], s_T [NX][B]; out: K8's
// ks, Ks, svecs, Ps, ok, finite, K10's out, ok, finite, and the
// condensation nu_s, tilde [N][NG][B] at G = 1; lanes >= 0: K9 at that
// many lanes a block (0: its rule) in K8's place, and nothing else
template <typename T, int NX, int NU, int NG, int G, bool SHARE>
int run(int N, int B, int brk, int ld, int ld3, int lanes, double dt,
        const T* in, T* out, FILE* log) {
  using O = nmpc::FmpcPackedLayout<NX, NU, NG>;
  const int sizes[13] = {NX * NX, NX * NU, NG * NX, NG * NU, NX * NX,
                         NU * NU, NX * NU, NX, NX, NU, NG, NG, NG};
  const void* f[13];
  const T* p = in;
  for (int j = 0; j < 13; ++j) {
    f[j] = p;
    p += static_cast<size_t>(N) * sizes[j] * ld;
  }
  const T* Pin = p;
  p += static_cast<size_t>(N) * O::F * ld3;
  const T* gms = p;
  p += static_cast<size_t>(N) * NG;
  const T* eps = p;
  p += B;
  const T* LxT = p;
  p += static_cast<size_t>(NX) * B;
  const T* PT = p;
  p += static_cast<size_t>(NX) * NX * B;
  const T* sT = p;
  std::vector<unsigned char> ok(B), fin(B);
  T* o = out;
  T* ks = o;
  T* Ks = ks + static_cast<size_t>(N) * NU * B;
  T* sv = Ks + static_cast<size_t>(N) * NU * NX * B;
  T* Ps = sv + static_cast<size_t>(N + 1) * NX * B;
  T* flags8 = Ps + static_cast<size_t>(N + 1) * NX * NX * B;
  T* out10 = flags8 + 2 * B;
  T* flags10 = out10 + static_cast<size_t>(N) * O::Fout * B;
  T* cond = flags10 + 2 * B;
  nmpc::g_log = log;
  if (log) std::fprintf(log, "K %d\n", lanes >= 0 ? 9 : 8);
  int err =
      lanes >= 0
          ? nmpc::launch_fmpc_backward_resident<T, NX, NU, NG, G, SHARE>(
                lanes, N, B, ld, dt, brk, 1, f, gms, NG, eps, LxT, PT, ks,
                Ks, sv, Ps, ok.data(), fin.data(), nullptr)
          : nmpc::launch_fmpc_backward<T, NX, NU, NG, G, SHARE>(
                N, B, ld, dt, brk, 1, f, gms, NG, eps, LxT, PT, ks, Ks, sv,
                Ps, ok.data(), fin.data(), nullptr);
  if (err) return 20 + err;
  for (int b = 0; b < B; ++b) {
    flags8[b] = ok[b];
    flags8[B + b] = fin[b];
  }
  if (lanes >= 0) return 0;
  if (log) std::fprintf(log, "K 10\n");
  err = nmpc::launch_fmpc_backward_packed<T, NX, NU, NG, G, SHARE>(
      N, B, ld3, dt, brk, 1, Pin, sT, PT, out10, ok.data(), fin.data(),
      nullptr);
  if (err) return 40 + err;
  for (int b = 0; b < B; ++b) {
    flags10[b] = ok[b];
    flags10[B + b] = fin[b];
  }
  // the condensation K8's groups form, value by value
  const T* ss = static_cast<const T*>(f[10]);
  const T* nu = static_cast<const T*>(f[11]);
  const T* gbar = static_cast<const T*>(f[12]);
  for (int i = 0; i < N; ++i)
    for (int b = 0; b < B; ++b) {
      for (int g = 0; g < NG; ++g) {
        const size_t at = (static_cast<size_t>(i) * NG + g) * ld + b;
        T nu_s, tilde;
        nmpc::fmpc_condense<T>(ss[at], nu[at], gbar[at],
                               gms[static_cast<size_t>(i) * NG + g] > T(0),
                               eps[b], nu_s, tilde);
        cond[(static_cast<size_t>(i) * NG + g) * B + b] = nu_s;
        cond[(static_cast<size_t>(N + i) * NG + g) * B + b] = tilde;
      }
    }
  return 0;
}

// "geometry" prints, per dtype and (nx, nu, ng) <= (8, 4, 16) at the
// default G of each kernel: K8's G, stage F (padded), chunk C, lanes at B
// = 4096, 1024, 37, the fewest, and the block's bytes at the first and
// the fewest; K10's Fin, box, pieces, C at N = 100 and 13, G, lanes at B =
// 4096 and the block's bytes there and one warp's at N = 13; K9's largest
// N that fits (0: none), its lanes at B = 4096 and N = 20 and at that
// largest N, and the block's bytes there
template <typename T, int G, int GP>
void geometry_line(int nx, int nu, int ng) {
  const nmpc::FmpcOffsets s =
      nmpc::fmpc_offsets(nx, nu, ng, false, nmpc::stage_align<T, G>());
  const nmpc::FmpcOffsets k = nmpc::fmpc_offsets(nx, nu, ng, true, 1);
  const int C8 = nmpc::fmpc_stream_chunk<T>(s.F);
  const int least = (32 / G) > 4 ? 32 / G : 4;
  int L[3];
  const int Bs[3] = {4096, 1024, 37};
  for (int j = 0; j < 3; ++j) L[j] = nmpc::fmpc_stream_lanes<T, G>(s.F, Bs[j]);
  const int C100 = nmpc::fmpc_packed_chunk_stages<T>(k.F, 100);
  const int C13 = nmpc::fmpc_packed_chunk_stages<T>(k.F, 13);
  const int Lp = nmpc::fmpc_packed_lanes<T, GP>(k.F, C100, 4096);
  const int slot = nmpc::fmpc_slot_values(k.F);
  int n9 = 0;
  for (int n = 1; n <= 64; ++n)
    if (nmpc::fmpc_resident_fits<T, G>(s.F, n)) n9 = n;
  const int L20 = nmpc::fmpc_resident_lanes<T, G>(s.F, 20, 4096);
  const int Ln = nmpc::fmpc_resident_lanes<T, G>(s.F, n9 > 0 ? n9 : 1, 4096);
  std::printf("geometry %d %d %d %d %d %d %d %d %d %d %d %zu %zu %d %d %d "
              "%d %d %d %d %zu %zu %d %d %d %zu\n",
              int(sizeof(T)), nx, nu, ng, G, s.F, C8, L[0], L[1], L[2], least,
              nmpc::ring_bytes<T>(nmpc::kFmpcRing, C8, s.F, L[0]),
              nmpc::ring_bytes<T>(nmpc::kFmpcRing, C8, s.F, least), k.F,
              nmpc::fmpc_box_values(k.F), nmpc::fmpc_box_pieces(k.F), C100,
              C13, GP, Lp,
              static_cast<size_t>(Lp / (32 / GP)) *
                  nmpc::ring_bytes<T>(nmpc::kPackedRing, C100, slot, 32 / GP),
              nmpc::ring_bytes<T>(nmpc::kPackedRing, C13, slot, 32 / GP),
              n9, L20, Ln, nmpc::ring_bytes<T>(1, n9, s.F, Ln));
}

template <typename T, int G>
void geometry_packed(int nx, int nu, int ng) {
  switch (nmpc::fmpc_packed_group(nx, nu)) {
    case 1: geometry_line<T, G, 1>(nx, nu, ng); break;
    case 2: geometry_line<T, G, 2>(nx, nu, ng); break;
    case 4: geometry_line<T, G, 4>(nx, nu, ng); break;
    case 8: geometry_line<T, G, 8>(nx, nu, ng); break;
  }
}

template <typename T>
void geometry() {
  for (int nx = 1; nx <= 8; ++nx)
    for (int nu = 1; nu <= 4; ++nu)
      for (int ng = 1; ng <= 16; ++ng) switch (nmpc::fmpc_group(nx, nu)) {
          case 1: geometry_packed<T, 1>(nx, nu, ng); break;
          case 2: geometry_packed<T, 2>(nx, nu, ng); break;
          case 4: geometry_packed<T, 4>(nx, nu, ng); break;
          case 8: geometry_packed<T, 8>(nx, nu, ng); break;
        }
}

template <typename T>
int main_t(int nx, int nu, int ng, int G, int share, int N, int B, int brk,
           int ld, int ld3, int lanes, double dt, const char* in_path,
           const char* out_path, FILE* log) {
  const int F = 2 * nx * nx + 2 * nx * nu + ng * (nx + nu) + nu * nu +
                2 * nx + nu;
  const size_t n_in = static_cast<size_t>(N) * (F + 3 * ng) * ld +
                      static_cast<size_t>(N) * ng + B +
                      static_cast<size_t>(2 * nx + nx * nx) * B +
                      static_cast<size_t>(N) * (F + 2 * ng) * ld3;
  const int Fout = nu + nu * nx + nx + nx * nx;
  const size_t n_out = static_cast<size_t>(N) * (nu + nu * nx) * B +
                       static_cast<size_t>(N + 1) * (nx + nx * nx) * B +
                       2 * B + static_cast<size_t>(N) * Fout * B + 2 * B +
                       2 * static_cast<size_t>(N) * ng * B;
  std::vector<T> in(n_in), out(n_out);
  FILE* f = std::fopen(in_path, "rb");
  if (!f || std::fread(in.data(), sizeof(T), n_in, f) != n_in) return 4;
  std::fclose(f);
  int err = 2;
#define RUN(NX_, NU_, NG_, G_, SH_)                                         \
  if (nx == NX_ && nu == NU_ && ng == NG_ && G == G_ && share == SH_)       \
    err = run<T, NX_, NU_, NG_, G_, SH_>(N, B, brk, ld, ld3, lanes, dt,    \
                                         in.data(), out.data(), log);
  RUN(2, 1, 3, 1, 1) RUN(2, 1, 3, 2, 1) RUN(2, 1, 3, 4, 1)
  RUN(2, 1, 3, 2, 0)
  RUN(4, 1, 4, 1, 1) RUN(4, 1, 4, 2, 1) RUN(4, 1, 4, 4, 1)
  RUN(4, 1, 4, 8, 1) RUN(4, 1, 4, 4, 0)
  RUN(2, 2, 2, 1, 1) RUN(2, 2, 2, 2, 1) RUN(2, 2, 2, 2, 0)
  RUN(6, 2, 16, 4, 1)
#undef RUN
  if (err) return err;
  f = std::fopen(out_path, "wb");
  if (!f || std::fwrite(out.data(), sizeof(T), n_out, f) != n_out) return 5;
  std::fclose(f);
  return 0;
}

// fmpc_group_host geometry
// fmpc_group_host float|double nx nu ng G share N B brk ld ld3 lanes dt in
//   out log
int main(int argc, char** argv) {
  if (argc == 2 && std::strcmp(argv[1], "geometry") == 0) {
    geometry<float>();
    geometry<double>();
    return 0;
  }
  if (argc != 17) return 1;
  int v[11];
  for (int j = 0; j < 11; ++j) v[j] = std::atoi(argv[2 + j]);
  const double dt = std::atof(argv[13]);
  FILE* log = std::fopen(argv[16], "w");
  const int err =
      std::strcmp(argv[1], "float") == 0
          ? main_t<float>(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7],
                          v[8], v[9], v[10], dt, argv[14], argv[15], log)
          : main_t<double>(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7],
                           v[8], v[9], v[10], dt, argv[14], argv[15], log);
  std::fclose(log);
  return err;
}
"""


@pytest.fixture(scope="module")
def fmpc_host(tmp_path_factory):
    """The harness built by g++ from a copy of csrc/ with the host
    stand-ins, without contraction."""
    return build_kernels_host(tmp_path_factory.mktemp("fmpc_group_host"),
                              _HARNESS, "fmpc_group_host")


def _two_input_problem():
    """A linear nx=2, nu=2, ng=2 problem (tests/test_pallas_kernels.py:
    694-717): G is a genuine 2x2 block, so the Gauss-Jordan fallback
    pivots."""
    dt = 0.02
    A = [[1.0, dt], [-0.3 * dt, 1.0 - 0.1 * dt]]
    Bm = [[0.5 * dt, 0.0], [dt, 0.7 * dt]]

    def dynamics(t, x, u):
        mat = lambda m: torch.tensor(m, dtype=x.dtype, device=x.device)
        return mat(A) @ x + mat(Bm) @ u

    return Problem(
        dt=dt, state_dim=2, input_dim=2, ineq_dim=2, dynamics=dynamics,
        running_cost=lambda t, x, u: 0.5 * (torch.sum(x * x)
                                            + 0.1 * torch.sum(u * u)),
        terminal_cost=lambda t, x: 0.5 * torch.sum(x * x),
        ineq_const=lambda t, x, u: torch.stack([u[0] - 1.0, -u[1] - 1.0]))


def _synthetic(nx, nu, ng, N, B, dtype, rng):
    """Coefficients of a random problem at (nx, nu, ng), made from a seed:
    A near the identity, positive definite Lxx, Luu and Lxx_term."""
    as_t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()

    def spd(n, lead):
        m = rng.normal(size=(*lead, n, n, B)) / np.sqrt(n)
        return (np.einsum("...ikb,...jkb->...ijb", m, m)
                + np.eye(n)[..., None])

    A = np.eye(nx)[None, :, :, None] + 0.05 * rng.normal(size=(N, nx, nx, B))
    return fmpc._StCoeffs(
        A=as_t(A), B=as_t(0.1 * rng.normal(size=(N, nx, nu, B))),
        C=as_t(rng.normal(size=(N, ng, nx, B))),
        D=as_t(rng.normal(size=(N, ng, nu, B))),
        Lx=as_t(rng.normal(size=(N, nx, B))),
        Lu=as_t(rng.normal(size=(N, nu, B))),
        Lxx=as_t(spd(nx, (N,))), Luu=as_t(spd(nu, (N,))),
        Lxu=as_t(0.1 * rng.normal(size=(N, nx, nu, B))),
        x_bar=as_t(0.1 * rng.normal(size=(N, nx, B))),
        g_bar=as_t(rng.normal(size=(N, ng, B))),
        Lx_bar=as_t(rng.normal(size=(N, nx, B))),
        Lu_bar=as_t(rng.normal(size=(N, nu, B))),
        Lx_term=as_t(rng.normal(size=(nx, B))),
        Lxx_term=as_t(spd(nx, ())),
        Lx_bar_term=as_t(rng.normal(size=(nx, B))))


@functools.lru_cache(maxsize=None)
def _case(shape, dtype, B=B_HOST, N=N_HOST):
    """(dt, coefficients, s, nu, masks, eps) of a first iteration at
    ``shape``, made from a seed: the oscillator, the constrained cart-pole
    and the two-input problem from a random iterate (s, nu in [0.2, 1.2))
    through ``_coeffs_bm``, the synthetic shape from ``_synthetic``; mask
    rows 0 off on every third stage (their s and nu stay random), lane 1
    non-PD (Luu = -1e4 I; two-input: -400 I on stages 2 and 5 modulo N,
    so G pivots), lane 2 NaN (one NaN A at stage N / 2)."""
    nx, nu, ng = shape
    rng = np.random.default_rng(sum(shape))
    as_t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()
    ss = as_t(0.2 + rng.uniform(size=(N, ng, B)))
    nus = as_t(0.2 + rng.uniform(size=(N, ng, B)))
    if shape == (6, 2, 16):
        dt, co = DT, _synthetic(nx, nu, ng, N, B, dtype, rng)
        gms = torch.ones((N, ng), dtype=dtype)
    else:
        p = {(2, 1, 3): make_oscillator_problem(DT),
             (4, 1, 4): make_cartpole_fmpc_problem(DT),
             (2, 2, 2): _two_input_problem()}[shape]
        var = FmpcVariable(
            xs=as_t(0.3 * rng.normal(size=(N + 1, nx, B))),
            us=as_t(0.3 * rng.normal(size=(N, nu, B))),
            lambdas=as_t(0.3 * rng.normal(size=(N + 1, nx, B))), ss=ss,
            nus=nus)
        t0 = torch.zeros((), dtype=dtype)
        co = fmpc._coeffs_bm(p, FmpcConfig(horizon_steps=N), t0, var)
        gms = fmpc._ineq_masks(p, t0 + p.dt * torch.arange(N, dtype=dtype),
                               dtype).contiguous()
        dt = p.dt
    gms[::3, 0] = 0.0
    if shape == (2, 2, 2):
        for i in {2 % N, 5 % N}:
            co.Luu[i, :, :, 1] = -400.0 * torch.eye(2, dtype=dtype)
    else:
        co.Luu[:, :, :, 1] = -1e4 * torch.eye(nu, dtype=dtype)[None]
    co.A[N // 2, 0, 0, 2] = float("nan")
    eps = torch.full((B,), 1e-4, dtype=dtype)
    return dt, co, ss, nus, gms, eps


def _host_run(exe, shape, dtype, G, share, brk, workdir: Path, N=N_HOST,
              lanes=-1):
    """The harness's K8 (ks, Ks, svecs, Ps, ok, finite), K10 (the same,
    unpacked) and the folded (nu_s, tilde) on ``_case(shape, dtype, B_HOST,
    N)``, fed as the wrappers feed them (K8's fields by ``tma_fields``,
    K10's buffer padded to the lane stride TMA takes), and the log of the
    kernels' TMA issuing threads; with ``lanes`` >= 0, K9 at that many
    lanes a block (0: its rule) as "K9" and nothing else.  None where K9
    does not take the shape (the launch's invalid-value error)."""
    nx, nu, ng = shape
    dt, co, ss, nus, gms, eps = _case(shape, dtype, B_HOST, N)
    N, B = co.A.shape[0], eps.shape[0]
    fields, ld = K8.tma_fields(co, ss, nus)
    nu_s, tilde = K8.condensation(co, ss, nus, gms, eps)
    P_in, ld3 = K8.padded_lanes(K8.pack_fmpc_inputs(co, nu_s, tilde))
    flat = torch.cat([a.flatten() for a in fields]
                     + [P_in.flatten(), gms.flatten(), eps,
                        co.Lx_bar_term.flatten(), co.Lxx_term.flatten(),
                        (-co.Lx_bar_term).flatten()])
    tag = f"{G}_{int(share)}_{int(brk)}_{N}_{lanes}"
    inp, outp, logp = (workdir / f"f{tag}.in", workdir / f"f{tag}.out",
                       workdir / f"f{tag}.log")
    inp.write_bytes(flat.numpy().tobytes())
    proc = subprocess.run(
        [str(exe), "float" if dtype == torch.float32 else "double", str(nx),
         str(nu), str(ng), str(G), str(int(share)), str(N), str(B),
         str(int(brk)), str(ld), str(ld3), str(lanes), repr(float(dt)),
         str(inp), str(outp), str(logp)], capture_output=True, text=True,
        timeout=300)
    if lanes >= 0 and proc.returncode == 21:   # cudaErrorInvalidValue
        return None
    assert proc.returncode == 0, (proc.returncode, proc.stderr)
    o = torch.from_numpy(np.frombuffer(
        outp.read_bytes(), dtype=np.float32 if dtype == torch.float32
        else np.float64).copy())
    sizes = [N * nu * B, N * nu * nx * B, (N + 1) * nx * B,
             (N + 1) * nx * nx * B, 2 * B]
    _, _, _, Fout = K8.field_offsets(nx, nu, ng)
    sizes += [N * Fout * B, 2 * B, 2 * N * ng * B]
    parts = torch.split(o, sizes)
    k8 = (parts[0].reshape(N, nu, B), parts[1].reshape(N, nu, nx, B),
          parts[2].reshape(N + 1, nx, B), parts[3].reshape(N + 1, nx, nx, B),
          parts[4][:B] != 0, parts[4][B:] != 0)
    if lanes >= 0:
        return {"K9": k8, "log": logp.read_text().splitlines()}
    packed = K8.unpack_fields(parts[5].reshape(N, Fout, B),
                              K8._out_shapes(nx, nu))
    k10 = (packed["k"], packed["K"], packed["svec"], packed["P"],
           parts[6][:B] != 0, parts[6][B:] != 0)
    cond = parts[7].reshape(2, N, ng, B)
    return {"K8": k8, "K10": k10, "cond": (cond[0], cond[1]),
            "ref_cond": (nu_s, tilde), "log": logp.read_text().splitlines()}


@pytest.fixture(scope="module")
def runs(fmpc_host, tmp_path_factory):
    """The harness's runs, by (shape, dtype, G, share, brk, N, lanes)."""
    cache = {}

    def get(shape, dtype, G, share, brk, N=N_HOST, lanes=-1):
        key = (shape, dtype, G, share, brk, N, lanes)
        if key not in cache:
            cache[key] = _host_run(fmpc_host, shape, dtype, G, share, brk,
                                   tmp_path_factory.mktemp("runs"), N, lanes)
        return cache[key]
    return get


def _equal_on(ref, out, lanes):
    return all(torch.equal(bits(a[..., lanes]), bits(b[..., lanes]))
               for a, b in zip(ref, out))


# (shape, dtype, break_if_llt_fails): the three problems at both dtypes
# and settings, the synthetic shape (whose point is K10's pieces and K8's
# ring of two) once
CASES = [(shape, dtype, brk) for shape in list(GROUPS)[:3]
         for dtype in (torch.float32, torch.float64) for brk in (False, True)]
CASES.append((SYNTHETIC, torch.float64, False))


@pytest.mark.parametrize("shape,dtype,brk", CASES)
def test_group_kernels_as_host_cpp(runs, monkeypatch, shape, dtype, brk):
    """K8 and K10 on the host through their launch functions at every G
    (and at the default G with every thread computing every row of P A,
    P B and P x_bar): every output of every G bit-equal to G = 1's (NaN
    lanes NaN where they are), K10 bit-equal to K8, the folded scalings
    bit-equal to ``condensation()``, and G = 1 (the smallest G run at the
    synthetic shape, which is held within TOL) bit-equal to
    ``_backward_bm`` with a correctly rounded sqrt on its finite lanes (a
    zero's sign aside), with the same ok and finite masks
    (the NaN lane not finite, the non-PD lane failing only with
    ``break_if_llt_fails``)."""
    variants = [(g, True) for g in GROUPS[shape]]
    if shape != SYNTHETIC:
        variants.append((REDUNDANT_G[shape], False))
    outs = {v: runs(shape, dtype, *v, brk) for v in variants}
    ref = outs[variants[0]]
    for v, out in outs.items():
        for kernel in ("K8", "K10"):
            for j, (a, b) in enumerate(zip(ref[kernel], out[kernel])):
                assert (same(a, b) if a.is_floating_point()
                        else torch.equal(a, b)), (v, kernel, j)
        for a, b in zip(out["ref_cond"], out["cond"]):
            assert torch.equal(bits(a), bits(b)), v
    k8, k10 = ref["K8"], ref["K10"]
    assert torch.equal(k8[4], k10[4]) and torch.equal(k8[5], k10[5])
    N = k8[0].shape[0]
    assert _equal_on(k8[:2] + tuple(a[:N] for a in k8[2:4]), k10[:4], k8[5])
    dt, co, ss, nus, gms, eps = _case(shape, dtype)
    cfg = FmpcConfig(horizon_steps=co.A.shape[0], break_if_llt_fails=brk)
    p = types.SimpleNamespace(dt=dt)   # all _backward_bm reads of it
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", exact_sqrt)
        plain = fmpc._backward_bm(p, cfg, co, ss, nus, gms, eps)
    finite = plain[5]
    assert torch.equal(k8[4], plain[4]) and torch.equal(finite, k8[5])
    # the NaN lane is not finite, the clean ones are (the non-PD lane's
    # steps may overflow where its LLT fails)
    assert not finite[2] and bool(finite[0]) and bool(finite[3:].all())
    assert bool(plain[4][1]) != brk
    for a, b in zip(plain[:4], k8[:4]):
        a, b = a[..., finite], b[..., finite]
        if shape == SYNTHETIC:
            # torch's CPU sum adds the 16 terms of a contraction over ng in
            # another order than the index order the kernels keep
            err = (a - b).abs().max() / (1 + a.abs().max())
            assert err <= TOL[dtype]
            continue
        # torch.sum starts from +0, so where every term of a sum is -0 the
        # plain version's zero is +0 and the kernel's (which starts from
        # the first term) -0: equal as numbers, and in bits everywhere else
        nonzero = a != 0
        assert torch.equal(a, b)
        assert torch.equal(bits(a[nonzero]), bits(b[nonzero]))


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


# K9's horizons held here (one stage; shorter than, equal to and past
# K8's chunks; the TPU kernel's limit) and its lanes a block measured on
# the card
K9_N = (1, 7, 20, 32)
K9_LANES = (8, 16, 32)


@pytest.mark.parametrize("N", K9_N)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", list(GROUPS)[:3])
def test_resident_as_host_cpp(runs, shape, dtype, N):
    """K9 on the host through its launch function at every G of GROUPS and
    every lanes a block of K9_LANES that is a whole number of a warp's
    lanes, and at its lane rule (the largest G), on ``_case`` at N stages
    (a non-PD and a NaN lane, masked rows), both ``break_if_llt_fails``:
    every build whose horizon fits a block bit-equal to K8 at G = 1 (NaN
    lanes NaN where they are; ok and finite masks equal), every other one
    refused by its launch; the rule's build runs, and its producer issued
    the block's whole horizon at once: one arm and 13 boxes of N stages
    from stage 0, at the block's first lane (a warp's lanes a block at
    B_HOST)."""
    G_rule = max(GROUPS[shape])
    builds = [(g, L) for g in GROUPS[shape] for L in K9_LANES
              if L % (32 // g) == 0] + [(G_rule, 0)]
    for brk in (False, True):
        ref = runs(shape, dtype, 1, True, brk, N)["K8"]
        for g, L in builds:
            out = runs(shape, dtype, g, True, brk, N, L)
            fits = L == 0 or K8.resident_block_fits(*shape, N, dtype,
                                                    g, L)
            assert (out is not None) == fits, (g, L)
            if out is None:
                continue
            for j, (a, b) in enumerate(zip(ref, out["K9"])):
                assert (same(a, b) if a.is_floating_point()
                        else torch.equal(a, b)), (g, L, brk, j)
    events = _events(runs(shape, dtype, G_rule, True, False, N, 0)["log"])
    producers = {key: ev for key, ev in events[9].items()
                 if any(e[0] == "A" for e in ev)}
    lanes = max(32 // G_rule, 4)   # the rule's at B_HOST: a warp's lanes
    assert len(producers) == -(-B_HOST // lanes)
    for (blk, _), ev in producers.items():
        loads = [e for e in ev if e[0] == "L"]
        assert sum(e[0] == "A" for e in ev) == 1 and len(loads) == 13
        assert {(e[1], e[2]) for e in loads} == {(blk * lanes, 0)}


def test_resident_fits_every_shape_it_took():
    """``resident_fits`` accepts every (nx <= 8, nu <= 4, ng <= 16, N <= 32,
    dtype) it accepted with one thread a lane (the packed stage of 32 lanes
    within 227 KB: the oscillator up to N = 32 at fp32 and 27 at fp64, the
    cart-pole up to 23 and 11), and more: the cart-pole at every N <= 32."""
    for dtype in (torch.float32, torch.float64):
        itemsize = torch.empty((), dtype=dtype).element_size()
        for nx, nu, ng in np.ndindex(8, 4, 16):
            nx, nu, ng = nx + 1, nu + 1, ng + 1
            _, Fin, _, _ = K8.field_offsets(nx, nu, ng)
            for N in range(1, K8.RESIDENT_MAX_N + 1):
                if N * Fin * 32 * itemsize <= BLOCK_SMEM:
                    assert K8.resident_fits(nx, nu, ng, N, dtype), (
                        nx, nu, ng, N, dtype)
        assert K8.resident_fits(4, 1, 4, 32, dtype)
        assert not K8.resident_fits(4, 1, 4, 33, dtype)


@pytest.mark.parametrize("shape", [(4, 1, 4), (6, 2, 16)])
def test_rings_issue_every_stage_once(runs, shape):
    """The TMA issue of the host run at G = 4, fp64: K8's
    producer (each block's last warp) arms a buffer once a chunk of C
    stages for the chunk's bytes and issues every chunk once, from the end
    of the horizon, as 13 boxes of the block's lanes (one from each of 13
    threads); K10's warps issue each
    chunk once, from the end of the horizon, every box of a chunk at the
    chunk's first stage (two boxes of 256 values a stage past a Fin of
    256), together covering every stage once."""
    nx, nu, ng = shape
    G = 4
    out = runs(shape, torch.float64, G, True, False)
    N, B = N_HOST, B_HOST
    events = _events(out["log"])
    _, Fin, _, _ = K8.field_offsets(nx, nu, ng)
    packed = Fin + ng   # K8's stage: nu_s, tilde replaced by s, nu, g_bar
    producers = {key: ev for key, ev in events[8].items()
                 if any(e[0] == "A" for e in ev)}
    assert producers
    for (blk, _), ev in producers.items():
        arms = [e for e in ev if e[0] == "A"]
        loads = [e for e in ev if e[0] == "L"]
        # every chunk's 13 boxes, from the end of the horizon (the threads
        # of a chunk issue together, after its arm)
        starts = list(dict.fromkeys(e[2] for e in loads))
        C = N - starts[0]
        assert starts == [N - (c + 1) * C for c in range(-(-N // C))]
        assert len(arms) == len(starts)
        (L,) = {e[2] // (C * packed * 8) for e in arms}
        assert {e[1] for e in loads} == {blk * L}
        for start in starts:
            assert len({e[3] for e in loads if e[2] == start}) == 13
    box, pieces = min(Fin, 256), -(-Fin // 256)
    W = 32 // G
    covered = []
    for (blk, warp), ev in events[10].items():
        loads = [e for e in ev if e[0] == "L"]
        if not loads:
            continue
        assert len(loads) == pieces * sum(e[0] == "A" for e in ev)
        starts = [e[2] for e in loads]
        chunk_starts = starts[::pieces]
        assert starts == [s for s in chunk_starts for _ in range(pieces)]
        for c in range(len(chunk_starts)):
            dst = [e[3] for e in loads[c * pieces:(c + 1) * pieces]]
            assert dst == [dst[0] + q * box * W * 8 for q in range(pieces)]
        C = (N - chunk_starts[0]) if len(chunk_starts) == 1 else (
            chunk_starts[0] - chunk_starts[1])
        assert chunk_starts == [N - (c + 1) * C for c in range(-(-N // C))]
        covered.append(sorted(i for s0 in chunk_starts
                              for i in range(max(s0, 0), s0 + C)))
    assert covered and all(c == list(range(N)) for c in covered)


@pytest.fixture(scope="module")
def geometry(fmpc_host):
    """What ``csrc/fmpc_group.cuh``'s rules give at each kernel's default
    G, per (itemsize, nx, nu, ng): (K8's G, F, C, L at B=4096, 1024, 37,
    fewest lanes, ring bytes at 4096 and at the fewest lanes; K10's Fin,
    box, pieces, C at N=100 and 13, G, lanes at 4096, its block's bytes
    there and one warp's at N=13)."""
    out = subprocess.run([str(fmpc_host), "geometry"], check=True,
                         capture_output=True, text=True, timeout=60).stdout
    found = {}
    for line in out.splitlines():
        v = list(map(int, line.split()[1:]))
        found[tuple(v[:4])] = tuple(v[4:])
    return found


@pytest.mark.parametrize("itemsize", [4, 8])
def test_rings_fit_shared_memory(geometry, itemsize):
    """At every (nx <= 8, nu <= 4, ng <= 16) and the default G, K8's ring
    of two buffers of C stages and K10's warp rings of chunks keep
    a block within its 227 KB, at the lanes the launches pick and at the
    fewest a block takes (the kernels' static_asserts); the lanes are a
    whole number of warps, K8's stage is the 13 fields each on a 128-byte
    boundary, and K10's box takes at most 256 values of a stage, its
    pieces covering Fin, with C = 1 past one box."""
    seen = 0
    for (size, nx, nu, ng), v in geometry.items():
        if size != itemsize:
            continue
        seen += 1
        (G, F, C8, L4096, L1024, L37, least, smem, smem_least, Fin, box,
         pieces, C100, C13, Gp, Lp, smem_p, smem_p1, n9, L20, Ln,
         smem9) = v
        W, Wp = 32 // G, 32 // Gp
        assert G == 4 and Gp == (4 if nx >= 4 else 2)
        values = 2 * nx * nx + 2 * nx * nu + ng * (nx + nu) + nu * nu
        values += 2 * nx + nu
        assert Fin == values + 2 * ng and F >= values + 3 * ng
        assert (F * W * size) % 128 == 0
        assert 1 <= C8 <= 8
        assert smem <= BLOCK_SMEM and smem_least <= BLOCK_SMEM, (nx, nu, ng)
        for L in (L4096, L1024, L37):
            assert least <= L <= 32 and L % W == 0
        assert box <= 256 and pieces * box >= Fin > (pieces - 1) * box
        assert (C100, C13) == (1, 1) if Fin > 256 else 1 <= C13 <= C100
        assert smem_p <= BLOCK_SMEM and smem_p1 <= BLOCK_SMEM, (nx, nu, ng)
        assert Wp <= Lp <= 32 and Lp % Wp == 0
        # K9: the kernel's fit rule is resident_fits', its lanes a whole
        # number of warps and its horizon within a block
        dtype = torch.float32 if size == 4 else torch.float64
        assert n9 <= K8.RESIDENT_MAX_N and F == K8.stream_stage_values(
            nx, nu, ng, size)
        assert all(K8.resident_fits(nx, nu, ng, n, dtype) == (n <= n9)
                   for n in range(1, K8.RESIDENT_MAX_N + 2)), (nx, nu, ng)
        for L in (L20, Ln):
            assert least <= L <= 32 and L % W == 0
        assert n9 == 0 or smem9 <= BLOCK_SMEM
    assert seen == 8 * 4 * 16
    cart, osc = geometry[itemsize, 4, 1, 4], geometry[itemsize, 2, 1, 3]
    if itemsize == 4:
        assert cart[:4] == (4, 88, 4, 32) and cart[9] == 78
        assert osc[0] == 4 and osc[3] == 32 and osc[14] == 2
    big = geometry[itemsize, 8, 4, 16]
    assert big[9] == 452 and big[11] == 2
    if itemsize == 8:
        assert big[1:4] == (468, 1, 16) and big[15] == 8
        assert big[18] == 7
    # K9 takes the oscillator and the cart-pole at every N <= 32, 32 lanes
    # a block at the oscillator's N = 20 (fp32), 16 at the cart-pole's N =
    # 32
    assert osc[18] == cart[18] == 32
    if itemsize == 4:
        assert osc[19] == 32 and cart[20] == 16
