"""The FMPC backward and forward kernels at the wide shapes (K8, K9, K10,
K11 past (nx, nu, ng) = (8, 4, 16), up to (16, 16, 64)), on the CPU.

The problems: Wang and Boyd's oscillating masses ("Fast Model Predictive
Control Using Online Optimization", IEEE TCST 18(2), 2010, section V): six
unit masses on a line joined to each other and to the walls by unit
springs, three actuators each pushing a pair of neighbours apart, exact
zero-order hold at dt = 0.5 (``scipy.linalg.expm``, the same float64
arrays handed to both packages), running cost (|x|^2 + |u|^2) / 2,
terminal cost |x|^2 / 2, |x| <= 4 and |u| <= 0.5: (nx, nu, ng) = (12, 3,
30); eight masses with a force on each, (16, 8, 48); and seeded random
stage fields at the ceiling (16, 16, 64).

Where ``g++`` is on PATH the wide units' launch functions (``csrc/
fmpc_backward_wide.cuh``: K8 and K9, ``csrc/fmpc_backward_packed_wide.cuh``:
K10, ``csrc/fmpc_forward.cuh``: K11) are built as host C++ in one harness
per dtype (``tests/host_shim.py``: each warp as 32 host threads, TMA by a
stand-in that copies at once, every barrier checked, shared memory
poisoned, no contraction, as the units' ``-fmad=false``) and run at the
three shapes, fp32 and fp64, both ``break_if_llt_fails``, B = 37 (a lane
stride TMA does not take at fp32: the fields copied to a padded one), N
past one of K10's chunks and ending on a short one, with masked rows, a
non-PD lane, a NaN lane and a lane whose G pivots in the Gauss-Jordan
fallback:

* every group size a block takes bit-equal to the smallest (G = 1 where
  its block fits, 2, 4 or 16 where it does not), K8 at the most lanes a
  block takes at each G (B = 37: a last block part-filled), NaN lanes NaN
  where they are, the ok and finite masks equal; K10 bit-equal to K8, K9
  to K8 where its horizon fits (refused where it does not); the profile
  build of K8 and K9 (clock64() cycles a part of the stage) bit-equal to
  the normal build; K11 at G = 1 (where its ring fits), 2 and 4
  bit-equal;
* the smallest G within the kernel tolerance of ``_backward_bm`` run with
  a correctly rounded sqrt, with equal masks (K11: of
  ``forward_fmpc_deltas_plain``);
* the folded nu/s and tilde bit-equal to ``condensation()``;
* K8's boxes a stage from the end of the horizon, one arm a stage, the
  stage's boxes issued over the producer warp's threads; K9's horizon
  one arm a stage, issued at once over the warp; K10's each 256 rows of
  the block's lanes, landing 128-byte aligned, one a chunk's worth per
  chunk;
* every size rule's Python twin (``fmpc_backward.wide_rule``) equal to the
  header's (``FmpcWideRule``) at every wide shape up to the ceiling, both
  dtypes, each block within 227 KB, and K11's ring within it.

Then the port against JAX on the CPU: ``_backward_bm`` and the K8, K9 and
K10 entries (their plain versions, no launch) against JAX's
``_backward_bm``, and ``_forward_bm`` against JAX's, at (12, 3, 30) and
(16, 8, 48) within 3e-5 (fp32) and 1e-12 (fp64); the masses' fp64
``solve_batch`` (B = 8, N = 30) against JAX's; and the wrappers' limits
and the solver's rule at and past the ceiling.
"""

import concurrent.futures
import dataclasses
import functools
import subprocess
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from nmpc_tpu.core.problem import Problem as JaxProblem
from nmpc_tpu.core.types import FmpcConfig as JaxFmpcConfig
from nmpc_tpu.core.types import FmpcVariable as JaxVariable
from nmpc_tpu.core.types import fmpc_variable_reset as jax_reset
from nmpc_tpu.solvers import fmpc as JF
from nmpc_tpu.solvers.fmpc import FmpcSolver as JaxFmpcSolver
from nmpc_tpu_torch import FmpcConfig, FmpcSolver
from nmpc_tpu_torch.convert import (fmpc_config_from_reference,
                                    fmpc_result_to_numpy,
                                    fmpc_variable_from_numpy)
from nmpc_tpu_torch.core.problem import Problem
from nmpc_tpu_torch.kernels import fmpc_backward as K8
from nmpc_tpu_torch.kernels import fmpc_forward as K11
from nmpc_tpu_torch.solvers import fmpc
from nmpc_tpu_torch.solvers.fmpc import _resolve_impls

from host_shim import (KERNELS_PRELUDE, SHIM, bits, build_kernels_host,
                       exact_sqrt, same)

torch.set_num_threads(1)

SHAPES = ((12, 3, 30), (16, 8, 48), (16, 16, 64))
MASSES = SHAPES[0]
GROUPS = (1, 2, 4, 8, 16, 32)
FWD_GROUPS = (1, 2, 4)
DTYPES = {torch.float32: "float", torch.float64: "double"}
B_HOST = 37
MASSES_DT = 0.5
# a kernel vs its plain version, normalized max|a-b| / (1 + max|a|)
# (benchmarks/parity_gate.py:61); the port's plain versions vs JAX
# (tests/test_pallas_kernels.py:583)
TOL = {torch.float32: 2e-4, torch.float64: 1e-10}
JAX_TOL = {torch.float32: 3e-5, torch.float64: 1e-12}
BLOCK_SMEM = 227 * 1024


def masses_matrices(n_masses, pairs):
    """(A, B) of ``n_masses`` unit masses joined by unit springs (K =
    tridiag(-1, 2, -1)), actuator j pushing mass pairs[j][0] by +1 and
    pairs[j][1] (if any) by -1, discretized with an exact zero-order hold
    at MASSES_DT; float64 numpy arrays."""
    n, m = n_masses, len(pairs)
    K = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    Ac = np.block([[np.zeros((n, n)), np.eye(n)], [-K, np.zeros((n, n))]])
    Bc = np.zeros((2 * n, m))
    for j, pair in enumerate(pairs):
        Bc[n + pair[0], j] = 1.0
        if len(pair) > 1:
            Bc[n + pair[1], j] = -1.0
    M = np.zeros((2 * n + m, 2 * n + m))
    M[:2 * n, :2 * n], M[:2 * n, 2 * n:] = Ac, Bc
    E = scipy.linalg.expm(M * MASSES_DT)
    return E[:2 * n, :2 * n], E[:2 * n, 2 * n:]


MATRICES = {(12, 3, 30): masses_matrices(6, [(0, 1), (2, 3), (4, 5)]),
            (16, 8, 48): masses_matrices(8, [(j,) for j in range(8)])}


def masses_problems(shape):
    """(JAX problem, port problem) of a masses shape: x+ = A x + B u,
    running cost (|x|^2 + |u|^2) / 2, terminal |x|^2 / 2, g = [x - 4;
    -x - 4; u - 0.5; -u - 0.5] <= 0."""
    A, Bm = MATRICES[shape]
    nx, nu, ng = shape

    def make(lib, cat, mat):
        return dict(
            dt=MASSES_DT, state_dim=nx, input_dim=nu, ineq_dim=ng,
            dynamics=lambda t, x, u: mat(A, x) @ x + mat(Bm, x) @ u,
            running_cost=lambda t, x, u: 0.5 * (lib.sum(x * x)
                                                + lib.sum(u * u)),
            terminal_cost=lambda t, x: 0.5 * lib.sum(x * x),
            ineq_const=lambda t, x, u: cat([x - 4.0, -x - 4.0, u - 0.5,
                                            -u - 0.5]))

    jax_p = JaxProblem(**make(jnp, jnp.concatenate,
                              lambda a, x: jnp.asarray(a, x.dtype)))
    port_p = Problem(**make(torch, torch.cat,
                            lambda a, x: torch.as_tensor(a, dtype=x.dtype,
                                                         device=x.device)))
    return jax_p, port_p


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
        C=as_t(rng.normal(size=(N, ng, nx, B)) / np.sqrt(ng)),
        D=as_t(rng.normal(size=(N, ng, nu, B)) / np.sqrt(ng)),
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


def _random_iterate(shape, N, B, rng, dtype):
    """A random batch-minor iterate at ``shape`` (s, nu in [0.2, 1.2))."""
    nx, nu, ng = shape
    as_t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()
    return dict(xs=as_t(0.3 * rng.normal(size=(N + 1, nx, B))),
                us=as_t(0.3 * rng.normal(size=(N, nu, B))),
                lambdas=as_t(0.3 * rng.normal(size=(N + 1, nx, B))),
                ss=as_t(0.2 + rng.uniform(size=(N, ng, B))),
                nus=as_t(0.2 + rng.uniform(size=(N, ng, B))))


@functools.lru_cache(maxsize=None)
def _case(shape, dtype, N, B=B_HOST):
    """(dt, coefficients, s, nu, masks, eps) of a first iteration at
    ``shape``, made from a seed: the masses shapes from a random iterate
    through ``_coeffs_bm``, the ceiling from ``_synthetic``; mask row 0
    off on every third stage (its s and nu left random), lane 1 non-PD
    (Luu = -1e4 I), lane 2 NaN (one NaN A at stage N / 2), lane 3's Luu a
    large indefinite matrix on stages 1 and N - 2, so that its G pivots
    in the Gauss-Jordan fallback."""
    nx, nu, ng = shape
    rng = np.random.default_rng(sum(shape) + N)
    it = _random_iterate(shape, N, B, rng, dtype)
    if shape in MATRICES:
        _, p = masses_problems(shape)
        t0 = torch.zeros((), dtype=dtype)
        co = fmpc._coeffs_bm(p, FmpcConfig(horizon_steps=N), t0,
                             fmpc.FmpcVariable(**it))
        dt = p.dt
    else:
        co = _synthetic(nx, nu, ng, N, B, dtype, rng)
        dt = 0.01
    gms = torch.ones((N, ng), dtype=dtype)
    gms[::3, 0] = 0.0
    co.Luu[:, :, :, 1] = -1e4 * torch.eye(nu, dtype=dtype)[None]
    co.A[N // 2, 0, 0, 2] = float("nan")
    m = rng.normal(size=(nu, nu))
    for i in {1, N - 2}:
        co.Luu[i, :, :, 3] = torch.as_tensor(200.0 * (m + m.T), dtype=dtype)
    eps = torch.full((B,), 1e-4, dtype=dtype)
    return dt, co, it["ss"], it["nus"], gms, eps


def _rule(shape, dtype, G=None):
    """The wide rules at ``G`` threads a lane (None: K8's and K9's)."""
    return K8.wide_rule(*shape, dtype, G)


def _horizon(shape, dtype):
    """N of a shape's host runs: past one of K10's chunks (at the
    kernel's own group) and ending on a short one where a chunk holds more
    than one stage, at least 3."""
    C = _rule(shape, dtype, K8.WIDE_GROUP).packed_chunk
    return max(3, C + 2 if C > 1 else 3)


def _fwd_fits(nx, nu, dtype, G):
    """Whether K11's ring of its chunk at ``G`` threads a lane fits a
    block of the fewest lanes (``fwd_ring.cuh::fwd_smem``, the launch's
    static_assert), with the chunk and ring of ``fmpc_fwd_chunk``."""
    item = torch.empty((), dtype=dtype).element_size()
    sizes = (nx * nx, nx * nu, nx, nu, nu * nx)
    F = sum(sizes)
    depth = max(1, min(16, 96 * 1024 // (F * 32 * item)))
    most = 8 if nx < 4 else (2 if item == 8 else 4)
    C = 1 if depth // 2 < 1 else min(depth // 2, most)
    R = min(max(depth // C, 2), 8)
    q = 128 // item
    least = max(32 // G, 4)
    buf = sum(-(-s * C * least // q) * q for s in sizes) * item
    return 128 + R * buf <= BLOCK_SMEM


def _fwd_configs(dtype):
    return [(shape, G) for shape in ((12, 3), (16, 8), (16, 16))
            for G in FWD_GROUPS if _fwd_fits(*shape, dtype, G)]


def _dispatch(dtype):
    """The harness's instantiations at ``dtype``: every shape and group
    of the backward kernels, K11 where its ring fits."""
    bw = "\n".join(
        f"  if (nx == {nx} && nu == {nu} && ng == {ng} && G == {G}) "
        f"return run<T, {nx}, {nu}, {ng}, {G}>(N, B, brk, ld, ld3, lanes, "
        f"dt, in, out);" for nx, nu, ng in SHAPES for G in GROUPS) + "\n" + (
        "\n".join(
            f"  if (nx == {nx} && nu == {nu} && ng == {ng} && G == {g}) "
            f"return run<T, {nx}, {nu}, {ng}, {group}, true>(N, B, brk, ld, "
            f"ld3, lanes, dt, in, out);"
            for nx, nu, ng in SHAPES
            for g, group in ((0, "nmpc::kFmpcWideStreamGroup<T>"),
                             (-1, "nmpc::kFmpcWideGroup"))))
    fw = "\n".join(
        f"  if (nx == {nx} && nu == {nu} && G == {G}) return run_fwd<T, "
        f"{nx}, {nu}, {G}>(N, B, ld, in, out);"
        for (nx, nu), G in _fwd_configs(dtype))
    rules = "\n".join(
        f'  std::printf("fwd {nx} {nu} %d %d %zu\\n", '
        f"nmpc::kFmpcFwdGroup<T, {nx}, {nu}>, "
        f"nmpc::fmpc_fwd_chunk<T, {nx}, {nu}>(), "
        f"nmpc::fwd_smem<T, nmpc::FmpcFwdFields<{nx}, {nu}>>("
        f"nmpc::fmpc_fwd_chunk<T, {nx}, {nu}>(), nmpc::fwd_least_lanes<"
        f"nmpc::kFmpcFwdGroup<T, {nx}, {nu}>>()));"
        for nx in range(1, 17) for nu in range(1, 17)
        if K11.forward_wide_shape(nx, nu))
    return bw, fw, rules


_HARNESS = SHIM + KERNELS_PRELUDE + r"""
#include "fmpc_backward_packed_wide.cuh"
#include "fmpc_forward.cuh"

using T = @T@;

// in: K8's 13 fields at lane stride ld (each [N][size][ld]), K10's P_in
// [N][Fin][ld3], gms [N][NG], eps [B], Lx_bar_term [NX][B], P_T
// [NX][NX][B], s_T [NX][B]; out: K8's (or K9's) ks, Ks, svecs, Ps, ok,
// finite, K10's out, ok, finite, and the condensation nu_s, tilde
// [N][NG][B]; lanes >= 0: K9 at that many lanes a block (0: its rule) in
// K8's place, and nothing else; P: the profile build of K8 (or K9), its
// cycles after the condensation
template <typename S, int NX, int NU, int NG, int G, bool P = false>
int run(int N, int B, int brk, int ld, int ld3, int lanes, double dt,
        const S* in, S* out) {
  using O = nmpc::FmpcPackedLayout<NX, NU, NG>;
  const void* f[13];
  const S* p = in;
  for (int j = 0; j < 13; ++j) {
    f[j] = p;
    p += static_cast<size_t>(N) * nmpc::fmpc_field_size(NX, NU, NG, j) * ld;
  }
  const S* Pin = p;
  p += static_cast<size_t>(N) * O::F * ld3;
  const S* gms = p;
  p += static_cast<size_t>(N) * NG;
  const S* eps = p;
  p += B;
  const S* LxT = p;
  p += static_cast<size_t>(NX) * B;
  const S* PT = p;
  p += static_cast<size_t>(NX) * NX * B;
  const S* sT = p;
  std::vector<unsigned char> ok(B), fin(B);
  S* ks = out;
  S* Ks = ks + static_cast<size_t>(N) * NU * B;
  S* sv = Ks + static_cast<size_t>(N) * NU * NX * B;
  S* Ps = sv + static_cast<size_t>(N + 1) * NX * B;
  S* flags8 = Ps + static_cast<size_t>(N + 1) * NX * NX * B;
  S* out10 = flags8 + 2 * B;
  S* flags10 = out10 + static_cast<size_t>(N) * O::Fout * B;
  S* cond = flags10 + 2 * B;
  std::vector<long long> prof(P ? 8 * static_cast<size_t>(N) * B : 0, -1);
  if (nmpc::g_log) std::fprintf(nmpc::g_log, "K %d\n", lanes >= 0 ? 9 : 8);
  int err =
      lanes >= 0
          ? nmpc::launch_fmpc_backward_resident_wide<S, NX, NU, NG, G, P>(
                lanes, N, B, ld, dt, brk, 1, f, gms, NG, eps, LxT, PT, ks,
                Ks, sv, Ps, ok.data(), fin.data(), nullptr, prof.data())
          : nmpc::launch_fmpc_backward_wide<S, NX, NU, NG, G, P>(
                N, B, ld, dt, brk, 1, f, gms, NG, eps, LxT, PT, ks, Ks, sv,
                Ps, ok.data(), fin.data(), nullptr, prof.data());
  if (err) return 20 + err;
  for (size_t j = 0; j < prof.size(); ++j)
    cond[2 * static_cast<size_t>(N) * NG * B + j] = S(prof[j]);
  for (int b = 0; b < B; ++b) {
    flags8[b] = ok[b];
    flags8[B + b] = fin[b];
  }
  if (lanes >= 0) return 0;
  if (nmpc::g_log) std::fprintf(nmpc::g_log, "K 10\n");
  err = nmpc::launch_fmpc_backward_packed_wide<S, NX, NU, NG, G>(
      N, B, ld3, dt, brk, 1, Pin, sT, PT, out10, ok.data(), fin.data(),
      nullptr);
  if (err != 0 && err != cudaErrorInvalidValue) return 40 + err;
  for (int b = 0; b < B; ++b) {   // K10's block refused: ok -1
    flags10[b] = err ? S(-1) : S(ok[b]);
    flags10[B + b] = fin[b];
  }
  // the condensation K8's groups form, value by value
  const S* ss = static_cast<const S*>(f[10]);
  const S* nu = static_cast<const S*>(f[11]);
  const S* gbar = static_cast<const S*>(f[12]);
  for (int i = 0; i < N; ++i)
    for (int b = 0; b < B; ++b)
      for (int g = 0; g < NG; ++g) {
        const size_t at = (static_cast<size_t>(i) * NG + g) * ld + b;
        S nu_s, tilde;
        nmpc::fmpc_condense<S>(ss[at], nu[at], gbar[at],
                               gms[static_cast<size_t>(i) * NG + g] > S(0),
                               eps[b], nu_s, tilde);
        cond[(static_cast<size_t>(i) * NG + g) * B + b] = nu_s;
        cond[(static_cast<size_t>(N + i) * NG + g) * B + b] = tilde;
      }
  return 0;
}

int bw(int nx, int nu, int ng, int G, int N, int B, int brk, int ld,
       int ld3, int lanes, double dt, const T* in, T* out) {
@BW@
  return 2;
}

// in: A, Bm, xb, ks, Ks at lane stride ld ([N][size][ld]), dx0 [NX][B];
// out: dxs [N+1][NX][B], dus [N][NU][B]
template <typename S, int NX, int NU, int G>
int run_fwd(int N, int B, int ld, const S* in, S* out) {
  const int sizes[5] = {NX * NX, NX * NU, NX, NU, NU * NX};
  const void* f[5];
  const S* p = in;
  for (int j = 0; j < 5; ++j) {
    f[j] = p;
    p += static_cast<size_t>(N) * sizes[j] * ld;
  }
  return nmpc::launch_fmpc_forward<S, NX, NU, G,
                                   nmpc::fmpc_fwd_chunk<S, NX, NU>()>(
      N, B, ld, f[0], f[1], f[2], f[3], f[4], p, out,
      out + static_cast<size_t>(N + 1) * NX * B, nullptr);
}

int fw(int nx, int nu, int G, int N, int B, int ld, const T* in, T* out) {
@FW@
  return 2;
}

// "rules": the size rules of FmpcWideRule at every wide shape up to the
// ceiling (K8's at kFmpcWideStreamGroup, K9's and K10's at
// kFmpcWideGroup), then K11's group, chunk and ring at its fewest lanes at
// every wide (nx, nu)
void rules() {
  for (int nx = 1; nx <= 16; ++nx)
    for (int nu = 1; nu <= 16; ++nu)
      for (int ng = 1; ng <= 64; ++ng) {
        if (!nmpc::fmpc_wide(nx, nu, ng)) continue;
        const int G = nmpc::kFmpcWideStreamGroup<T>;
        const nmpc::FmpcWideRule<T> r = nmpc::fmpc_wide_rule<T>(nx, nu, ng, G);
        const nmpc::FmpcWideRule<T> k =
            nmpc::fmpc_wide_rule<T>(nx, nu, ng, nmpc::kFmpcWideGroup);
        int n9 = 0;
        for (int n = 1; n <= 40; ++n)
          if (k.resident_fits(n)) n9 = n;
        const int L = r.max_lanes(), Lp = k.packed_max_lanes();
        std::printf(
            "wide %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d "
            "%d %zu %zu %zu %zu\n",
            nx, nu, ng, G, r.F, r.Fin, r.stride, r.least, L, r.ring(),
            int(r.fits()), n9, k.resident_max_lanes(),
            n9 > 0 ? k.resident_lanes(n9, 4096) : 0,
            n9 > 0 ? k.resident_lanes(n9, 37) : 0, k.least, Lp,
            k.packed_chunk(), int(k.packed_fits()), k.packed_lanes(37),
            r.bytes(r.ring(), L), r.bytes(1, r.least),
            n9 > 0 ? k.resident_bytes(n9, k.least) : 0,
            k.packed_bytes(k.packed_chunk(), Lp));
      }
@RULES@
}

// fmpc_wide_host rules
// fmpc_wide_host bw nx nu ng G N B brk ld ld3 lanes dt n_in n_out in out log
// fmpc_wide_host fw nx nu G N B ld n_in n_out in out
int main(int argc, char** argv) {
  if (argc == 2) {
    rules();
    return 0;
  }
  const bool back = std::strcmp(argv[1], "bw") == 0;
  if (argc != (back ? 18 : 12)) return 1;
  int v[10];
  const int nv = back ? 10 : 6;   // then (bw) dt
  for (int j = 0; j < nv; ++j) v[j] = std::atoi(argv[2 + j]);
  const int at = back ? 13 : 8;   // n_in
  const size_t n_in = std::strtoull(argv[at], nullptr, 10);
  const size_t n_out = std::strtoull(argv[at + 1], nullptr, 10);
  std::vector<T> in(n_in), out(n_out);
  FILE* f = std::fopen(argv[at + 2], "rb");
  if (!f || std::fread(in.data(), sizeof(T), n_in, f) != n_in) return 4;
  std::fclose(f);
  int err;
  if (back) {
    nmpc::g_log = std::fopen(argv[at + 4], "w");
    err = bw(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9],
             std::atof(argv[12]), in.data(), out.data());
    std::fclose(nmpc::g_log);
  } else {
    err = fw(v[0], v[1], v[2], v[3], v[4], v[5], in.data(), out.data());
  }
  if (err) return err;
  f = std::fopen(argv[at + 3], "wb");
  if (!f || std::fwrite(out.data(), sizeof(T), n_out, f) != n_out) return 5;
  std::fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def wide_host(tmp_path_factory):
    """{dtype: the harness built by g++}, the two built side by side (their
    directories made first: two threads making a worker's first temporary
    directory at once race on its base directory)."""
    dirs = {dtype: tmp_path_factory.mktemp(f"fmpc_wide_{name}")
            for dtype, name in DTYPES.items()}

    def build(item):
        dtype, name = item
        bw, fw, rules = _dispatch(dtype)
        src = (_HARNESS.replace("@T@", name).replace("@BW@", bw)
               .replace("@FW@", fw).replace("@RULES@", rules))
        return dtype, build_kernels_host(dirs[dtype], src, "fmpc_wide_host")
    with concurrent.futures.ThreadPoolExecutor(len(DTYPES)) as pool:
        return dict(pool.map(build, DTYPES.items()))


def _np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _exchange(exe, args, inputs, n_out, dtype, workdir, tag):
    """Run the harness on ``inputs`` (flattened in order) and return its
    ``n_out`` output values, or the exit code where it is not 0."""
    flat = torch.cat([a.flatten() for a in inputs])
    inp, outp = workdir / f"{tag}.in", workdir / f"{tag}.out"
    inp.write_bytes(flat.numpy().tobytes())
    proc = subprocess.run([str(exe), *map(str, args), str(flat.numel()),
                           str(n_out), str(inp), str(outp)]
                          + ([str(workdir / f"{tag}.log")]
                             if args[0] == "bw" else []),
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        return proc.returncode, proc.stderr
    return torch.from_numpy(np.frombuffer(outp.read_bytes(),
                                          dtype=_np_dtype(dtype)).copy()), ""


def _host_bw(exe, shape, dtype, G, brk, workdir, lanes=-1):
    """The harness's K8 (ks, Ks, svecs, Ps, ok, finite), K10 (the same,
    unpacked) and the folded (nu_s, tilde) on ``_case``, fed as the
    wrappers feed them (K8's fields by ``tma_fields``, K10's buffer padded
    to the lane stride TMA takes), and the TMA log; with ``lanes`` >= 0
    K9 at that many lanes a block (0: its rule) as "K9" and nothing else;
    G = 0 (K8) or -1 (K9): the profile build at the kernel's group, its
    cycles as "prof".  None where the launch refuses the block (its invalid-value error)."""
    nx, nu, ng = shape
    N = _horizon(shape, dtype)
    dt, co, ss, nus, gms, eps = _case(shape, dtype, N)
    B = eps.shape[0]
    fields, ld = K8.tma_fields(co, ss, nus)
    nu_s, tilde = K8.condensation(co, ss, nus, gms, eps)
    P_in, ld3 = K8.padded_lanes(K8.pack_fmpc_inputs(co, nu_s, tilde))
    _, _, _, Fout = K8.field_offsets(nx, nu, ng)
    sizes = [N * nu * B, N * nu * nx * B, (N + 1) * nx * B,
             (N + 1) * nx * nx * B, 2 * B, N * Fout * B, 2 * B,
             2 * N * ng * B, K8.profile_values(N, B) if G <= 0 else 0]
    tag = f"bw{G}_{int(brk)}_{lanes}"
    o, err = _exchange(
        exe, ["bw", nx, nu, ng, G, N, B, int(brk), ld, ld3, lanes,
              repr(float(dt))],
        list(fields) + [P_in, gms, eps, co.Lx_bar_term, co.Lxx_term,
                        -co.Lx_bar_term], sum(sizes), dtype, workdir, tag)
    if isinstance(o, int):
        assert o == 21, (o, err)   # K8's (or K9's) cudaErrorInvalidValue
        return None
    parts = torch.split(o, sizes)
    k8 = (parts[0].reshape(N, nu, B), parts[1].reshape(N, nu, nx, B),
          parts[2].reshape(N + 1, nx, B), parts[3].reshape(N + 1, nx, nx, B),
          parts[4][:B] != 0, parts[4][B:] != 0)
    log = (workdir / f"{tag}.log").read_text().splitlines()
    prof = parts[8]
    if lanes >= 0:
        return {"K9": k8, "log": log, "prof": prof}
    packed = K8.unpack_fields(parts[5].reshape(N, Fout, B),
                              K8._out_shapes(nx, nu))
    k10 = (None if bool((parts[6][:B] < 0).any()) else
           (packed["k"], packed["K"], packed["svec"], packed["P"],
            parts[6][:B] != 0, parts[6][B:] != 0))
    cond = parts[7].reshape(2, N, ng, B)
    return {"K8": k8, "K10": k10, "cond": (cond[0], cond[1]),
            "ref_cond": (nu_s, tilde), "log": log, "prof": prof}


@pytest.fixture(scope="module")
def runs(wide_host, tmp_path_factory):
    """The harness's backward runs, by (shape, dtype, G, brk, lanes)."""
    cache = {}

    def get(shape, dtype, G, brk, lanes=-1):
        key = (shape, dtype, G, brk, lanes)
        if key not in cache:
            cache[key] = _host_bw(wide_host[dtype], shape, dtype, G, brk,
                                  tmp_path_factory.mktemp("wide"), lanes)
        return cache[key]
    return get


def _same_out(a, b):
    return all(same(x, y) if x.is_floating_point() else torch.equal(x, y)
               for x, y in zip(a, b))


def _fits(shape, dtype, G):
    """Whether K8's and K10's blocks of the fewest lanes at ``G`` fit."""
    r = _rule(shape, dtype, G)
    return r.fits, r.packed_fits


CASES = [(shape, dtype, brk) for shape in SHAPES
         for dtype in (torch.float32, torch.float64) for brk in (False, True)]


def _id(v):
    if isinstance(v, tuple):
        return "x".join(map(str, v))
    return str(v).replace("torch.", "")


@pytest.mark.parametrize("shape,dtype,brk", CASES, ids=_id)
def test_wide_kernels_as_host_cpp(runs, monkeypatch, shape, dtype, brk):
    """K8 and K10 at a wide shape on the host through their launch
    functions at every G of GROUPS at their rules' lanes a block (K8's
    the same at every B: at the masses' group 4 lanes at fp32 and 2 at
    fp64, so B=37 ends on a block of one live lane and a warp wholly past
    B): each launched where its block fits (the Python twin's rule) and refused
    elsewhere; every output bit-equal to the smallest G's (NaN lanes NaN
    where they are; K10's to its own smallest G's); K10 bit-equal to K8 on
    the finite lanes with the same masks; the folded scalings bit-equal to
    ``condensation()``; the smallest G within TOL of ``_backward_bm`` with
    a correctly rounded sqrt on its finite lanes, with the same ok and
    finite masks (the NaN lane not finite, the clean lanes finite, the
    non-PD lane failing only with ``break_if_llt_fails``)."""
    outs, k10s = {}, {}
    _case(shape, dtype, _horizon(shape, dtype))   # torch.func: one thread
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        done = dict(zip(GROUPS, pool.map(
            lambda G: runs(shape, dtype, G, brk), GROUPS)))
    for G, out in done.items():
        fit8, fit10 = _fits(shape, dtype, G)
        assert (out is not None) == fit8, G
        if out is not None:
            assert (out["K10"] is not None) == fit10, G
            outs[G] = out["K8"]
            if fit10:
                k10s[G] = out["K10"]
            for a, b in zip(out["ref_cond"], out["cond"]):
                assert torch.equal(bits(a), bits(b)), G
    assert _rule(shape, dtype).G in outs and K8.WIDE_GROUP in k10s
    G0 = min(outs)
    ref = outs[G0]
    for G in outs:
        assert _same_out(ref, outs[G]), ("K8", G, G0)
    for G in k10s:
        assert _same_out(ref[4:], k10s[G][4:]), ("K10 masks", G)
        assert _same_out(k10s[min(k10s)], k10s[G]), ("K10", G)
    k10 = k10s[min(k10s)]
    N = ref[0].shape[0]
    lanes = ref[5]
    assert all(torch.equal(bits(a[..., lanes]), bits(b[..., lanes]))
               for a, b in zip(ref[:2] + tuple(a[:N] for a in ref[2:4]),
                               k10[:4]))
    dt, co, ss, nus, gms, eps = _case(shape, dtype, N)
    cfg = FmpcConfig(horizon_steps=N, break_if_llt_fails=brk)
    p = types.SimpleNamespace(dt=dt)   # all _backward_bm reads of it
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", exact_sqrt)
        plain = fmpc._backward_bm(p, cfg, co, ss, nus, gms, eps)
    finite = plain[5]
    assert torch.equal(ref[4], plain[4]) and torch.equal(finite, ref[5])
    assert not finite[2] and bool(finite[0]) and bool(finite[4:].all())
    assert bool(plain[4][1]) != brk and bool(plain[4][3]) != brk
    for a, b in zip(plain[:4], ref[:4]):
        a, b = a[..., finite].double(), b[..., finite].double()
        err = (a - b).abs().max() / (1 + a.abs().max())
        assert err <= TOL[dtype], float(err)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=_id)
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_wide_resident_and_boxes(runs, shape, dtype):
    """K9 at a wide shape through its launch function, its rule's lanes,
    the fewest and its most where their horizon fits (4 at fp64):
    bit-equal to K8 where its horizon fits (``resident_fits``, the Python
    twin), refused where it does not; and the TMA issue of the kernels'
    runs at their groups.  K8 at its rule's block (rows of lanes x
    itemsize bytes: 16): a stage's
    boxes a stage from the end of the horizon, at the block's first lane,
    landing 128-byte aligned, one arm of the stage's bytes a stage, the
    stage's boxes issued by as many threads of the producer warp as it
    has boxes (at most 32); K9 one arm a stage of its horizon, every box
    of the horizon issued at once over the warp's 32 threads; K10's boxes
    256 rows of the block's lanes each, starting at its first lane and
    landing 128-byte aligned, one arm a chunk of C stages, ceil(N / C)
    chunks."""
    N = _horizon(shape, dtype)
    rule, rule9 = _rule(shape, dtype), _rule(shape, dtype, K8.WIDE_GROUP)
    G = rule.G
    item = torch.empty((), dtype=dtype).element_size()
    fits = K8.resident_fits(*shape, N, dtype)
    assert fits == rule9.resident_fits(N)
    most = rule9.resident_max_lanes
    widest = ({most} if fits and rule9.resident_bytes(N, most) <= BLOCK_SMEM
              else set())
    for brk in (False, True):
        ref = runs(shape, dtype, G, brk)["K8"]
        for lanes in sorted({0, rule9.least} | widest):
            out = runs(shape, dtype, K8.WIDE_GROUP, brk, lanes)
            assert (out is not None) == fits, lanes
            if out is not None:
                assert _same_out(ref, out["K9"]), (brk, lanes)
    boxes = sum(K8.wide_boxes(s)[0] for s in K8._stage_sizes(*shape))
    L = rule.max_lanes
    events = _events(runs(shape, dtype, G, False)["log"])
    stage_bytes = rule.F * L * item
    blocks = 0
    for (blk, _), ev in events[8].items():
        loads = [e for e in ev if e[0] == "L"]
        if not loads:
            continue
        blocks += 1
        assert [e[2] for e in loads] == [i for i in reversed(range(N))
                                         for _ in range(boxes)]
        assert {e[1] for e in loads} == {blk * L}
        assert all(e[3] % 128 == 0 and e[4] % (L * item) == 0
                   for e in loads)
        arms = [e for e in ev if e[0] == "A"]
        assert [e[2] for e in arms] == [stage_bytes] * N
        for i in range(N):
            issuers = {e[5] for e in loads if e[2] == i}
            assert sum(e[4] for e in loads if e[2] == i) == stage_bytes
            assert len(issuers) == min(32, boxes), (i, issuers)
    assert blocks == -(-B_HOST // L)
    k10 = _rule(shape, dtype, K8.WIDE_GROUP)
    Fin, C = k10.Fin, min(k10.packed_chunk, N)
    Lp = k10.packed_lanes(B_HOST)
    starts = []
    for (blk, _), ev in _events(runs(shape, dtype, K8.WIDE_GROUP, False)[
            "log"])[10].items():
        loads = [e for e in ev if e[0] == "L"]
        if not loads:
            continue
        assert {e[1] for e in loads} == {blk * Lp}
        assert all(e[4] == 256 * Lp * item and e[3] % 128 == 0
                   for e in loads)
        starts.append(sum(e[0] == "A" for e in ev))
    assert starts and all(n == -(-N // C) for n in starts)
    if fits:
        L9 = rule9.resident_lanes(N, B_HOST)
        for (blk, _), ev in _events(runs(shape, dtype, K8.WIDE_GROUP, False,
                                         0)["log"])[9].items():
            loads = [e for e in ev if e[0] == "L"]
            if not loads:
                continue
            arms = [e for e in ev if e[0] == "A"]
            assert [e[2] for e in arms] == [rule.F * L9 * item] * N
            assert len(loads) == N * boxes and {e[1] for e in loads} == {
                blk * L9}
            assert len({e[5] for e in loads}) == min(32, N * boxes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=_id)
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_wide_profile_build(runs, shape, dtype):
    """The profile build of K8 and K9 (G = 0 and -1 in the harness: their
    groups with P) bit for bit with the normal build, ok and finite masks
    included, K9 where its horizon fits; its cycles: each live lane's
    stages a positive total and no negative part, each lane's wait timed;
    the producer's two parts of each stage of each block non-negative, the
    issue positive (K9's horizon issued at once: its first)."""
    N = _horizon(shape, dtype)
    rule, rule9 = _rule(shape, dtype), _rule(shape, dtype, K8.WIDE_GROUP)
    parts = len(K8.WIDE_PHASES)
    for lanes in (-1, 0):
        if lanes == 0 and not rule9.resident_fits(N):
            continue
        key = "K9" if lanes == 0 else "K8"
        normal = runs(shape, dtype, rule9.G if lanes == 0 else rule.G, False,
                      lanes)
        prof = runs(shape, dtype, -1 if lanes == 0 else 0, False, lanes)
        assert _same_out(normal[key], prof[key]), key
        cyc = prof["prof"].double()
        lane = cyc[:parts * N * B_HOST].reshape(parts, N, B_HOST)
        assert bool((lane >= 0).all()) and bool((lane.sum(0) > 0).all())
        assert bool((lane[0] > 0).any(0).all()), key   # a wait a stage
        L = (rule9.resident_lanes(N, B_HOST) if lanes == 0 else
             rule.max_lanes)
        blocks = -(-B_HOST // L)
        prod = cyc[parts * N * B_HOST:][:2 * N * blocks].reshape(2, N,
                                                                 blocks)
        issued = 1 if lanes == 0 else N   # K9: the horizon's at once
        assert bool((prod[:, :issued] >= 0).all()), key
        assert bool((prod[1, :issued] > 0).all()), key


@pytest.fixture(scope="module")
def rules(wide_host):
    """What the headers' rules give per dtype: {itemsize: {"wide": {(nx,
    nu, ng): values}, "fwd": {(nx, nu): (G, C, smem)}}}."""
    found = {}
    for dtype, exe in wide_host.items():
        item = torch.empty((), dtype=dtype).element_size()
        out = subprocess.run([str(exe), "rules"], check=True,
                             capture_output=True, text=True,
                             timeout=120).stdout
        wide, fwd = {}, {}
        for line in out.splitlines():
            kind, *v = line.split()
            v = list(map(int, v))
            if kind == "wide":
                wide[tuple(v[:3])] = tuple(v[3:])
            else:
                fwd[tuple(v[:2])] = tuple(v[2:])
        found[item] = {"wide": wide, "fwd": fwd}
    return found


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_rules_are_the_headers(rules, dtype):
    """At every wide (nx <= 16, nu <= 16, ng <= 64), both dtypes:
    ``wide_rule`` (and ``stream_group``, ``resident_fits``,
    ``wide_stage_values``) equal ``FmpcWideRule``'s values, K8's at its
    group, K9's and K10's at ``WIDE_GROUP``; every block (K8's ring at its
    lanes, the fewest lanes' one-stage ring, K9's largest horizon, K10's
    chunks) within 227 KB, K8's within 2 consumer warps and the
    producer's, K9's and K10's within 8 warps, the lanes a whole number of
    warps and of 16-byte box rows, K8's rows of 16 bytes, K9's most lanes
    (4: 8 warps at one lane a warp) its lanes at every B where its horizon
    does not bound them; at the masses' (12, 3, 30) K8's block of 4 lanes
    of 16 threads at fp32 and 2 of 32 at fp64 (a ring of two stages), its
    bytes (four blocks within an SM's shared memory), K9 to N = 14 at 4
    (fp32) and 2 (fp64) lanes, K10 as before (4 lanes, chunks of 7 and 3
    stages); and K11's ring of its
    chunk at its group and fewest lanes within 227 KB at every wide (nx,
    nu)."""
    item = torch.empty((), dtype=dtype).element_size()
    wide = rules[item]["wide"]
    assert len(wide) == 16 * 16 * 64 - 8 * 4 * 16
    for (nx, nu, ng), v in wide.items():
        (G, F, Fin, stride, least, L, R, fits, n9, L9max, L9, L937,
         least10, Lp, Cp, pfits, Lp37, smem, smem1, smem9, smemp) = v
        assert G == K8.stream_group(dtype)
        r = K8.wide_rule(nx, nu, ng, dtype)
        k = K8.wide_rule(nx, nu, ng, dtype, K8.WIDE_GROUP)
        twin = (r.G, r.F, r.Fin, r.stride, r.least, r.max_lanes, r.ring,
                int(r.fits),
                max([n for n in range(1, 41) if k.resident_fits(n)],
                    default=0), k.resident_max_lanes)
        assert twin == (G, F, Fin, stride, least, L, R, fits, n9, L9max)
        assert (k.least, k.packed_max_lanes, k.packed_chunk,
                int(k.packed_fits), k.packed_lanes(37)) == (
                    least10, Lp, Cp, pfits, Lp37)
        assert (r.bytes(R, L), r.bytes(1, least)) == (smem, smem1)
        assert smem9 == (k.resident_bytes(n9, least10) if n9 else 0)
        assert (L9, L937) == ((k.resident_lanes(n9, 4096),
                               k.resident_lanes(n9, 37)) if n9 else (0, 0))
        assert smemp == k.packed_bytes(Cp, Lp)
        assert F == K8.wide_stage_values(nx, nu, ng) and n9 <= 32
        assert fits and pfits and R >= 1 and Cp >= 1
        for size in (smem, smem1, smem9, smemp):
            assert size <= BLOCK_SMEM, (nx, nu, ng)
        assert L == least and L * G + 32 <= 96 and L * item == 16
        assert L9max == 4
        for lanes in (Lp, Lp37, L9max) + ((L9, L937) if n9 else ()):
            assert least10 <= lanes <= 32 and lanes * 32 + 32 <= 256
            assert (lanes * item) % 16 == 0
        if n9:
            assert L937 == least10
            assert L9 == L9max or k.resident_bytes(n9, 2 * L9) > BLOCK_SMEM
        assert all(K8.resident_fits(nx, nu, ng, n, dtype) == (n <= n9)
                   for n in (1, n9, n9 + 1) if n >= 1)
    masses = wide[MASSES]
    r = K8.wide_rule(*MASSES, dtype)
    lanes = 16 // item
    assert masses[:5] == (64 // lanes, 984, 906, 736, lanes)
    assert (r.max_lanes, r.ring) == (lanes, 2)
    smem = 128 + 2 * 984 * lanes * item + lanes * 736 * item
    assert r.bytes(2, lanes) == smem == 43392
    assert 4 * (smem + 1024) <= 228 * 1024   # an SM's, 1 KB a block kept
    assert masses[8:12] == (14, 4, 4 if item == 4 else 2, lanes)  # K9
    assert masses[12:15] == (16 // item, 4, 7 if item == 4 else 3)
    fwd = rules[item]["fwd"]
    assert len(fwd) == 16 * 16 - 8 * 4
    for (nx, nu), (G, C, smem) in fwd.items():
        assert G == 4 and C >= 1 and smem <= BLOCK_SMEM, (nx, nu)


def _k11_case(shape, dtype, N, B=B_HOST):
    """(A, Bm, xb, ks, Ks, dx0) of a stable recursion at ``shape``, made
    from a seed: A near the identity, K a damping feedback."""
    nx, nu = shape
    rng = np.random.default_rng(nx * 10 + nu + N)
    t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()
    A = np.eye(nx)[None, :, :, None] + 0.05 * rng.normal(size=(N, nx, nx, B))
    return (t(A), t(0.1 * rng.normal(size=(N, nx, nu, B))),
            t(0.01 * rng.normal(size=(N, nx, B))),
            t(0.1 * rng.normal(size=(N, nu, B))),
            t(-0.3 * rng.uniform(size=(N, nu, nx, B)) / nx),
            t(rng.normal(size=(nx, B))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_forward_as_host_cpp(wide_host, tmp_path, dtype):
    """K11 at (12, 3), (16, 8) and (16, 16) through its launch function at
    its chunk and G = 1 (where its ring fits), 2 and 4, B=37 (its fields
    copied to a lane stride TMA takes), N=9: every G bit-equal to the
    smallest, within TOL of ``forward_fmpc_deltas_plain``."""
    N = 9
    by_shape = {}
    for shape, G in _fwd_configs(dtype):
        by_shape.setdefault(shape, []).append(G)
    assert all(4 in gs and 2 in gs for gs in by_shape.values())
    for (nx, nu), groups in by_shape.items():
        case = _k11_case((nx, nu), dtype, N)
        fields, ld, _ = K8.padded_fields(case[:5])
        outs = {}
        for G in groups:
            o, err = _exchange(wide_host[dtype],
                               ["fw", nx, nu, G, N, B_HOST, ld],
                               list(fields) + [case[5]],
                               (N + 1) * nx * B_HOST + N * nu * B_HOST,
                               dtype, tmp_path, f"fw{nx}_{nu}_{G}")
            assert not isinstance(o, int), (o, err)
            cut = (N + 1) * nx * B_HOST
            outs[G] = (o[:cut].reshape(N + 1, nx, B_HOST),
                       o[cut:].reshape(N, nu, B_HOST))
        ref = outs[min(outs)]
        for G, out in outs.items():
            assert _same_out(ref, out), ((nx, nu), G)
        plain = K11.forward_fmpc_deltas_plain(*case)
        for a, b in zip(plain, ref):
            a, b = a.double(), b.double()
            assert (a - b).abs().max() / (1 + a.abs().max()) <= TOL[dtype]


# ---- the port against JAX on the CPU ----


VARIABLE = ("xs", "us", "lambdas", "ss", "nus")


def _jax_case(shape, dtype, N, B, seed, **cfg):
    """A masses shape's coefficients of a random iterate (the port's
    ``_coeffs_bm``, which ``test_torch_fmpc_kernels.py`` holds to JAX's,
    handed to JAX as the same numpy arrays) in both packages: (JAX
    problem, config, coefficients, variable, masks, eps) and the port's."""
    jp, pp = masses_problems(shape)
    rng = np.random.default_rng(seed)
    it = _random_iterate(shape, N, B, rng, dtype)
    pc = FmpcConfig(horizon_steps=N, **cfg)
    co = fmpc._coeffs_bm(pp, pc, torch.zeros((), dtype=dtype),
                         fmpc.FmpcVariable(**it))
    gms = torch.ones((N, shape[2]), dtype=dtype)
    eps = torch.full((B,), 1e-4, dtype=dtype)
    j = lambda a: jnp.asarray(a.numpy())
    return ((jp, JaxFmpcConfig(horizon_steps=N, **cfg),
             JF._StCoeffs(*map(j, co)),
             JaxVariable(**{k: j(v) for k, v in it.items()}), j(gms),
             j(eps)),
            (pp, pc, co, fmpc.FmpcVariable(**it), gms, eps))


# (shape, break_if_llt_fails) held against JAX: the masses both ways; the
# eight masses with the LLT's failure ending the lane (JAX's eager scan
# with the 8 x 8 Gauss-Jordan inverse takes ~35 s to compile a dtype)
JAX_CASES = [((12, 3, 30), False), ((12, 3, 30), True), ((16, 8, 48), True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=_id)
@pytest.mark.parametrize("shape,brk", JAX_CASES, ids=_id)
def test_wide_backward_and_forward_match_jax(shape, brk, dtype):
    """At a masses shape (N=6, B=16, one lane NaN-poisoned, one non-PD):
    the port's ``_backward_bm`` and the K8, K9 and K10 entries (their
    plain versions on CPU tensors, no launch; K9 where its horizon fits,
    refused elsewhere) against JAX's ``_backward_bm``, and ``_forward_bm``
    (plain and the K11 entry) against JAX's, within 3e-5 (fp32) and 1e-12
    (fp64), masks equal."""
    N, B = 6, 16
    (jp, jc, jco, jvar, jgms, jeps), (pp, pc, co, var, gms, eps) = _jax_case(
        shape, dtype, N, B, seed=1, break_if_llt_fails=brk)
    A = co.A.clone()
    A[2, 0, 1, 5] = float("nan")
    Luu = co.Luu.clone()
    Luu[:, :, :, 7] = -1e4 * torch.eye(shape[1], dtype=dtype)[None]
    co = co._replace(A=A, Luu=Luu)
    jco = jco._replace(A=jnp.asarray(A.numpy()), Luu=jnp.asarray(Luu.numpy()))
    want = JF._backward_bm(jp, jc, jco, jvar.ss, jvar.nus, jgms, jeps)
    counts = (K8.backward_fmpc_fused.wide_launches,
              K8.backward_fmpc_fused.resident_wide_launches,
              K8.backward_fmpc_packed.wide_launches,
              K11.forward_fmpc_deltas_fused.wide_launches)
    tol = JAX_TOL[dtype]
    got_all = [fmpc._backward_bm(pp, pc, co, var.ss, var.nus, gms, eps)]
    for variant in K8.VARIANTS:
        call = functools.partial(K8.backward_fmpc_fused, pp, pc, co, var.ss,
                                 var.nus, gms, eps, variant=variant)
        if variant == "resident" and not K8.resident_fits(*shape, N, dtype):
            with pytest.raises(ValueError, match="resident"):
                call()
            continue
        got_all.append(call())
    # the lanes JAX calls ok and finite (a lane whose LLT failed with
    # break_if_llt_fails runs on with garbage that overflows)
    lanes = np.asarray(want[4]) & np.asarray(want[5])
    for got in got_all:
        for name, a, b in zip(("ks", "Ks", "svecs", "Ps"), want[:4],
                              got[:4]):
            np.testing.assert_allclose(b.numpy()[..., lanes],
                                       np.asarray(a)[..., lanes], atol=tol,
                                       err_msg=name)
        for a, b in zip(want[4:], got[4:]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    fin = got_all[0][5]
    assert not bool(fin[5]) and int(fin.sum()) >= B - 2
    assert bool(got_all[0][4][7]) != brk
    ks, Ks, svecs, Ps = (torch.nan_to_num(a) for a in got_all[0][:4])
    jks, jKs, jsv, jPs = (jnp.asarray(a.numpy()) for a in (ks, Ks, svecs,
                                                            Ps))
    x0 = np.random.default_rng(2).normal(size=(shape[0], B))
    x0 = x0.astype(_np_dtype(dtype))
    co = co._replace(A=torch.nan_to_num(co.A))
    jd, jfin = JF._forward_bm(jp, jc, jco._replace(A=jnp.asarray(
        co.A.numpy())), jvar, jnp.asarray(x0), jks, jKs, jsv, jPs, jeps,
        jgms)
    for fused in (False, True):
        d, dfin = fmpc._forward_bm(pp, pc, co, var, torch.as_tensor(x0), ks,
                                   Ks, svecs, Ps, eps, gms, fused=fused)
        for name in VARIABLE:
            np.testing.assert_allclose(getattr(d, name).numpy()[..., lanes],
                                       np.asarray(getattr(jd, name))[
                                           ..., lanes],
                                       atol=tol, rtol=tol, err_msg=name)
        np.testing.assert_array_equal(dfin.numpy()[lanes],
                                      np.asarray(jfin)[lanes])
    assert counts == (K8.backward_fmpc_fused.wide_launches,
                      K8.backward_fmpc_fused.resident_wide_launches,
                      K8.backward_fmpc_packed.wide_launches,
                      K11.forward_fmpc_deltas_fused.wide_launches)


def test_masses_solve_matches_jax():
    """The masses' fp64 ``solve_batch`` (B=8, N=30, the default config
    with max_iter=30, x0 uniform in [-1.5, 1.5] from a seed, the reset
    warm start): every lane SUCCEEDED after 20 iterations, statuses and
    iterations equal to JAX's, every variable within 1e-8; the inputs
    saturate at the bound."""
    B, N = 8, 30
    jp, pp = masses_problems(MASSES)
    nx, nu, ng = MASSES
    x0s = np.random.default_rng(0).uniform(-1.5, 1.5, size=(B, nx))
    reset = jax_reset(N, nx, nu, ng, dtype=np.float64)
    var = {k: np.ascontiguousarray(np.broadcast_to(
        np.asarray(getattr(reset, k)), (B,) + np.asarray(
            getattr(reset, k)).shape)) for k in VARIABLE}
    eps = np.full((B,), 1e-4)
    jc = JaxFmpcConfig(horizon_steps=N, max_iter=30)
    jr = JaxFmpcSolver(jp, jc).solve_batch(
        jnp.asarray(0.0), jnp.asarray(x0s),
        JaxVariable(**{k: jnp.asarray(v) for k, v in var.items()}),
        jnp.asarray(eps))
    pr = fmpc_result_to_numpy(FmpcSolver(pp, fmpc_config_from_reference(
        jc)).solve_batch(0.0, torch.as_tensor(x0s),
                         fmpc_variable_from_numpy("cpu", torch.float64,
                                                  **var),
                         torch.as_tensor(eps)))
    np.testing.assert_array_equal(pr["status"], np.asarray(jr.status))
    np.testing.assert_array_equal(pr["iters"], np.asarray(jr.iters))
    assert (pr["status"] == 1).all() and (pr["iters"] == 20).all()
    for k in VARIABLE:
        np.testing.assert_allclose(pr["variable"][k],
                                   np.asarray(getattr(jr.variable, k)),
                                   atol=1e-8, err_msg=k)
    assert np.abs(pr["variable"]["us"]).max() == pytest.approx(0.5, abs=1e-3)


def test_wide_limits_and_routing():
    """``kernel_supports`` and ``forward_kernel_supports`` hold up to (16,
    16, 64) at fp32 and fp64 and not past it; ``_resolve_impls`` takes
    ("pallas", "fused") on CUDA at the masses' shape and the plain pair
    past the ceiling, where an explicit kernel raises naming the shape and
    the ceiling; the wide unit's source and name per variant."""
    for dtype in (torch.float32, torch.float64):
        assert K8.kernel_supports(16, 16, 64, dtype)
        assert K11.forward_kernel_supports(16, 16, dtype)
        for shape in ((17, 16, 64), (16, 17, 64), (16, 16, 65)):
            assert not K8.kernel_supports(*shape, dtype)
        assert not K11.forward_kernel_supports(17, 1, dtype)
        assert not K11.forward_kernel_supports(1, 17, dtype)
    assert not K8.kernel_supports(12, 3, 30, torch.float16)
    _, masses = masses_problems(MASSES)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for dtype in (torch.float32, torch.float64):
        assert _resolve_impls(FmpcConfig(), masses, dtype, cuda) == (
            "pallas", "fused")
        assert _resolve_impls(FmpcConfig(), masses, dtype, cpu) == (
            "stacked", "scan")
    past = dataclasses.replace(masses, ineq_dim=65)
    assert _resolve_impls(FmpcConfig(), past, torch.float32, cuda) == (
        "stacked", "fused")
    with pytest.raises(ValueError, match=r"up to \(16, 16, 64\).*\(12, 3, "
                       r"65\)"):
        _resolve_impls(FmpcConfig(backward_impl="pallas"), past,
                       torch.float32, cuda)
    big = dataclasses.replace(masses, state_dim=17)
    with pytest.raises(ValueError, match=r"up to \(16, 16\).*\(17, 3\)"):
        _resolve_impls(FmpcConfig(forward_impl="fused"), big, torch.float32,
                       cuda)
    for variant, header, launch in (
            ("stream", "fmpc_backward_wide.cuh", "launch_fmpc_backward_wide"),
            ("resident", "fmpc_backward_wide.cuh",
             "launch_fmpc_backward_resident_wide"),
            ("packed", "fmpc_backward_packed_wide.cuh",
             "launch_fmpc_backward_packed_wide")):
        src = K8.unit_source(12, 3, 30, torch.float32, variant)
        assert header in src and f"{launch}<float, 12, 3, 30>" in src
        name = K8.unit_name(12, 3, 30, torch.float32, variant)
        assert name.endswith("_wide_12x3x30_float32")
        assert "wide" not in K8.unit_name(8, 4, 16, torch.float32, variant)
    assert "launch_fmpc_backward_wide<double, 12, 3, 30, 8>" in (
        K8.unit_source(12, 3, 30, torch.float64, group=8))
    with pytest.raises(ValueError, match="share"):
        K8.unit_source(12, 3, 30, torch.float32, share=True)
    assert K8.wide_shape(9, 1, 1) and K8.wide_shape(1, 5, 1)
    assert K8.wide_shape(1, 1, 17) and not K8.wide_shape(8, 4, 16)
    assert not K8.resident_fits(12, 3, 30, 30, torch.float32)
    assert K8.resident_fits(12, 3, 30, 12, torch.float32)
