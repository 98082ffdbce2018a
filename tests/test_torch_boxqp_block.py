"""The Armijo block rule of the boxed DDP backward's QP, on the CPU.

The boxed kernels (K4 ``csrc/ddp_backward_boxed.cuh``, K5 boxed
``csrc/ddp_backward_remat.cuh``) run each lane's projected-Newton QP
(``csrc/boxqp.cuh::boxqp``) on a group of G threads and evaluate the
Armijo schedule G candidates at a time: the first candidate of a block
where the sequential search would stop is the search's.  The plain
version ``kernels/ddp_backward.py::boxqp_stacked`` evaluates a head of
``ls_block`` candidates at once and the rest one by one.  Held here:

* ``boxqp_stacked`` gives bit-identical x, ok, free set and factor, and the
  same iteration counts, for every ``ls_block`` in {1, 4, 8, 9, 16, 105},
  on the QPs of the boxed vertical model's first iteration and of the
  boxed cart-pole, at fp32 and fp64, with the planted 7-iteration QP of
  ``chip_smoke.py`` (``LONG_QP``) and a NaN lane that exhausts the
  schedule: at the first step below ``min_step`` under the default
  configuration, at the 105th candidate with ``min_step = 0``;
* where ``g++`` is on PATH, ``boxqp.cuh`` compiled as host C++ with a shim
  that runs each 32-thread warp as 32 host threads meeting at every warp
  exchange (the lanes of a warp are 32 / G consecutive QPs, a ragged last
  warp as on the card): every thread of a group ends with the same bits; G =
  4, 8, 16 equal G = 1 bit for bit, and G = 1 equals the plain version run
  with a correctly rounded ``sqrt`` (torch's vectorized CPU ``sqrt`` is not,
  at fp32 or fp64; the card's and the host build's are).
"""

import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from nmpc_tpu_torch import BoxQPConfig, DDPConfig
from nmpc_tpu_torch.kernels import ddp_backward
from nmpc_tpu_torch.kernels.build import CSRC
from nmpc_tpu_torch.kernels.ddp_backward import (StackedBounds, StackedDerivs,
                                                 backward_stacked_boxed,
                                                 boxqp_stacked)
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.models.vertical import make_vertical_problem
from nmpc_tpu_torch.solvers import ddp, stages

torch.set_num_threads(1)

DT = 0.01
LS_BLOCKS = (1, 4, 8, 9, 16, 105)
GROUPS = (1, 4, 8, 16)
# chip_smoke.py's LONG_QP: (H, g, lower, upper), 7 iterations from x0 = 0
LONG_QP = ([[1.24, 1.82], [1.82, 2.68]], [2.42, 3.13], [-0.06, -0.9],
           [0.95, 0.52])
# the default configuration, and one whose schedule runs to its end: no
# step of 0.6^k, k <= 104, is below min_step = 0
CONFIGS = {"default": BoxQPConfig(), "min_step=0": BoxQPConfig(min_step=0.0)}


def _stage_qps(model, dtype, B=16, N=24):
    """The QPs (H, g, lower, upper, x0), batch-minor [.., S], that the
    first iteration's boxed backward solves: every stage of every lane of
    the vertical model from t0 = 1.9 (the horizon crosses the switch to two
    contacts) or of the cart-pole with force limits (-15, 15), each stage
    warm-started from the later stage's solution."""
    rng = np.random.default_rng(3)
    if model == "vertical":
        p, t0 = make_vertical_problem(DT), 1.9
        x0s = np.tile([1.2, 0.0], (B, 1)) + 0.05 * rng.normal(size=(B, 2))
        us = 0.02 * rng.normal(size=(N, 2, B))
    else:
        p, t0 = make_cartpole_problem(DT, input_limits=(-15.0, 15.0)), 0.3
        x0s = (np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
               + 0.05 * rng.normal(size=(B, 4)))
        us = 5.0 * rng.normal(size=(N, 1, B))
    as_t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()
    cfg = DDPConfig(horizon_steps=N, with_input_constraint=True)
    t0, us = as_t(t0), as_t(us)
    xs, _ = ddp._rollout_lanes(p, cfg, t0, as_t(x0s.T), us)
    VxT, VxxT = ddp._terminal_quad_lanes(p, cfg, t0, xs)
    D = stages._stage_derivs_sweep(p, cfg, t0, xs, us)
    lam = torch.full((B,), 1e-6, dtype=dtype)
    qps = []

    def record(H, g, lower, upper, x0, config, host=bool, stats=None):
        qps.append((H, g, lower, upper, x0))
        return boxqp_stacked(H, g, lower, upper, x0, config, host, stats)

    mp = pytest.MonkeyPatch()
    mp.setattr(ddp_backward, "boxqp_stacked", record)
    try:
        backward_stacked_boxed(cfg, StackedDerivs(*D[:7]),
                               StackedBounds(*D[-3:]), VxT.contiguous(),
                               VxxT.contiguous(), lam)
    finally:
        mp.undo()
    return [torch.cat(parts, dim=-1) for parts in zip(*qps)]


def _planted(model, dtype):
    """The QP batch of ``_stage_qps`` with, at nu = 2, LONG_QP from x0 = 0
    in one extra lane, and a lane whose lower bound is NaN: its iterate and
    every candidate's objective are NaN, so Armijo never accepts."""
    H, g, lo, hi, x0 = _stage_qps(model, dtype)
    n = g.shape[0]
    extra = []
    if n == 2:
        extra.append([torch.as_tensor(a, dtype=dtype) for a in LONG_QP]
                     + [torch.zeros(2, dtype=dtype)])
    nan_lo = torch.full((n,), -1.0, dtype=dtype)
    nan_lo[0] = float("nan")
    extra.append([torch.eye(n, dtype=dtype), torch.ones(n, dtype=dtype),
                  nan_lo, torch.ones(n, dtype=dtype),
                  torch.zeros(n, dtype=dtype)])
    for e in extra:
        H = torch.cat([H, e[0][..., None]], dim=-1)
        g, lo, hi, x0 = (torch.cat([a, b[:, None]], dim=-1)
                         for a, b in zip((g, lo, hi, x0), e[1:]))
    return H, g, lo, hi, x0


def _bits(a):
    """``a``'s bit pattern, so that equal NaNs compare equal."""
    if not a.is_floating_point():
        return a
    return a.contiguous().view({torch.float32: torch.int32,
                                torch.float64: torch.int64}[a.dtype])


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", ["vertical", "cart-pole"])
def test_ls_block_does_not_change_the_result(model, dtype, config):
    """``boxqp_stacked`` at every ``ls_block`` of LS_BLOCKS: x, ok, free
    and the factor bit for bit, and the same QP iterations per lane, as
    at ls_block = 1 (the sequential search)."""
    qp = _planted(model, dtype)
    n_ls = CONFIGS[config].max_ls_iter + 1
    runs = {}
    for block in LS_BLOCKS:
        cfg = dataclasses.replace(CONFIGS[config], ls_block=block)
        stats = {}
        x, ok, free, L, _ = boxqp_stacked(*qp, cfg, stats=stats)
        runs[block] = (x, ok, free, L, stats["qp_iters"])
    ref = runs[1]
    for block, out in runs.items():
        for name, a, b in zip(("x", "ok", "free", "L", "qp_iters"), ref,
                              out):
            assert torch.equal(_bits(a), _bits(b)), (block, name)
    stats = {}
    boxqp_stacked(*qp, CONFIGS[config], stats=stats)
    # the NaN lane visits the whole schedule (min_step = 0) or stops at
    # the first step below 1e-22, 0.6^100 (default); LONG_QP iterates 7
    # times
    assert int(stats["ls_candidates"][-1]) == (
        n_ls if config == "min_step=0" else 101)
    assert bool(ref[1][-1]) and bool(torch.isnan(ref[0][:, -1]).all())
    if qp[1].shape[0] == 2:
        assert int(stats["qp_iters"][-2]) == 7
    assert int(stats["ls_evals"].max()) > 16   # blocks past the first


_HARNESS = r"""
// boxqp.cuh on the host: a 32-thread warp is 32 std::threads that meet at
// each warp exchange (__any_sync, __ballot_sync, __shfl_sync over the
// whole warp, as boxqp's LaneGroup issues them) at a barrier; a thread
// that reached another exchange, or named another mask, would hang or
// stop the run.
#include <barrier>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
using std::fabs;
using std::isfinite;
using std::sqrt;
#define __device__
#define __host__
#define __forceinline__ inline
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
thread_local Dim3 threadIdx;
static std::barrier<> g_warp(32);
static int g_votes[32];
static unsigned long long g_slots[32];
inline void __syncthreads() {}
inline int __ffs(int v) { return __builtin_ffs(v); }
static void whole_warp(unsigned mask) {
  if (mask != 0xffffffffu) {
    std::fprintf(stderr, "thread %u: mask %08x\n", threadIdx.x, mask);
    std::exit(3);
  }
}
inline unsigned __ballot_sync(unsigned mask, int pred) {
  whole_warp(mask);
  g_votes[threadIdx.x] = pred != 0;
  g_warp.arrive_and_wait();
  unsigned bits = 0;
  for (int t = 0; t < 32; ++t)
    if (g_votes[t]) bits |= 1u << t;
  g_warp.arrive_and_wait();
  return bits;
}
inline bool __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0u;
}
template <typename T>
T __shfl_sync(unsigned mask, T v, int src, int width) {
  whole_warp(mask);
  std::memcpy(&g_slots[threadIdx.x], &v, sizeof(T));
  g_warp.arrive_and_wait();
  T out;
  const int from = (static_cast<int>(threadIdx.x) & ~(width - 1)) +
                   src % width;
  std::memcpy(&out, &g_slots[from], sizeof(T));
  g_warp.arrive_and_wait();
  return out;
}
#include "boxqp.cuh"

// in: per lane H (NU*NU), g, lo, hi, x0 (NU each); out: per rank and lane
// x (NU), ok, free (NU), L (NU*NU)
template <typename T, int NU, int G>
void run(int lanes, const nmpc::BoxQPParams& p, const T* in, T* out) {
  constexpr int kIn = NU * NU + 4 * NU, kOut = 2 * NU + 1 + NU * NU;
  std::vector<T> steps(p.max_ls_iter + 1);
  nmpc::fill_step_table<T>(steps.data(), p);
  std::vector<std::thread> warp;
  for (unsigned t = 0; t < 32; ++t) {
    warp.emplace_back([&, t] {
      threadIdx.x = t;
      for (int blk = 0; blk * (32 / G) < lanes; ++blk) {
        // a slot past the end runs the last lane and stores nothing, as
        // the kernels' ragged last block does
        const int slot = blk * (32 / G) + static_cast<int>(t) / G;
        const int b = slot < lanes ? slot : lanes - 1;
        const T* q = in + static_cast<size_t>(b) * kIn;
        T H[NU][NU], g[NU], lo[NU], hi[NU], x0[NU], x[NU], fr[NU], L[NU][NU];
        for (int a = 0; a < NU; ++a) {
          for (int c = 0; c < NU; ++c) H[a][c] = q[a * NU + c];
          g[a] = q[NU * NU + a];
          lo[a] = q[NU * NU + NU + a];
          hi[a] = q[NU * NU + 2 * NU + a];
          x0[a] = q[NU * NU + 3 * NU + a];
        }
        const bool ok = nmpc::boxqp<T, NU, G>(H, g, lo, hi, x0, p,
                                               steps.data(), x, fr, L);
        if (slot >= lanes) continue;
        T* o = out + (static_cast<size_t>(t % G) * lanes + b) * kOut;
        for (int a = 0; a < NU; ++a) {
          o[a] = x[a];
          o[NU + 1 + a] = fr[a];
          for (int c = 0; c < NU; ++c) o[2 * NU + 1 + a * NU + c] = L[a][c];
        }
        o[NU] = ok ? T(1) : T(0);
      }
    });
  }
  for (auto& th : warp) th.join();
}

template <typename T, int NU>
void dispatch_group(int G, int lanes, const nmpc::BoxQPParams& p,
                    const T* in, T* out) {
  switch (G) {
    case 1: return run<T, NU, 1>(lanes, p, in, out);
    case 4: return run<T, NU, 4>(lanes, p, in, out);
    case 8: return run<T, NU, 8>(lanes, p, in, out);
    case 16: return run<T, NU, 16>(lanes, p, in, out);
  }
  std::exit(2);
}

template <typename T>
int main_t(int nu, int G, int lanes, const nmpc::BoxQPParams& p,
           const char* in_path, const char* out_path) {
  const size_t n_in = static_cast<size_t>(lanes) * (nu * nu + 4 * nu);
  const size_t n_out = static_cast<size_t>(G) * lanes * (2 * nu + 1 + nu * nu);
  std::vector<T> in(n_in), out(n_out);
  FILE* f = std::fopen(in_path, "rb");
  if (!f || std::fread(in.data(), sizeof(T), n_in, f) != n_in) return 4;
  std::fclose(f);
  if (nu == 1) dispatch_group<T, 1>(G, lanes, p, in.data(), out.data());
  else if (nu == 2) dispatch_group<T, 2>(G, lanes, p, in.data(), out.data());
  else return 2;
  f = std::fopen(out_path, "wb");
  if (!f || std::fwrite(out.data(), sizeof(T), n_out, f) != n_out) return 5;
  std::fclose(f);
  return 0;
}

// boxqp_host float|double nu G lanes in out max_iter max_ls_iter grad_thre
//   rel_improve_thre step_factor min_step armijo_param
int main(int argc, char** argv) {
  if (argc != 14) return 1;
  const nmpc::BoxQPParams p{std::atoi(argv[7]), std::atoi(argv[8]),
                            std::strtod(argv[9], nullptr),
                            std::strtod(argv[10], nullptr),
                            std::strtod(argv[11], nullptr),
                            std::strtod(argv[12], nullptr),
                            std::strtod(argv[13], nullptr)};
  const int nu = std::atoi(argv[2]), G = std::atoi(argv[3]),
            lanes = std::atoi(argv[4]);
  if (std::strcmp(argv[1], "float") == 0)
    return main_t<float>(nu, G, lanes, p, argv[5], argv[6]);
  return main_t<double>(nu, G, lanes, p, argv[5], argv[6]);
}
"""


@pytest.fixture(scope="module")
def boxqp_host(tmp_path_factory):
    """The harness executable: ``boxqp.cuh`` built by g++ as host code,
    without contraction (the kernels' ``-fmad=false``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ on PATH")
    d = tmp_path_factory.mktemp("boxqp_host")
    (d / "boxqp_host.cpp").write_text(_HARNESS)
    exe = d / "boxqp_host"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-pthread", f"-I{CSRC}", "-o", str(exe),
                    str(d / "boxqp_host.cpp")], check=True,
                   capture_output=True, timeout=600)
    return exe


def _host_run(exe, qp, config, group, workdir: Path):
    """(x, ok, free, L) of every lane from the harness with ``group``
    threads per lane, after asserting that every thread of a group ended
    with the same bits."""
    H, g, lo, hi, x0 = qp
    n, S = g.shape
    dtype = g.dtype
    lanes = torch.cat([H.reshape(n * n, S), g, lo, hi, x0]).T.contiguous()
    inp, outp = workdir / f"in{group}.bin", workdir / f"out{group}.bin"
    inp.write_bytes(lanes.numpy().tobytes())
    cfg = config
    subprocess.run([str(exe), "float" if dtype == torch.float32 else
                    "double", str(n), str(group), str(S), str(inp),
                    str(outp), str(cfg.max_iter), str(cfg.max_ls_iter)]
                   + [repr(float(v)) for v in (
                       cfg.grad_thre, cfg.rel_improve_thre, cfg.step_factor,
                       cfg.min_step, cfg.armijo_param)],
                   check=True, timeout=300)
    out = torch.from_numpy(np.frombuffer(
        outp.read_bytes(), dtype=np.float32 if dtype == torch.float32
        else np.float64).copy()).reshape(group, S, 2 * n + 1 + n * n)
    for rank in range(1, group):
        assert torch.equal(_bits(out[rank]), _bits(out[0])), rank
    o = out[0].T
    return (o[:n], o[n] != 0, o[n + 1:2 * n + 1],
            o[2 * n + 1:].reshape(n, n, S))


def _exact_sqrt(a):
    """A correctly rounded sqrt (numpy's), as the card's and the host
    build's; torch's vectorized CPU sqrt is not, at fp32 or fp64."""
    return torch.from_numpy(np.sqrt(a.numpy()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", ["vertical", "cart-pole"])
def test_group_qp_as_host_cpp(boxqp_host, tmp_path, monkeypatch, model,
                              dtype):
    """``boxqp.cuh``'s group QP on the host at G = 1, 4, 8, 16 and both
    configurations: the group's threads agree bit for bit, every G equals
    G = 1 bit for bit, and G = 1 equals the plain ``boxqp_stacked`` (x,
    ok, free, L) run with a correctly rounded sqrt."""
    qp = _planted(model, dtype)
    for name, config in CONFIGS.items():
        runs = {G: _host_run(boxqp_host, qp, config, G, tmp_path)
                for G in GROUPS}
        for G, out in runs.items():
            for field, a, b in zip(("x", "ok", "free", "L"), runs[1], out):
                assert torch.equal(_bits(a), _bits(b)), (name, G, field)
        with monkeypatch.context() as m:
            m.setattr(torch, "sqrt", _exact_sqrt)
            x, ok, free, L, _ = boxqp_stacked(*qp, config)
        # equal values; a NaN's sign is the platform's (x86 makes -NaN)
        for field, a, b in zip(("x", "ok", "free", "L"), (x, ok, free, L),
                               runs[1]):
            torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True,
                                       msg=(name, field))
