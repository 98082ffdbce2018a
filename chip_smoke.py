#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nmpc_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--layers]

Phases, one line each (a failed phase exits non-zero):

1. build: generate the cart-pole's remat backward (K5) and rollout
   (K6, K7) units for fp32 and fp64 from its callables, then compile them
   and ``csrc/ddp_backward.cu`` (K1) with nvcc, all at once; print the
   seconds and ptxas' registers and spills;
2. kernels: hold each kernel against its plain PyTorch version on the
   card at the headline shape (B=4096, N=100) and the tick shape (B=256,
   N=200), fp32 and fp64: K1 on the stage derivatives of a rollout, K5 on
   the rollout itself (both regularization types), each with one non-PD
   lane and one NaN lane; K6 and K7 with gains from a real backward pass;
   and whether K7's column for an alpha equals K6's sum bit for bit;
3. end to end: ``DDPSolver.solve_batch`` at the headline shape through
   the sweep-fed path (``backward_impl="pallas"``, ``forward_impl="scan"``:
   K1) and through ``auto`` (on the card: remat + fused, K5/K6/K7), each
   with the launch counters reset just before and read just after; a
   mixed batch at fp64 and fp32 against the plain path; fp64 ``solve``s
   through both paths against the NumPy golden DDP;
4. serving: ``make_closed_loop_batch`` with 256 controllers, N=200,
   3 iterations, 20 ticks, through the fused path;
5. times on the card: each kernel and its plain version (CUDA events),
   solves/s and tick p50/p99 for each (backward, forward) pair;
6. with ``--layers`` only: where one solve's time goes at both shapes,
   for each pair (synced time per solver layer, the device's busy time and
   launches from ``torch.profiler``).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from golden.cartpole_numpy import CartPoleGolden  # noqa: E402
from golden.ddp_numpy import GoldenConfig, GoldenDDP  # noqa: E402
from nmpc_tpu_torch import DDPConfig, DDPSolver, DDPStatus  # noqa: E402
from nmpc_tpu_torch.kernels import build as kbuild  # noqa: E402
from nmpc_tpu_torch.kernels import ddp_backward_remat as remat  # noqa: E402
from nmpc_tpu_torch.kernels import ddp_forward_remat as fwd  # noqa: E402
from nmpc_tpu_torch.kernels.ddp_backward import (  # noqa: E402
    StackedDerivs, backward_stacked)
from nmpc_tpu_torch.kernels.ddp_backward_fused import backward_fused  # noqa: E402
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem  # noqa: E402
from nmpc_tpu_torch.mpc.closed_loop import make_closed_loop_batch  # noqa: E402
from nmpc_tpu_torch.solvers import ddp as ddp_mod  # noqa: E402
from nmpc_tpu_torch.solvers.stages import _stage_derivs_sweep  # noqa: E402

DT = 0.01
HEADLINE = (4096, 100)   # (B, N): bench.py's cart-pole shape
TICK = (256, 200)        # (B, N): the 256-controller tick loop
# Kernel vs plain version, normalized max|a-b| / (1 + max|a|) over the
# lanes both call ok (benchmarks/parity_gate.py:61 for fp32; fp64 differs
# only by FMA contraction, summation order and the math library).
KERNEL_TOL = {torch.float32: 2e-4, torch.float64: 1e-10}
# End-to-end fp32 contract (benchmarks/parity_gate.py:72-73).
E2E_U_NORM, E2E_COST_REL = 1e-2, 1e-4
GOLDEN_TOL = 1e-8
# (backward_impl, forward_impl) pairs that are timed; "auto" resolves to
# the last on the card.
PAIRS = (("pallas", "scan"), ("pallas", "fused"), ("remat", "fused"))


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its wrapper (which counts launches), where
    it lives and which TPU kernel it replaces."""

    name: str
    wrapper: object
    source: str
    replaces: str
    max_abs_err: float = 0.0
    launches: int = 0
    ms: float = math.nan
    plain_ms: float = math.nan


KERNELS = {
    "K1": Kernel("ddp_backward_fused", backward_fused,
                 "nmpc_tpu_torch/csrc/ddp_backward.cu",
                 "nmpc_tpu/kernels/ddp_backward_pallas.py:867"),
    "K5": Kernel("backward_remat", remat.backward_remat,
                 "nmpc_tpu_torch/csrc/ddp_backward_remat.cuh",
                 "nmpc_tpu/kernels/ddp_backward_remat.py:369"),
    "K6": Kernel("forward_selected_remat", fwd.forward_selected_remat,
                 "nmpc_tpu_torch/csrc/ddp_forward_remat.cuh",
                 "nmpc_tpu/kernels/ddp_forward_remat.py:285"),
    "K7": Kernel("forward_costs_remat", fwd.forward_costs_remat,
                 "nmpc_tpu_torch/csrc/ddp_forward_remat.cuh",
                 "nmpc_tpu/kernels/ddp_forward_remat.py:334"),
}
REMAT_PATH = ("K5", "K6", "K7")


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def reset_counts():
    for k in KERNELS.values():
        k.wrapper.launches = 0


def read_counts():
    return {key: k.wrapper.launches for key, k in KERNELS.items()}


def card_line() -> str:
    """``name, power.limit`` of card 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def hanging_inputs(B, N, dtype, device, seed=0, us_scale=0.0):
    """x0s near the hanging pose and an input guess, made from a seed."""
    rng = np.random.default_rng(seed)
    x0s = (np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
           + 0.05 * rng.normal(size=(B, 4)))
    us0 = us_scale * rng.normal(size=(B, N, 1))
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return as_t(x0s), as_t(us0)


def rollout(B, N, dtype, device):
    """A cart-pole rollout at t0=0.3: (problem, t0, xs, us, Vx_T, Vxx_T),
    batch-minor and contiguous."""
    problem = make_cartpole_problem(DT)
    config = DDPConfig(horizon_steps=N)
    x0s, us0 = hanging_inputs(B, N, dtype, device, seed=1, us_scale=0.2)
    t0 = torch.tensor(0.3, dtype=dtype, device=device)
    us = us0.permute(1, 2, 0).contiguous()
    xs, _ = ddp_mod._rollout_lanes(problem, config, t0, x0s.T.contiguous(),
                                   us)
    VxT, VxxT = (a.contiguous() for a in ddp_mod._terminal_quad_lanes(
        problem, config, t0, xs))
    return problem, t0, xs, us, VxT, VxxT


def rollout_derivs(B, N, dtype, device):
    """K1's input: the stage derivatives of the rollout, with lane 1 made
    non-PD (Luu = -10) and lane 2 NaN-poisoned."""
    problem, t0, xs, us, VxT, VxxT = rollout(B, N, dtype, device)
    D = StackedDerivs(*_stage_derivs_sweep(
        problem, DDPConfig(horizon_steps=N), t0, xs, us)[:7])
    D.Luu[:, :, :, 1] = -10.0
    D.Fx[N // 2, 0, 0, 2] = float("nan")
    return D, VxT, VxxT


def remat_inputs(B, N, dtype, device):
    """K5's input: the rollout with lane 1 made non-PD (a negative definite
    terminal Vxx) and lane 2 NaN-poisoned (a NaN state at stage N/2)."""
    problem, t0, xs, us, VxT, VxxT = rollout(B, N, dtype, device)
    VxxT[:, :, 1] = -1e6 * torch.eye(4, dtype=dtype, device=device)
    xs[N // 2, 1, 2] = float("nan")
    return problem, t0, xs, us, VxT, VxxT


def rollout_refs(B, N, dtype, device):
    """K6/K7's input: the rollout and the gains of a real backward pass,
    and a per-lane alpha."""
    problem, t0, xs, us, VxT, VxxT = rollout(B, N, dtype, device)
    lam = torch.full((B,), 1e-4, dtype=dtype, device=device)
    ks, Ks, _, ok = remat.backward_remat_plain(
        problem, DDPConfig(horizon_steps=N), t0, xs, us, VxT, VxxT, lam)
    check(bool(ok.all()), "the backward pass feeding K6/K7 failed a lane")
    alpha = torch.as_tensor(np.random.default_rng(3).uniform(0.1, 1.0, B),
                            dtype=dtype, device=device)
    return problem, t0, xs, us, ks, Ks, alpha


def norm_err(ref, out, lanes=None):
    """(normalized, absolute) max error of ``out`` vs ``ref`` on ``lanes``."""
    r, o = ref.double(), out.double()
    if lanes is not None:
        r, o = r[..., lanes], o[..., lanes]
    d = (r - o).abs().max().item()
    return d / (1.0 + r.abs().max().item()), d


def cuda_ms(fn, reps=20, inner=1, warmup=2):
    """Median over ``reps`` samples of CUDA-event time per call, each
    sample ``inner`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def ptxas_report(name):
    log = kbuild.BUILD_DIR / f"{name}.log"
    if not log.exists():
        return "cached build"
    return " | ".join(ln.split(":", 1)[-1].strip()
                      for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln)


def phase_build():
    """Generate every unit (tracing runs one at a time), then start one
    nvcc per unit, all together."""
    problem = make_cartpole_problem(DT)
    start = time.perf_counter()
    units = [("ddp_backward", None)]
    for dtype in (torch.float32, torch.float64):
        for mod in (remat, fwd):
            units.append((mod.unit_name(dtype),
                          mod.unit_source(problem, 4, 1, dtype)))
    gen_s = time.perf_counter() - start

    def compile_unit(unit):
        name, text = unit
        if text is None:
            return kbuild.build(name)
        return kbuild.build_generated(name, text)

    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        libs = list(pool.map(compile_unit, units))
    secs = time.perf_counter() - start
    print(f"[build] {len(libs)} units in {secs:.1f} s (generation "
          f"{gen_s:.1f} s): {', '.join(lib.name for lib in libs)}",
          flush=True)
    for name, _ in units:
        print(f"[build] ptxas {name}: {ptxas_report(name)}", flush=True)
    return secs


def report(label, errs, dtype):
    worst = max(e[0] for e in errs.values())
    tol = KERNEL_TOL[dtype]
    text = " ".join(f"{k} {v[0]:.3e}" for k, v in errs.items())
    print(f"[kernel] {label}: norm err {text} (tol {tol:g})", flush=True)
    check(worst <= tol, f"{label}: kernel vs plain error {worst:.3e} > "
          f"{tol:g}")
    return max(e[1] for e in errs.values())


def check_ok(label, ref_ok, out_ok, B):
    ok_equal = torch.equal(ref_ok, out_ok)
    print(f"[kernel] {label}: ok lanes {int(out_ok.sum())}/{B}, masks equal "
          f"{ok_equal}", flush=True)
    check(ok_equal, f"{label}: kernel and plain ok masks differ")
    check(not bool(out_ok[1]) and not bool(out_ok[2]),
          f"{label}: the non-PD and NaN lanes must fail")
    check(int(out_ok.sum()) == B - 2, f"{label}: a clean lane failed")


def phase_kernels(device):
    """Each kernel vs its plain version at both shapes and dtypes."""
    for B, N in (HEADLINE, TICK):
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            D, VxT, VxxT = rollout_derivs(B, N, dtype, device)
            inputs = remat_inputs(B, N, dtype, device)
            for reg_type, lam_val in ((1, 1e-4), (2, 0.5)):
                cfg = DDPConfig(horizon_steps=N, reg_type=reg_type)
                lam = torch.full((B,), lam_val, dtype=dtype, device=device)
                label = f"B={B} N={N} {dname} reg_type={reg_type}"
                plain = backward_stacked(cfg, D, VxT, VxxT, lam)
                out = backward_fused(cfg, D, VxT, VxxT, lam)
                torch.cuda.synchronize()
                check_ok(f"K1 {label}", plain[3], out[3], B)
                err = report(f"K1 {label}", {
                    n: norm_err(a, b, plain[3]) for n, a, b in
                    zip(("ks", "Ks", "dV"), plain, out)}, dtype)
                KERNELS["K1"].max_abs_err = max(KERNELS["K1"].max_abs_err,
                                                err)
                plain = remat.backward_remat_plain(inputs[0], cfg,
                                                   *inputs[1:], lam)
                out = remat.backward_remat(inputs[0], cfg, *inputs[1:], lam)
                torch.cuda.synchronize()
                check_ok(f"K5 {label}", plain[3], out[3], B)
                err = report(f"K5 {label}", {
                    n: norm_err(a, b, plain[3]) for n, a, b in
                    zip(("ks", "Ks", "dV"), plain, out)}, dtype)
                KERNELS["K5"].max_abs_err = max(KERNELS["K5"].max_abs_err,
                                                err)

            problem, t0, xs, us, ks, Ks, alpha = rollout_refs(B, N, dtype,
                                                              device)
            cfg = DDPConfig(horizon_steps=N)
            label = f"B={B} N={N} {dname}"
            plain = ddp_mod._forward_selected_lanes(problem, cfg, t0, xs, us,
                                                    ks, Ks, alpha, dtype)
            out = fwd.forward_selected_remat(problem, cfg, t0, xs, us, ks, Ks,
                                             alpha)
            torch.cuda.synchronize()
            err = report(f"K6 {label}", {
                n: norm_err(a, b) for n, a, b in
                zip(("xs", "us", "costs", "sum"), plain, out)}, dtype)
            KERNELS["K6"].max_abs_err = max(KERNELS["K6"].max_abs_err, err)
            alphas = torch.tensor(cfg.alpha_list, dtype=dtype, device=device)
            plain = ddp_mod._forward_costs_lanes(problem, cfg, t0, xs, us,
                                                 ks, Ks, alphas, dtype)
            out = fwd.forward_costs_remat(problem, cfg, t0, xs, us, ks, Ks,
                                          alphas)
            torch.cuda.synchronize()
            err = report(f"K7 {label}", {"sums": norm_err(plain, out)},
                         dtype)
            KERNELS["K7"].max_abs_err = max(KERNELS["K7"].max_abs_err, err)
            same = []
            for j in range(len(cfg.alpha_list)):
                sel = fwd.forward_selected_remat(
                    problem, cfg, t0, xs, us, ks, Ks,
                    alphas[j].expand(B).contiguous())[3]
                same.append(torch.equal(out[j], sel))
            print(f"[kernel] K7 vs K6 {label}: alpha columns equal to K6's "
                  f"sum bit for bit: {sum(same)}/{len(same)}", flush=True)


def e2e_compare(a, b):
    """(status equal, iters equal, u normalized diff, cost relative diff),
    as benchmarks/parity_gate.py::_e2e_ddp_compare."""
    st = torch.equal(a.status, b.status)
    it = torch.equal(a.iters, b.iters)
    ua, ub = a.us.double(), b.us.double()
    du = ((ua - ub).abs().max() / (1.0 + ua.abs().max())).item()
    ca, cb = a.costs.double().sum(1), b.costs.double().sum(1)
    dc = ((ca - cb).abs() / (1.0 + ca.abs())).max().item()
    return st, it, du, dc


def decision_flips(a, b, cost_update_thre):
    """Each lane whose status or iterations differ between results ``a``
    and ``b``: the iteration where they part, both runs' cost update there
    and the threshold, in ulp of the lane's cost."""
    lanes = ((a.status != b.status) | (a.iters != b.iters)).nonzero()
    out = []
    for lane in lanes.flatten().tolist():
        j = int(min(a.iters[lane], b.iters[lane]))
        cost = a.trace.cost[lane, j].cpu().numpy()
        ulp = float(np.spacing(np.abs(cost)))
        upd = [float(r.trace.cost_update_actual[lane, j]) / ulp
               for r in (a, b)]
        out.append(f"lane {lane} iteration {j}: status {int(a.status[lane])}"
                   f"/{int(b.status[lane])}, cost update {upd[0]:.2f}/"
                   f"{upd[1]:.2f} ulp vs threshold "
                   f"{cost_update_thre / ulp:.2f} ulp")
    return out


def solve_counted(problem, cfg, x0s, us0):
    """One solve_batch with every launch counter reset just before and
    read just after."""
    solver = DDPSolver(problem, cfg)
    reset_counts()
    res = solver.solve_batch(0.0, x0s, us0)
    torch.cuda.synchronize()
    return res, read_counts(), solver.host_syncs


def phase_e2e(device):
    """The main paths at the headline shape: the sweep-fed one (K1) and
    ``auto`` (K5, K6, K7); the mixed batch; both against the golden."""
    B, N = HEADLINE
    problem = make_cartpole_problem(DT)
    cfg = DDPConfig(horizon_steps=N, max_iter=10)
    x0s, us0 = hanging_inputs(B, N, torch.float32, device)
    k1, k1_counts, k1_syncs = solve_counted(problem, dataclasses.replace(
        cfg, backward_impl="pallas", forward_impl="scan"), x0s, us0)
    res, counts, syncs = solve_counted(problem, cfg, x0s, us0)
    KERNELS["K1"].launches = k1_counts["K1"]
    for key in REMAT_PATH:
        KERNELS[key].launches = counts[key]
    st, it, du, dc = e2e_compare(res, k1)
    finite = bool(torch.isfinite(res.us).all() and torch.isfinite(res.xs).all())
    n_status = torch.bincount(res.status, minlength=5).tolist()
    print(f"[e2e] solve_batch B={B} N={N} max_iter=10 fp32: (pallas, scan) "
          f"launches {k1_counts}, host syncs {k1_syncs}; auto launches "
          f"{counts}, host syncs {syncs}, status counts {n_status}; auto vs "
          f"(pallas, scan): status equal {st}, iters equal {it}, u norm diff "
          f"{du:.3e} (tol {E2E_U_NORM:g}), cost rel diff {dc:.3e} (tol "
          f"{E2E_COST_REL:g})", flush=True)
    check(k1_counts["K1"] > 0, "the (pallas, scan) solve did not launch K1")
    check(all(counts[key] > 0 for key in REMAT_PATH),
          "the auto solve did not launch K5, K6 and K7")
    check(counts["K1"] == 0, "the auto solve ran the sweep-fed kernel")
    check(finite, "non-finite solve output")
    check(st and it and du <= E2E_U_NORM and dc <= E2E_COST_REL,
          "end-to-end contract vs (pallas, scan) failed")

    # A batch whose lanes stop at different iterations, so that a flipped
    # accept or termination decision shows: lanes started near upright
    # succeed within the 10 iterations, lanes near hanging run out of them.
    # At fp64 the full contract holds.  At fp32 a lane whose last cost
    # update lands within an ulp or two of cost_update_thre (for_fp32():
    # 1.2e-4, 4 ulp of a cost near 300) terminates on rounding alone, so
    # such flips are listed with the update in ulp of the lane's cost, and
    # u and cost are held to the contract.
    x0m = x0s.clone()
    x0m[B // 2:, 1] -= math.pi
    plain_pair = {"backward_impl": "stacked", "forward_impl": "scan"}
    for dtype, mcfg in ((torch.float64, cfg), (torch.float32, cfg.for_fp32())):
        mixed = {
            name: DDPSolver(problem, dataclasses.replace(mcfg, **kw))
            .solve_batch(0.0, x0m.to(dtype), us0.to(dtype))
            for name, kw in (("auto", {}), ("plain", plain_pair),
                             ("K1", {"backward_impl": "pallas",
                                     "forward_impl": "scan"}))}
        for other in ("plain", "K1"):
            st, it, du, dc = e2e_compare(mixed["auto"], mixed[other])
            n_status = torch.bincount(mixed["auto"].status,
                                      minlength=5).tolist()
            flips = decision_flips(mixed["auto"], mixed[other],
                                   mcfg.cost_update_thre)
            print(f"[e2e] mixed batch B={B} N={N} max_iter=10 "
                  f"{str(dtype)[6:]}"
                  f"{' for_fp32()' if dtype == torch.float32 else ''}, half "
                  f"near upright: status counts {n_status}; auto vs "
                  f"{other}: status equal {st}, iters equal {it}, u norm "
                  f"diff {du:.3e}, cost rel diff {dc:.3e}; lanes that "
                  f"differ: {'; '.join(flips) or 'none'}", flush=True)
            check(n_status[DDPStatus.SUCCEEDED] > 0
                  and n_status[DDPStatus.MAX_ITER_REACHED] > 0,
                  "the mixed batch must hold finished and unfinished lanes")
            check(du <= E2E_U_NORM and dc <= E2E_COST_REL,
                  f"mixed batch: u or cost vs {other} out of the contract")
            if dtype == torch.float64:
                check(st and it, f"mixed batch fp64: status or iters differ "
                      f"from {other}")

    golden = GoldenDDP(CartPoleGolden(DT),
                       GoldenConfig(horizon_steps=N, max_iter=50))
    x0 = np.array([0.0, np.pi, 0.0, 0.0])
    g = golden.solve(0.0, x0, np.zeros((N, 1)))
    # B=1 on ls_mode "auto" accepts alpha[0] by the head path (K6) in
    # every iteration here, so the sweep kernel (K7) need not run.
    for label, keys, kw in (
            ("auto", ("K5", "K6"), {}),
            ("(pallas, scan)", ("K1",), {"backward_impl": "pallas",
                                         "forward_impl": "scan"})):
        solver64 = DDPSolver(problem, DDPConfig(horizon_steps=N, max_iter=50,
                                                **kw))
        reset_counts()
        r64 = solver64.solve(0.0, torch.as_tensor(x0, device=device),
                             torch.zeros((N, 1), dtype=torch.float64,
                                         device=device))
        torch.cuda.synchronize()
        got = read_counts()
        du = np.abs(r64.us.cpu().numpy() - g["us"]).max()
        dx = np.abs(r64.xs.cpu().numpy() - g["xs"]).max()
        iters = int(r64.iters)
        print(f"[e2e] fp64 solve {label} vs NumPy golden: status "
              f"{DDPStatus(int(r64.status)).name} / {g['status']}, iters "
              f"{iters} / {g['iters']}, max|du| {du:.3e}, max|dx| {dx:.3e} "
              f"(tol {GOLDEN_TOL:g}), launches {got}", flush=True)
        check(g["status"] == "succeeded"
              and int(r64.status) == DDPStatus.SUCCEEDED,
              f"fp64 solve {label} failed")
        check(iters == g["iters"],
              f"fp64 solve {label}: iteration count differs from golden")
        check(du <= GOLDEN_TOL and dx <= GOLDEN_TOL,
              f"fp64 solve {label} vs golden")
        check(all(got[key] > 0 for key in keys),
              f"fp64 solve {label} skipped a kernel")


def tick_loop(device, problem, impls, n_ticks=20):
    """Tick times (ms) of the 256-controller loop on one (backward,
    forward) pair, each tick from the start of one solve to the start of
    the next, each reading after a device synchronize; and the log.  The
    first solve of a problem object generates its kernel units (a trace
    and a cached library lookup), so warm-up and timed loops share one
    problem."""
    B, N = TICK
    stamps = []

    class TickClock(DDPSolver):
        def solve_batch(self, t0, x0s, us_inits):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return super().solve_batch(t0, x0s, us_inits)

    cfg = DDPConfig(horizon_steps=N, max_iter=3, backward_impl=impls[0],
                    forward_impl=impls[1])
    solver = TickClock(problem, cfg)
    x0s, us0 = hanging_inputs(B, N, torch.float32, device)
    log = make_closed_loop_batch(solver, n_steps=n_ticks)(0.0, x0s, us0)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    ms = np.diff(stamps) * 1e3
    check(len(ms) == n_ticks, "one clock reading per tick expected")
    return ms, log


def phase_serving(device, card):
    B, N = TICK
    reset_counts()
    ms, log = tick_loop(device, make_cartpole_problem(DT), ("auto", "auto"))
    counts = read_counts()
    finite = bool(torch.isfinite(log.xs).all() and torch.isfinite(log.us).all())
    print(f"[serving] {B} controllers N={N} max_iter=3 fp32 auto, {len(ms)} "
          f"ticks: tick p50 {np.percentile(ms, 50):.2f} ms, p99 "
          f"{np.percentile(ms, 99):.2f} ms, first {ms[0]:.2f} ms; launches "
          f"{counts}; all finite {finite} [{card}]", flush=True)
    check(finite, "a controller went non-finite")
    check(all(counts[key] > 0 for key in REMAT_PATH),
          "the tick loop skipped a kernel of the fused path")


def moved_bytes(key, B, N, itemsize, A=11):
    """Bytes a kernel must move at (B, N): its inputs read once and its
    outputs written once."""
    nx, nu = 4, 1
    traj = (N + 1) * nx + N * nu                 # xs, us per lane
    gains = N * nu + N * nu * nx                 # ks, Ks per lane
    if key == "K1":
        fields = nx * nx * 2 + nx * nu * 2 + nx + nu + nu * nu
        return itemsize * B * (N * fields + gains + nx + nx * nx + 3) + B
    if key == "K5":
        return itemsize * B * (traj + gains + nx + nx * nx + 3) + B
    if key == "K6":
        return itemsize * B * (2 * traj + gains + (N + 1) + 2)
    return itemsize * (B * (traj + gains) + A + A * B)


def phase_times(device, card):
    """Each kernel vs its plain version per call (CUDA events), then
    solves/s and tick p50/p99 for each (backward, forward) pair."""
    for B, N in (HEADLINE, TICK):
        dtype = torch.float32
        cfg = DDPConfig(horizon_steps=N)
        lam = torch.full((B,), 1e-4, device=device)
        D, VxT, VxxT = rollout_derivs(B, N, dtype, device)
        problem, t0, xs, us, VxT5, VxxT5 = rollout(B, N, dtype, device)
        _, _, _, _, ks, Ks, alpha = rollout_refs(B, N, dtype, device)
        alphas = torch.tensor(cfg.alpha_list, device=device)
        calls = {
            "K1": (lambda: backward_fused(cfg, D, VxT, VxxT, lam),
                   lambda: backward_stacked(cfg, D, VxT, VxxT, lam)),
            "K5": (lambda: remat.backward_remat(problem, cfg, t0, xs, us,
                                                VxT5, VxxT5, lam),
                   lambda: remat.backward_remat_plain(problem, cfg, t0, xs,
                                                      us, VxT5, VxxT5, lam)),
            "K6": (lambda: fwd.forward_selected_remat(problem, cfg, t0, xs,
                                                      us, ks, Ks, alpha),
                   lambda: ddp_mod._forward_selected_lanes(
                       problem, cfg, t0, xs, us, ks, Ks, alpha, dtype)),
            "K7": (lambda: fwd.forward_costs_remat(problem, cfg, t0, xs, us,
                                                   ks, Ks, alphas),
                   lambda: ddp_mod._forward_costs_lanes(
                       problem, cfg, t0, xs, us, ks, Ks, alphas, dtype)),
        }
        for key, (kernel, plain) in calls.items():
            t_kern = cuda_ms(kernel, inner=10)
            t_plain = cuda_ms(plain, reps=5)
            nbytes = moved_bytes(key, B, N, 4)
            gbs = nbytes / (t_kern * 1e-3) / 1e9
            print(f"[times] {key} {KERNELS[key].name} B={B} N={N} fp32: "
                  f"kernel {t_kern:.4f} ms ({gbs:.1f} GB/s of "
                  f"{nbytes / 1e6:.2f} MB), plain {t_plain:.3f} ms [{card}]",
                  flush=True)
            if (B, N) == HEADLINE:
                KERNELS[key].ms, KERNELS[key].plain_ms = t_kern, t_plain

    B, N = HEADLINE
    problem = make_cartpole_problem(DT)
    x0s, us0 = hanging_inputs(B, N, torch.float32, device)
    for pair in PAIRS:
        solver = DDPSolver(problem, DDPConfig(
            horizon_steps=N, max_iter=10, backward_impl=pair[0],
            forward_impl=pair[1]))
        solver.solve_batch(0.0, x0s, us0)
        torch.cuda.synchronize()
        secs = []
        for _ in range(10):
            start = time.perf_counter()
            solver.solve_batch(0.0, x0s, us0)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - start)
        print(f"[times] solve_batch B={B} N={N} max_iter=10 fp32 "
              f"backward={pair[0]} forward={pair[1]}: median "
              f"{statistics.median(secs):.4f} s, "
              f"{B / statistics.median(secs):.1f} solves/s, host syncs "
              f"{solver.host_syncs} [{card}]", flush=True)
    for pair in PAIRS:
        tick_loop(device, problem, pair, n_ticks=2)   # warm-up
        ms, _ = tick_loop(device, problem, pair)
        print(f"[times] tick loop {TICK[0]} controllers N={TICK[1]} "
              f"max_iter=3 backward={pair[0]} forward={pair[1]}: p50 "
              f"{np.percentile(ms, 50):.2f} ms, p99 "
              f"{np.percentile(ms, 99):.2f} ms [{card}]", flush=True)


LAYERS = ("_rollout_lanes", "_derivative_sweep_lanes", "_terminal_quad_lanes",
          "backward_fused", "backward_stacked", "backward_remat",
          "_forward_selected_lanes", "_forward_costs_lanes",
          "forward_selected_remat", "forward_costs_remat")


@contextlib.contextmanager
def layer_clock(acc, count):
    """Wrap each solver layer in ``LAYERS`` with a device synchronize and
    the host clock on both sides; restore the layers on exit."""
    saved = {name: getattr(ddp_mod, name) for name in LAYERS}

    def timed(name, fn):
        def wrap(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - start
            count[name] += 1
            return out
        return wrap

    for name, fn in saved.items():
        setattr(ddp_mod, name, timed(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ddp_mod, name, fn)


def phase_layers(device, card):
    """Where one solve's time goes, at both shapes, for each (backward,
    forward) pair and the plain path: synced wall time, synced time per
    layer, and the device's busy time and kernel launches from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    problem = make_cartpole_problem(DT)
    for label, (B, N), iters, ls_mode in (("headline", HEADLINE, 10, "auto"),
                                          ("tick", TICK, 3, "sweep")):
        x0s, us0 = hanging_inputs(B, N, torch.float32, device)
        for pair in PAIRS + (("stacked", "scan"),):
            solver = DDPSolver(problem, DDPConfig(
                horizon_steps=N, max_iter=iters, backward_impl=pair[0],
                forward_impl=pair[1], ls_mode=ls_mode))

            def solve():
                solver.solve_batch(0.0, x0s, us0)
                torch.cuda.synchronize()

            solve()
            start = time.perf_counter()
            solve()
            wall = time.perf_counter() - start
            acc, count = collections.defaultdict(float), collections.Counter()
            with layer_clock(acc, count):
                start = time.perf_counter()
                solve()
                synced = time.perf_counter() - start
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                solve()
            events = prof.key_averages()
            busy = sum(e.self_device_time_total for e in events) / 1e3
            launches = sum(e.count for e in events
                           if e.key.startswith("cudaLaunchKernel"))
            parts = ", ".join(f"{name} {acc[name] * 1e3:.1f} ms x{count[name]}"
                              for name in LAYERS if count[name])
            rest = synced - sum(acc.values())
            print(f"[layers] {label} B={B} N={N} max_iter={iters} ls_mode="
                  f"{ls_mode} backward={pair[0]} forward={pair[1]}: wall "
                  f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
                  f"({100 * busy / (wall * 1e3):.1f} %), cudaLaunchKernel "
                  f"{launches}, host syncs {solver.host_syncs}; synced layers "
                  f"(total {synced * 1e3:.1f} ms): {parts}, rest "
                  f"{rest * 1e3:.1f} ms [{card}]", flush=True)
            check(busy > 0, "the profiler saw no device time")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--layers", action="store_true",
                        help="also print where one solve's time goes, per "
                             "layer, with the profiler's device busy time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)
    phases = [("build", phase_build),
              ("kernels", lambda: phase_kernels(device)),
              ("e2e", lambda: phase_e2e(device)),
              ("serving", lambda: phase_serving(device, card)),
              ("times", lambda: phase_times(device, card))]
    if args.layers:
        phases.append(("layers", lambda: phase_layers(device, card)))
    try:
        for name, phase in phases:
            start = time.perf_counter()
            phase()
            print(f"[phase] {name}: {time.perf_counter() - start:.1f} s",
                  flush=True)
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    record = {"kernels": [{
        "name": k.name, "route": "cuda", "source": k.source,
        "replaces": k.replaces, "launches": k.launches,
        "max_abs_err": k.max_abs_err, "ms": k.ms, "plain_ms": k.plain_ms}
        for k in KERNELS.values()]}
    numbers = [v for k in KERNELS.values()
               for v in (k.max_abs_err, k.ms, k.plain_ms)]
    if not all(math.isfinite(v) for v in numbers):
        print("chip_smoke: FAILED: non-finite record", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
