#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nmpc_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--layers]

Phases, one line each (a failed phase exits non-zero):

1. build the CUDA kernels from ``nmpc_tpu_torch/csrc/`` with nvcc;
2. hold each kernel against its plain PyTorch twin on the card, on
   derivative data from a cart-pole rollout at the headline shape
   (B=4096, N=100) and the tick shape (B=256, N=200), fp32 and fp64, both
   regularization types, with one non-PD lane and one NaN lane;
3. end to end: ``DDPSolver.solve_batch`` at the headline shape with
   ``backward_impl="auto"`` (launch counter reset just before, read just
   after), compared with ``"stacked"``; an fp64 ``solve`` against the NumPy
   golden DDP;
4. serving: ``make_closed_loop_batch`` with 256 controllers, N=200,
   3 iterations, 20 ticks;
5. times on the card: kernel vs twin (CUDA events), solves/s with the
   kernel and with the twin;
6. with ``--layers`` only: where one solve's time goes at both shapes,
   with the kernel and with the twin (synced time per solver layer, the
   device's busy time and launches from ``torch.profiler``).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
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
from nmpc_tpu_torch.kernels.ddp_backward import (  # noqa: E402
    StackedDerivs, backward_stacked)
from nmpc_tpu_torch.kernels.ddp_backward_fused import backward_fused  # noqa: E402
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem  # noqa: E402
from nmpc_tpu_torch.mpc.closed_loop import make_closed_loop_batch  # noqa: E402
from nmpc_tpu_torch.solvers import ddp as ddp_mod  # noqa: E402

DT = 0.01
HEADLINE = (4096, 100)   # (B, N): bench.py's cart-pole shape
TICK = (256, 200)        # (B, N): the 256-controller tick loop
# Kernel vs twin, normalized max|a-b| / (1 + max|a|) over the lanes both
# call ok (benchmarks/parity_gate.py:61 for fp32; fp64 differs only by
# FMA contraction and summation order).
KERNEL_TOL = {torch.float32: 2e-4, torch.float64: 1e-10}
# End-to-end fp32 contract (benchmarks/parity_gate.py:72-73).
E2E_U_NORM, E2E_COST_REL = 1e-2, 1e-4
GOLDEN_TOL = 1e-8
KERNEL_SOURCE = "nmpc_tpu_torch/csrc/ddp_backward.cu"
KERNEL_REPLACES = "nmpc_tpu/kernels/ddp_backward_pallas.py:867"


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


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


def rollout_derivs(B, N, dtype, device):
    """Stage derivatives of a cart-pole rollout (batch-minor, contiguous),
    with lane 1 made non-PD (Luu = -10) and lane 2 NaN-poisoned."""
    problem = make_cartpole_problem(DT)
    config = DDPConfig(horizon_steps=N)
    x0s, us0 = hanging_inputs(B, N, dtype, device, seed=1, us_scale=0.2)
    t0 = torch.zeros((), dtype=dtype, device=device)
    us = us0.permute(1, 2, 0).contiguous()
    xs, _ = ddp_mod._rollout_lanes(problem, config, t0, x0s.T.contiguous(),
                                   us)
    D, VxT, VxxT = ddp_mod._derivative_sweep_lanes(problem, config, t0, xs,
                                                   us)
    D = StackedDerivs(*D[:7])
    D.Luu[:, :, :, 1] = -10.0
    D.Fx[N // 2, 0, 0, 2] = float("nan")
    return D, VxT, VxxT


def norm_err(ref, out, lanes):
    """(normalized, absolute) max error of ``out`` vs ``ref`` on ``lanes``."""
    r = ref[..., lanes].double()
    o = out[..., lanes].double()
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


def phase_build():
    start = time.perf_counter()
    lib = kbuild.build("ddp_backward")
    secs = time.perf_counter() - start
    log = kbuild.BUILD_DIR / "ddp_backward.log"
    ptxas = []
    if log.exists():
        ptxas = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
    print(f"[build] {lib.name} in {secs:.1f} s; ptxas: "
          f"{' | '.join(ptxas) or 'cached build'}", flush=True)
    return secs


def phase_kernels(device):
    """Kernel vs twin at both shapes, both dtypes, both reg types."""
    worst_abs = 0.0
    for B, N in (HEADLINE, TICK):
        for dtype in (torch.float32, torch.float64):
            D, VxT, VxxT = rollout_derivs(B, N, dtype, device)
            for reg_type, lam_val in ((1, 1e-4), (2, 0.5)):
                cfg = DDPConfig(horizon_steps=N, reg_type=reg_type)
                lam = torch.full((B,), lam_val, dtype=dtype, device=device)
                twin = backward_stacked(cfg, D, VxT, VxxT, lam)
                kern = backward_fused(cfg, D, VxT, VxxT, lam)
                torch.cuda.synchronize()
                ok_equal = torch.equal(twin[3], kern[3])
                lanes = twin[3]
                errs = {name: norm_err(a, b, lanes)
                        for name, a, b in zip(("ks", "Ks", "dV"), twin, kern)}
                worst = max(e[0] for e in errs.values())
                worst_abs = max(worst_abs, max(e[1] for e in errs.values()))
                tol = KERNEL_TOL[dtype]
                n_ok = int(lanes.sum())
                print(f"[kernel] B={B} N={N} {str(dtype)[6:]} reg_type="
                      f"{reg_type}: norm err ks {errs['ks'][0]:.3e} Ks "
                      f"{errs['Ks'][0]:.3e} dV {errs['dV'][0]:.3e} (tol "
                      f"{tol:g}); ok lanes {n_ok}/{B}, masks equal "
                      f"{ok_equal}", flush=True)
                check(ok_equal, "kernel and twin ok masks differ")
                check(not bool(lanes[1]) and not bool(lanes[2]),
                      "the non-PD and NaN lanes must fail")
                check(n_ok == B - 2, "a clean lane failed")
                check(worst <= tol, f"kernel vs twin error {worst:.3e} > "
                      f"{tol:g}")
    return worst_abs


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


def phase_e2e(device):
    """The main path: solve_batch at the headline shape through the
    kernel, against the twin; an fp64 solve against the golden DDP."""
    B, N = HEADLINE
    problem = make_cartpole_problem(DT)
    cfg = DDPConfig(horizon_steps=N, max_iter=10)
    x0s, us0 = hanging_inputs(B, N, torch.float32, device)
    solver = DDPSolver(problem, cfg)
    backward_fused.launches = 0
    res = solver.solve_batch(0.0, x0s, us0)
    torch.cuda.synchronize()
    launches = backward_fused.launches
    syncs = solver.host_syncs
    ref = DDPSolver(problem, dataclasses.replace(
        cfg, backward_impl="stacked")).solve_batch(0.0, x0s, us0)
    st, it, du, dc = e2e_compare(res, ref)
    finite = bool(torch.isfinite(res.us).all() and torch.isfinite(res.xs).all())
    n_status = torch.bincount(res.status, minlength=5).tolist()
    print(f"[e2e] solve_batch B={B} N={N} max_iter=10 fp32 auto: kernel "
          f"launches {launches}, host syncs {syncs}, status counts "
          f"{n_status}; vs stacked: status equal {st}, iters equal {it}, "
          f"u norm diff {du:.3e} (tol {E2E_U_NORM:g}), cost rel diff "
          f"{dc:.3e} (tol {E2E_COST_REL:g})", flush=True)
    check(launches > 0, "the auto solve did not launch the kernel")
    check(finite, "non-finite solve output")
    check(st and it and du <= E2E_U_NORM and dc <= E2E_COST_REL,
          "end-to-end contract vs stacked failed")

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
    for dtype, mcfg in ((torch.float64, cfg), (torch.float32, cfg.for_fp32())):
        mixed = {impl: DDPSolver(problem, dataclasses.replace(
            mcfg, backward_impl=impl)).solve_batch(
                0.0, x0m.to(dtype), us0.to(dtype))
            for impl in ("auto", "stacked")}
        st, it, du, dc = e2e_compare(mixed["auto"], mixed["stacked"])
        n_status = torch.bincount(mixed["auto"].status, minlength=5).tolist()
        flips = decision_flips(mixed["auto"], mixed["stacked"],
                               mcfg.cost_update_thre)
        print(f"[e2e] mixed batch B={B} N={N} max_iter=10 {str(dtype)[6:]}"
              f"{' for_fp32()' if dtype == torch.float32 else ''}, half "
              f"near upright: status counts {n_status}; auto vs stacked: "
              f"status equal {st}, iters equal {it}, u norm diff {du:.3e}, "
              f"cost rel diff {dc:.3e}; lanes that differ: "
              f"{'; '.join(flips) or 'none'}", flush=True)
        check(n_status[DDPStatus.SUCCEEDED] > 0
              and n_status[DDPStatus.MAX_ITER_REACHED] > 0,
              "the mixed batch must hold finished and unfinished lanes")
        check(du <= E2E_U_NORM and dc <= E2E_COST_REL,
              "mixed batch: u or cost vs stacked out of the contract")
        if dtype == torch.float64:
            check(st and it, "mixed batch fp64: status or iters differ")

    golden = GoldenDDP(CartPoleGolden(DT),
                       GoldenConfig(horizon_steps=N, max_iter=50))
    x0 = np.array([0.0, np.pi, 0.0, 0.0])
    g = golden.solve(0.0, x0, np.zeros((N, 1)))
    solver64 = DDPSolver(problem, DDPConfig(horizon_steps=N, max_iter=50))
    before = backward_fused.launches
    r64 = solver64.solve(0.0, torch.as_tensor(x0, device=device),
                         torch.zeros((N, 1), dtype=torch.float64,
                                     device=device))
    du = np.abs(r64.us.cpu().numpy() - g["us"]).max()
    dx = np.abs(r64.xs.cpu().numpy() - g["xs"]).max()
    iters = int(r64.iters)
    print(f"[e2e] fp64 solve vs NumPy golden: status "
          f"{DDPStatus(int(r64.status)).name} / {g['status']}, iters {iters}"
          f" / {g['iters']}, max|du| {du:.3e}, max|dx| {dx:.3e} (tol "
          f"{GOLDEN_TOL:g}), kernel launches "
          f"{backward_fused.launches - before}", flush=True)
    check(g["status"] == "succeeded"
          and int(r64.status) == DDPStatus.SUCCEEDED, "fp64 solve failed")
    check(iters == g["iters"], "fp64 iteration count differs from golden")
    check(du <= GOLDEN_TOL and dx <= GOLDEN_TOL, "fp64 solve vs golden")
    check(backward_fused.launches > before, "fp64 solve skipped the kernel")
    return launches, syncs


def phase_serving(device, card):
    B, N = TICK
    n_ticks = 20
    problem = make_cartpole_problem(DT)
    stamps = []

    class TickClock(DDPSolver):
        """Reads the host clock, after a device synchronize, as each
        tick's solve starts: consecutive readings bound one tick (solve,
        plant step, warm-start shift)."""

        def solve_batch(self, t0, x0s, us_inits):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return super().solve_batch(t0, x0s, us_inits)

    solver = TickClock(problem, DDPConfig(horizon_steps=N, max_iter=3))
    x0s, us0 = hanging_inputs(B, N, torch.float32, device)
    sim = make_closed_loop_batch(solver, n_steps=n_ticks)
    before = backward_fused.launches
    log = sim(0.0, x0s, us0)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    ms = np.diff(stamps) * 1e3
    check(len(ms) == n_ticks, "one clock reading per tick expected")
    finite = bool(torch.isfinite(log.xs).all() and torch.isfinite(log.us).all())
    print(f"[serving] {B} controllers N={N} max_iter=3 fp32, {n_ticks} "
          f"ticks: tick p50 {np.percentile(ms, 50):.2f} ms, p99 "
          f"{np.percentile(ms, 99):.2f} ms, first {ms[0]:.2f} ms; kernel "
          f"launches {backward_fused.launches - before}; all finite "
          f"{finite} [{card}]", flush=True)
    check(finite, "a controller went non-finite")
    check(backward_fused.launches > before, "tick loop skipped the kernel")


def phase_times(device, card):
    """Kernel vs twin per call, and solves/s with each, on the card."""
    out = {}
    for B, N in (HEADLINE, TICK):
        D, VxT, VxxT = rollout_derivs(B, N, torch.float32, device)
        cfg = DDPConfig(horizon_steps=N)
        lam = torch.full((B,), 1e-4, device=device)
        t_kern = cuda_ms(lambda: backward_fused(cfg, D, VxT, VxxT, lam),
                         inner=10)
        t_twin = cuda_ms(lambda: backward_stacked(cfg, D, VxT, VxxT, lam))
        nx, nu = 4, 1
        fields = nx * nx * 2 + nx * nu * 2 + nx + nu + nu * nu
        nbytes = 4 * (N * B * (fields + nu + nu * nx) + B * (nx + nx * nx
                                                            + 1 + 2)) + B
        gbs = nbytes / (t_kern * 1e-3) / 1e9
        print(f"[times] backward B={B} N={N} fp32: kernel {t_kern:.4f} ms "
              f"({gbs:.1f} GB/s of {nbytes / 1e6:.1f} MB), twin "
              f"{t_twin:.3f} ms [{card}]", flush=True)
        out[(B, N)] = (t_kern, t_twin, gbs)

    B, N = HEADLINE
    problem = make_cartpole_problem(DT)
    x0s, us0 = hanging_inputs(B, N, torch.float32, device)
    rates = {}
    for impl in ("pallas", "stacked"):
        solver = DDPSolver(problem, DDPConfig(horizon_steps=N, max_iter=10,
                                              backward_impl=impl))
        solver.solve_batch(0.0, x0s, us0)
        torch.cuda.synchronize()
        secs = []
        for _ in range(20):
            start = time.perf_counter()
            solver.solve_batch(0.0, x0s, us0)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - start)
        rates[impl] = B / statistics.median(secs)
        print(f"[times] solve_batch B={B} N={N} max_iter=10 fp32 "
              f"backward={impl}: median {statistics.median(secs):.3f} s, "
              f"{rates[impl]:.1f} solves/s, host syncs {solver.host_syncs} "
              f"[{card}]", flush=True)
    return out, rates


LAYERS = ("_rollout_lanes", "_derivative_sweep_lanes", "backward_fused",
          "backward_stacked", "_forward_selected_lanes",
          "_forward_costs_lanes")


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
    """Where one solve's time goes, at both shapes, with the kernel and
    with the twin: synced wall time, synced time per layer, and the
    device's busy time and kernel launches from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    problem = make_cartpole_problem(DT)
    for label, (B, N), iters, ls_mode in (("headline", HEADLINE, 10, "auto"),
                                          ("tick", TICK, 3, "sweep")):
        x0s, us0 = hanging_inputs(B, N, torch.float32, device)
        for impl in ("pallas", "stacked"):
            solver = DDPSolver(problem, DDPConfig(
                horizon_steps=N, max_iter=iters, backward_impl=impl,
                ls_mode=ls_mode))

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
                  f"{ls_mode} backward={impl}: wall {wall * 1e3:.1f} ms, "
                  f"device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}"
                  f" %), cudaLaunchKernel {launches}, host syncs "
                  f"{solver.host_syncs}; synced layers (total "
                  f"{synced * 1e3:.1f} ms): {parts}, rest {rest * 1e3:.1f} ms"
                  f" [{card}]", flush=True)
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
    try:
        phase_build()
        worst_abs = phase_kernels(device)
        launches, _ = phase_e2e(device)
        phase_serving(device, card)
        times, _ = phase_times(device, card)
        if args.layers:
            phase_layers(device, card)
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    t_kern, t_twin, _ = times[HEADLINE]
    record = {"kernels": [{
        "name": "ddp_backward_fused", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": worst_abs,
        "ms": t_kern, "plain_ms": t_twin}]}
    check_finite = all(math.isfinite(v) for v in (worst_abs, t_kern, t_twin))
    if not check_finite:
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
