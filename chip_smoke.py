#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nmpc_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--layers]

Phases, one line each (a failed phase exits non-zero):

1. build: generate the remat backward (K5), boxed remat backward (K5
   boxed) and rollout (K6, K7) units of the cart-pole and the
   vertical-motion model from their callables, and the sweep-fed boxed
   backward (K4) at (nx, nu) = (2, 2) and (4, 1), for fp32 and fp64; then
   compile them and ``csrc/ddp_backward.cu`` (K1) with nvcc, all at once;
   print the seconds and ptxas' registers and spills;
2. kernels: hold each kernel against its plain PyTorch version on the
   card, fp32 and fp64: K1 and K5 at the headline shape (B=4096, N=100)
   and the tick shape (B=256, N=200), each with one non-PD lane and one
   NaN lane; K6 and K7 with gains from a real backward pass, and whether
   K7's column for an alpha equals K6's sum bit for bit; K4 and K5 boxed
   on first-iteration vertical-motion data (B=1024, N=100, across the
   switch to two contacts, both regularization types), with a non-PD, a
   NaN and (K4) a planted long-QP lane, and how many lanes ran the QP's
   iteration and Armijo tails; K4 and K5 boxed on boxed cart-pole data
   (B=4096, N=100, fp32);
3. end to end: ``DDPSolver.solve_batch`` at the headline shape through
   the sweep-fed path (``backward_impl="pallas"``, ``forward_impl="scan"``:
   K1) and through ``auto`` (on the card: remat + fused, K5/K6/K7), each
   with the launch counters reset just before and read just after; a
   mixed batch at fp64 and fp32 against the plain path; fp64 ``solve``s
   through both paths against the NumPy golden DDP; then the boxed solve
   of the vertical-motion model (B=1024, N=100, 3 iterations) and of the
   cart-pole with force limits (B=4096, N=100, 10 iterations) through K4,
   through ``auto`` (K5 boxed + K6/K7) and on the plain path, at fp64 and
   fp32, every first-stage u inside its box (later stages add the
   unclipped feedback K dx and may leave it) and every masked u exactly 0;
4. serving: ``make_closed_loop_batch`` with 256 cart-pole controllers,
   N=200, 3 iterations, 20 ticks, through the fused path; and with 256
   boxed vertical-motion controllers, N=100, 3 iterations, 20 ticks from
   t0=1.8 (the horizon crosses the contact switch), through ``auto``;
5. times on the card: each kernel and its plain version (CUDA events)
   beside its bound, solves/s and tick p50/p99 for each (backward,
   forward) pair, and solves/s of the boxed vertical solve for each pair;
6. with ``--layers`` only: where one solve's time goes at both shapes,
   for each pair, and for the boxed vertical solve (synced time per
   solver layer, the device's busy time and launches from
   ``torch.profiler``).

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
import functools
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
from nmpc_tpu_torch.kernels import tileval  # noqa: E402
from nmpc_tpu_torch.kernels import ddp_backward_boxed as boxed  # noqa: E402
from nmpc_tpu_torch.kernels.ddp_backward import (  # noqa: E402
    StackedBounds, StackedDerivs, backward_stacked, backward_stacked_boxed)
from nmpc_tpu_torch.kernels.ddp_backward_fused import backward_fused  # noqa: E402
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem  # noqa: E402
from nmpc_tpu_torch.models.vertical import (  # noqa: E402
    make_vertical_problem, num_contacts)
from nmpc_tpu_torch.mpc.closed_loop import make_closed_loop_batch  # noqa: E402
from nmpc_tpu_torch.solvers import ddp as ddp_mod  # noqa: E402
from nmpc_tpu_torch.solvers.stages import _stage_derivs_sweep  # noqa: E402

DT = 0.01
HEADLINE = (4096, 100)   # (B, N): bench.py's cart-pole shape
TICK = (256, 200)        # (B, N): the 256-controller tick loop
# (B, N): the boxed vertical-motion config (benchmarks/bench_all.py:75-92)
VERTICAL = (1024, 100)
VERTICAL_TICK = (256, 100)
FORCE = (0.0, 30.0)      # the vertical model's force limits [N]
CART_FORCE = (-15.0, 15.0)
# Kernel vs plain version, normalized max|a-b| / (1 + max|a|) over the
# lanes both call ok (benchmarks/parity_gate.py:61 for fp32; fp64 differs
# only by FMA contraction, summation order and the math library).
KERNEL_TOL = {torch.float32: 2e-4, torch.float64: 1e-10}
# End-to-end fp32 contract (benchmarks/parity_gate.py:72-73).
E2E_U_NORM, E2E_COST_REL = 1e-2, 1e-4
# End-to-end fp64 contract of the boxed solves against the plain path.
E2E_U_NORM_FP64 = 1e-8
GOLDEN_TOL = 1e-8
# (backward_impl, forward_impl) pairs that are timed; "auto" resolves to
# the last on the card.
PAIRS = (("pallas", "scan"), ("pallas", "fused"), ("remat", "fused"))
# The card's published peaks (H100 SXM data sheet, at 700 W): device
# memory and float32 outside the tensor cores.
PEAK_BYTES_S, PEAK_FP32_S = 3.35e12, 67e12
# A 2x2 QP that takes 7 projected-Newton iterations from x0 = 0 under the
# default BoxQPConfig (more than its unroll_iter = 4), planted in one lane
# of K4's input: (H, g, lower, upper) with u = 0.
LONG_QP = ([[1.24, 1.82], [1.82, 2.68]], [2.42, 3.13], [-0.06, -0.9],
           [0.95, 0.52])


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its wrapper and the wrapper's launch
    counter, where it lives and which TPU kernel it replaces."""

    name: str
    wrapper: object
    counter: str
    source: str
    replaces: str
    max_abs_err: float = 0.0
    launches: int = 0
    ms: float = math.nan
    plain_ms: float = math.nan
    bound_ms: float = math.nan
    bound_by: str = ""
    library_ms: object = None   # no single PyTorch call computes these


KERNELS = {
    "K1": Kernel("ddp_backward_fused", backward_fused, "launches",
                 "nmpc_tpu_torch/csrc/ddp_backward.cu",
                 "nmpc_tpu/kernels/ddp_backward_pallas.py:867"),
    "K4": Kernel("ddp_backward_boxed", boxed.backward_fused_boxed,
                 "launches", "nmpc_tpu_torch/csrc/ddp_backward_boxed.cuh",
                 "nmpc_tpu/kernels/ddp_backward_pallas.py:1018"),
    "K5": Kernel("backward_remat", remat.backward_remat, "launches",
                 "nmpc_tpu_torch/csrc/ddp_backward_remat.cuh",
                 "nmpc_tpu/kernels/ddp_backward_remat.py:369"),
    "K5b": Kernel("backward_remat_boxed", remat.backward_remat,
                  "boxed_launches",
                  "nmpc_tpu_torch/csrc/ddp_backward_remat.cuh",
                  "nmpc_tpu/kernels/ddp_backward_remat.py:369"),
    "K6": Kernel("forward_selected_remat", fwd.forward_selected_remat,
                 "launches", "nmpc_tpu_torch/csrc/ddp_forward_remat.cuh",
                 "nmpc_tpu/kernels/ddp_forward_remat.py:285"),
    "K7": Kernel("forward_costs_remat", fwd.forward_costs_remat, "launches",
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
        setattr(k.wrapper, k.counter, 0)


def read_counts():
    return {key: getattr(k.wrapper, k.counter) for key, k in KERNELS.items()}


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


@functools.cache
def vertical_problem():
    """The boxed vertical-motion model, one object for the whole run (its
    units are generated once per object)."""
    return make_vertical_problem(DT)


@functools.cache
def boxed_cartpole():
    return make_cartpole_problem(DT, input_limits=CART_FORCE)


def boxed_config(N, **kw):
    """The boxed configuration of benchmarks/bench_all.py:80-82."""
    return DDPConfig(**{"horizon_steps": N, "max_iter": 3,
                        "initial_lambda": 1e-6,
                        "with_input_constraint": True, **kw})


def vertical_start(B, N, dtype, device):
    """The vertical config's batch (benchmarks/bench_all.py:83-87): x0
    near 1.2 m from seed 0, zero forces."""
    rng = np.random.default_rng(0)
    x0s = np.tile([1.2, 0.0], (B, 1)) + 0.05 * rng.normal(size=(B, 2))
    return (torch.as_tensor(x0s, dtype=dtype, device=device),
            torch.zeros((B, N, 2), dtype=dtype, device=device))


def stage_masks(problem, t0, N):
    """The input mask of each stage [N, nu] (all set without a mask)."""
    ts = torch.as_tensor(t0, dtype=torch.float64) + DT * torch.arange(
        N, dtype=torch.float64)
    if problem.input_mask is None:
        return torch.ones((N, problem.input_dim), dtype=torch.bool)
    return torch.stack([problem.input_mask(t) for t in ts])


def box_holds(us, masks, box):
    """(every first-stage u inside the box, every masked-out u exactly 0,
    the entries of the whole trajectory outside the box, the farthest
    one's distance): us [B, N, nu], masks [N, nu].  The box binds the
    QP's feedforward: the first stage, which the controller applies, has
    dx = 0 and stays inside; later stages add the unclipped feedback
    K dx of the forward pass (DDPSolver.hpp:537-560; the JAX package
    does the same), so they may leave the box."""
    us = us.cpu()
    inside = bool((us[:, 0] >= box[0]).all() and (us[:, 0] <= box[1]).all())
    excess = torch.clamp(torch.maximum(box[0] - us, us - box[1]), min=0)
    return (inside, bool((us[:, ~masks] == 0).all()),
            int((excess > 0).sum()), float(excess.max()))


def boxed_rollout(model, B, N, dtype, device):
    """First-iteration data of a boxed model: (problem, t0, xs, us, Vx_T,
    Vxx_T), batch-minor.  Vertical: x0 near 1.2 m, forces 0.02 N apart
    from 0 (either side of the lower bound), from t0=1.5, so that the
    horizon crosses the switch to two contacts at t=2.  Cart-pole: the
    hanging rollout of the unboxed checks, force limits (-15, 15)."""
    if model == "vertical":
        problem, t0 = vertical_problem(), 1.5
        rng = np.random.default_rng(0)
        x0s = np.tile([1.2, 0.0], (B, 1)) + 0.05 * rng.normal(size=(B, 2))
        us = 0.02 * rng.normal(size=(N, 2, B))
    else:
        problem, t0 = boxed_cartpole(), 0.3
        x0, u0 = hanging_inputs(B, N, torch.float64, "cpu", seed=1,
                                us_scale=0.2)
        x0s, us = x0.numpy(), u0.permute(1, 2, 0).numpy()
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    t0, us = as_t(t0), as_t(us).contiguous()
    config = boxed_config(N)
    xs, _ = ddp_mod._rollout_lanes(problem, config, t0,
                                   as_t(x0s.T).contiguous(), us)
    VxT, VxxT = (a.contiguous() for a in ddp_mod._terminal_quad_lanes(
        problem, config, t0, xs))
    return problem, t0, xs, us, VxT, VxxT


def boxed_derivs(model, B, N, dtype, device):
    """K4's input: the stage derivatives and bounds of the boxed rollout,
    with lane 1 made non-PD (Luu = -10), lane 2 NaN-poisoned and, at
    nu = 2, LONG_QP planted in lane 3's last stage (Fu = 0 there, so that
    the QP is (Luu + lam I, Lu) on the planted box)."""
    problem, t0, xs, us, VxT, VxxT = boxed_rollout(model, B, N, dtype,
                                                   device)
    D = _stage_derivs_sweep(problem, boxed_config(N), t0, xs, us)
    D, bnd = StackedDerivs(*D[:7]), StackedBounds(*D[-3:])
    D.Luu[:, :, :, 1] = -10.0
    D.Fx[N // 2, 0, 0, 2] = float("nan")
    if problem.input_dim == 2:
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        H, g, lo, hi = LONG_QP
        D.Fu[N - 1, :, :, 3] = 0.0
        D.Luu[N - 1, :, :, 3] = as_t(H)
        D.Lu[N - 1, :, 3] = as_t(g)
        bnd.lower[N - 1, :, 3] = as_t(lo)
        bnd.upper[N - 1, :, 3] = as_t(hi)
        bnd.u[N - 1, :, 3] = 0.0
    return D, bnd, VxT, VxxT


def boxed_remat_inputs(model, B, N, dtype, device):
    """K5 boxed's input: the boxed rollout with lane 1 made non-PD (a
    negative definite terminal Vxx under forces of 5 N, inside the box)
    and lane 2 NaN-poisoned (a NaN terminal Vxx: a NaN state alone leaves
    the vertical model's Quu finite, and its QP then ends MAX_LS_ITER
    with NaN gains and ok set, in the plain version as in the kernel)."""
    problem, t0, xs, us, VxT, VxxT = boxed_rollout(model, B, N, dtype,
                                                   device)
    nx = xs.shape[1]
    us[:, :, 1] = 5.0
    VxxT[:, :, 1] = -1e6 * torch.eye(nx, dtype=dtype, device=device)
    VxxT[0, 0, 2] = float("nan")
    return problem, t0, xs, us, VxT, VxxT


def qp_tails(stats, config):
    """Lanes whose QP ran past unroll_iter iterations, and past the
    ls_block head of the Armijo schedule, at some stage."""
    bq = config.boxqp
    return (int((stats["qp_iters"] > bq.unroll_iter).any(0).sum()),
            int((stats["ls_candidates"] > bq.ls_block).any(0).sum()))


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


def ptxas_report(lib):
    log = lib.with_suffix(".log")
    if not log.exists():
        return "cached build"
    return " | ".join(ln.split(":", 1)[-1].strip()
                      for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln)


def phase_build():
    """Generate every unit (tracing runs one at a time), then start one
    nvcc per unit, all together."""
    cartpole = make_cartpole_problem(DT)
    start = time.perf_counter()
    units = [("ddp_backward", None, ())]
    for dtype in (torch.float32, torch.float64):
        for mod in (remat, fwd):
            units.append((mod.unit_name(dtype),
                          mod.unit_source(cartpole, 4, 1, dtype), ()))
        units.append((fwd.unit_name(dtype),
                      fwd.unit_source(vertical_problem(), 2, 2, dtype), ()))
        for problem, nx, nu in ((vertical_problem(), 2, 2),
                                (boxed_cartpole(), 4, 1)):
            units.append((remat.unit_name(dtype, True),
                          remat.unit_source(problem, nx, nu, dtype, True),
                          remat.unit_flags(True)))
        for nx, nu in ((2, 2), (4, 1)):
            units.append((boxed.unit_name(nx, nu, dtype),
                          boxed.unit_source(nx, nu, dtype),
                          boxed.BOXED_FLAGS))
    gen_s = time.perf_counter() - start

    def compile_unit(unit):
        name, text, flags = unit
        if text is None:
            return kbuild.build(name)
        return kbuild.build_generated(name, text, flags)

    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        libs = list(pool.map(compile_unit, units))
    secs = time.perf_counter() - start
    print(f"[build] {len(libs)} units in {secs:.1f} s (generation "
          f"{gen_s:.1f} s)", flush=True)
    for (name, _, flags), lib in zip(units, libs):
        print(f"[build] ptxas {lib.name}{' ' + ' '.join(flags) if flags else ''}"
              f": {ptxas_report(lib)}", flush=True)
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
    phase_kernels_boxed(device)


def check_boxed(key, label, plain, out, B, config, stats, dtype):
    """Ok masks, errors and the QP tails one boxed kernel check ran."""
    check_ok(f"{key} {label}", plain[3], out[3], B)
    err = report(f"{key} {label}", {
        n: norm_err(a, b, plain[3]) for n, a, b in
        zip(("ks", "Ks", "dV"), plain, out)}, dtype)
    KERNELS[key].max_abs_err = max(KERNELS[key].max_abs_err, err)
    tails = qp_tails(stats, config)
    print(f"[kernel] {key} {label}: lanes whose QP ran past unroll_iter="
          f"{config.boxqp.unroll_iter} iterations {tails[0]}, past the "
          f"ls_block={config.boxqp.ls_block} Armijo head {tails[1]} (the "
          f"plain version's count on the same inputs)", flush=True)
    return tails


def phase_kernels_boxed(device):
    """K4 and K5 boxed vs their plain versions: vertical-motion data at
    fp32 and fp64 with both regularization types, boxed cart-pole data at
    fp32."""
    cases = [("vertical", VERTICAL, torch.float32),
             ("vertical", VERTICAL, torch.float64),
             ("cart-pole", HEADLINE, torch.float32)]
    for model, (B, N), dtype in cases:
        dname = str(dtype)[6:]
        D, bnd, VxT, VxxT = boxed_derivs(model, B, N, dtype, device)
        problem, t0, xs, us, VxT5, VxxT5 = boxed_remat_inputs(
            model, B, N, dtype, device)
        reg_types = ((1, 1e-6), (2, 0.5)) if model == "vertical" else (
            (1, 1e-6),)
        for reg_type, lam_val in reg_types:
            config = boxed_config(N, reg_type=reg_type)
            lam = torch.full((B,), lam_val, dtype=dtype, device=device)
            label = f"{model} B={B} N={N} {dname} reg_type={reg_type}"
            stats = {}
            plain = backward_stacked_boxed(config, D, bnd, VxT, VxxT, lam,
                                           stats=stats)
            out = boxed.backward_fused_boxed(config, D, bnd, VxT, VxxT, lam)
            torch.cuda.synchronize()
            tails = check_boxed("K4", label, plain, out, B, config, stats,
                                dtype)
            if model == "vertical":
                check(tails[0] > 0 and tails[1] > 0,
                      f"K4 {label}: a QP tail did not run")
            stats = {}
            Dr = _stage_derivs_sweep(problem, config, t0, xs, us)
            plain = backward_stacked_boxed(
                config, StackedDerivs(*Dr[:7]), StackedBounds(*Dr[-3:]),
                VxT5, VxxT5, lam, stats=stats)
            out = remat.backward_remat(problem, config, t0, xs, us, VxT5,
                                       VxxT5, lam, boxed=True)
            torch.cuda.synchronize()
            check_boxed("K5b", label, plain, out, B, config, stats, dtype)


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
    and the threshold, in ulp of the lane's cost before that iteration (a
    lane that stops on the gradient test writes no cost there)."""
    lanes = ((a.status != b.status) | (a.iters != b.iters)).nonzero()
    out = []
    for lane in lanes.flatten().tolist():
        j = int(min(a.iters[lane], b.iters[lane]))
        cost = a.trace.cost[lane, j - 1].cpu().numpy()
        ulp = float(np.spacing(np.abs(cost)))
        upd = [float(r.trace.cost_update_actual[lane, j]) / ulp
               for r in (a, b)]
        out.append(f"lane {lane} iteration {j}: status {int(a.status[lane])}"
                   f"/{int(b.status[lane])}, cost update {upd[0]:.2f}/"
                   f"{upd[1]:.2f} ulp vs threshold "
                   f"{cost_update_thre / ulp:.2f} ulp")
    return out


def solve_counted(problem, cfg, x0s, us0, t0=0.0):
    """One solve_batch with every launch counter reset just before and
    read just after."""
    solver = DDPSolver(problem, cfg)
    reset_counts()
    res = solver.solve_batch(t0, x0s, us0)
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
    phase_e2e_boxed(device)


def phase_e2e_boxed(device):
    """The boxed solve through K4 (``backward_impl="pallas"``, scan
    rollouts), through ``auto`` (K5 boxed + K6/K7) and on the plain path:
    the vertical config (B=1024, N=100, 3 iterations, t0=0) and the
    cart-pole with force limits at the headline shape (10 iterations), at
    fp64 (the full contract against the plain path) and fp32 (decision
    flips listed with their ulps, u and cost held to the contract)."""
    paths = (("K4", {"backward_impl": "pallas", "forward_impl": "scan"}),
             ("auto", {}),
             ("plain", {"backward_impl": "stacked", "forward_impl": "scan"}))
    for model in ("vertical", "cart-pole"):
        if model == "vertical":
            (B, N), problem, box, iters = (VERTICAL, vertical_problem(),
                                           FORCE, 3)
            x0s, us0 = vertical_start(B, N, torch.float64, device)
        else:
            (B, N), problem, box, iters = (HEADLINE, boxed_cartpole(),
                                           CART_FORCE, 10)
            x0s, us0 = hanging_inputs(B, N, torch.float64, device)
        masks = stage_masks(problem, 0.0, N)
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype)[6:]
            # the cart-pole's fp32 solves use the fp32 thresholds, as the
            # headline's do: cost_update_thre = 1e-7 is ~0.003 ulp of its
            # cost; the vertical config is taken as benchmarked
            cfg = boxed_config(N, max_iter=iters)
            if model == "cart-pole" and dtype == torch.float32:
                cfg = cfg.for_fp32()
                dname += " for_fp32()"
            out = {name: solve_counted(problem, dataclasses.replace(
                cfg, **kw), x0s.to(dtype), us0.to(dtype))
                for name, kw in paths}
            for name, (res, counts, syncs) in out.items():
                inside, masked_zero, n_out, far = box_holds(res.us, masks,
                                                            box)
                finite = bool(torch.isfinite(res.us).all()
                              and torch.isfinite(res.xs).all())
                n_status = torch.bincount(res.status, minlength=5).tolist()
                line = (f"[e2e] boxed {model} B={B} N={N} max_iter={iters} "
                        f"{dname} {name}: launches {counts}, host syncs "
                        f"{syncs}, status counts {n_status}, u[0] inside "
                        f"{list(box)} {inside}, masked u exactly 0 "
                        f"{masked_zero}, trajectory entries outside the box "
                        f"{n_out} of {res.us.numel()} (farthest {far:.3g})")
                if name != "plain":
                    ref = out["plain"][0]
                    st, it, du, dc = e2e_compare(res, ref)
                    flips = decision_flips(res, ref, cfg.cost_update_thre)
                    line += (f"; vs plain: status equal {st}, iters equal "
                             f"{it}, u norm diff {du:.3e}, cost rel diff "
                             f"{dc:.3e}; lanes that differ: "
                             f"{'; '.join(flips[:8]) or 'none'}"
                             f"{f' (+{len(flips) - 8} more)' if len(flips) > 8 else ''}")
                    if dtype == torch.float64:
                        check(st and it and du <= E2E_U_NORM_FP64,
                              f"boxed {model} fp64 {name} vs plain")
                    check(du <= E2E_U_NORM and dc <= E2E_COST_REL,
                          f"boxed {model} {dname} {name}: u or cost vs plain "
                          f"out of the contract")
                print(line, flush=True)
                check(finite and inside and masked_zero,
                      f"boxed {model} {dname} {name}: non-finite, u[0] out "
                      f"of the box or a masked u not 0")
            k4, auto, plain = (out[n][1] for n in ("K4", "auto", "plain"))
            check(k4["K4"] > 0 and k4["K5b"] == 0,
                  f"boxed {model} {dname}: the K4 path did not launch K4")
            check(auto["K5b"] > 0 and auto["K6"] > 0 and auto["K4"] == 0
                  and auto["K5"] == 0, f"boxed {model} {dname}: auto did "
                  "not run K5 boxed and K6")
            check(not any(plain.values()),
                  f"boxed {model} {dname}: the plain path launched a kernel")
            if model == "vertical" and dtype == torch.float32:
                KERNELS["K4"].launches = k4["K4"]
                KERNELS["K5b"].launches = auto["K5b"]


def tick_loop(device, problem, impls, n_ticks=20, boxed=False):
    """Tick times (ms) of a 256-controller loop on one (backward, forward)
    pair, each tick from the start of one solve to the start of the next,
    each reading after a device synchronize; and the log.  Cart-pole:
    N=200 from the hanging pose at t0=0; boxed: the vertical model, N=100,
    from t0=1.8, so that the horizon's end crosses the contact switch.
    The first solve of a problem object generates its kernel units (a
    trace and a cached library lookup), so warm-up and timed loops share
    one problem."""
    B, N = VERTICAL_TICK if boxed else TICK
    stamps = []

    class TickClock(DDPSolver):
        def solve_batch(self, t0, x0s, us_inits):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return super().solve_batch(t0, x0s, us_inits)

    impl = dict(backward_impl=impls[0], forward_impl=impls[1])
    if boxed:
        cfg, t0 = boxed_config(N, **impl), 1.8
        x0s, us0 = vertical_start(B, N, torch.float32, device)
    else:
        cfg, t0 = DDPConfig(horizon_steps=N, max_iter=3, **impl), 0.0
        x0s, us0 = hanging_inputs(B, N, torch.float32, device)
    log = make_closed_loop_batch(TickClock(problem, cfg),
                                 n_steps=n_ticks)(t0, x0s, us0)
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

    B, N = VERTICAL_TICK
    problem = vertical_problem()
    reset_counts()
    ms, log = tick_loop(device, problem, ("auto", "auto"), boxed=True)
    counts = read_counts()
    finite = bool(torch.isfinite(log.xs).all() and torch.isfinite(log.us).all())
    masks = torch.stack([problem.input_mask(t) for t in log.ts.cpu()])
    us = log.us.cpu()   # [B, ticks, nu]: each tick's applied (first) u
    inside = bool(((us >= FORCE[0]) & (us <= FORCE[1])).all())
    masked_zero = bool((us[:, ~masks] == 0).all())
    print(f"[serving] {B} boxed vertical controllers N={N} max_iter=3 fp32 "
          f"auto from t0=1.8, {len(ms)} ticks: tick p50 "
          f"{np.percentile(ms, 50):.2f} ms, p99 {np.percentile(ms, 99):.2f} "
          f"ms, first {ms[0]:.2f} ms; contacts over the ticks "
          f"{sorted(set(num_contacts(log.ts.cpu()).tolist()))}; launches "
          f"{counts}; all finite {finite}, applied u inside {list(FORCE)} "
          f"{inside}, masked u exactly 0 {masked_zero} [{card}]", flush=True)
    check(finite and inside and masked_zero,
          "a boxed controller went non-finite, left the box or moved a "
          "masked input")
    check(all(counts[key] > 0 for key in ("K5b", "K6", "K7")),
          "the boxed tick loop skipped a kernel of the fused path")


def moved_bytes(key, B, N, itemsize, nx=4, nu=1, A=11):
    """Bytes a kernel must move at (B, N): its inputs read once and its
    outputs written once."""
    traj = (N + 1) * nx + N * nu                 # xs, us per lane
    gains = N * nu + N * nu * nx                 # ks, Ks per lane
    fields = nx * nx * 2 + nx * nu * 2 + nx + nu + nu * nu
    carry = nx + nx * nx + 3                     # Vx_T, Vxx_T, lam, dV
    if key == "K1":
        return itemsize * B * (N * fields + gains + carry) + B
    if key == "K4":
        return itemsize * B * (N * (fields + 3 * nu) + gains + carry) + B
    if key in ("K5", "K5b"):
        return itemsize * B * (traj + gains + carry) + B
    if key == "K6":
        return itemsize * B * (2 * traj + gains + (N + 1) + 2)
    return itemsize * (B * (traj + gains) + A + A * B)


def chol_ops(n):
    return sum(2 * j + 2 + (n - 1 - j) * (2 * j + 1) for j in range(n))


def solve_ops(n, m):
    return m * (2 * n * n + n)


def riccati_ops(nx, nu, reg_type, boxed_stage):
    """Arithmetic operations of one stage of csrc/riccati_stage.cuh,
    outside the boxed stage's QP."""
    q = (nu * 2 * nx + nu * nx * (2 * nx - 1) + nx * 2 * nx
         + nx * nx * (2 * nx - 1) + nu * nx * 2 * nx + nu * nu * 2 * nx
         + nx * nx * 2 * nx)
    q += (nu * nx * (3 * nx - 1) + nu * nx * 2 * nx + nu * nu * 2 * nx
          if reg_type == 2 else nu * nu)
    value = (nu * (2 * nu - 1) + 2 * (2 * nu - 1) + 3
             + nx * (3 * (2 * nu - 1) + 3) + nu * nx * (2 * nu - 1)
             + nx * nx * (2 * nu - 1) + nx * nx * (2 * nu + 2) + nx * nx * 2)
    if boxed_stage:
        return q + 2 * nu + 2 * nu * nx + solve_ops(nu, nx) + value
    return q + chol_ops(nu) + solve_ops(nu, 1) + solve_ops(nu, nx) + value


def qp_ops(nu, stats):
    """Operations of csrc/boxqp.cuh for the QP iterations and Armijo
    candidates these inputs needed (the plain version's counts)."""
    objective = 2 * nu * nu + 3 * nu
    per_iter = (3 + 2 * nu * nu + 3 * nu * nu + chol_ops(nu) + 3 * nu
                + nu * (3 * nu + 1) + solve_ops(nu, 1) + 5 * nu)
    per_candidate = 2 * nu + objective + 4
    return (int(stats["qp_iters"].sum()) * per_iter
            + int(stats["ls_evals"].sum()) * per_candidate
            + stats["qp_iters"].numel() * objective)


def program_ops(problem, kind, name, nx, nu):
    """Scalar operations of a generated function (its live ops but the
    arguments and casts)."""
    prog, outs = tileval.generate(problem, kind, nx, nu,
                                  torch.float32).functions[name]
    return sum(v.op not in ("arg", "cast") for v in prog.live(outs))


def bound(nbytes, ops):
    """(least time in ms, which term bounds it): bytes over the card's
    memory rate, float32 operations over its float32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_times(device, card):
    """Each kernel vs its plain version per call (CUDA events) beside its
    bound, then solves/s and tick p50/p99 for each (backward, forward)
    pair, and solves/s of the boxed vertical solve for each pair."""
    for B, N in (HEADLINE, TICK):
        dtype = torch.float32
        cfg = DDPConfig(horizon_steps=N)
        lam = torch.full((B,), 1e-4, device=device)
        D, VxT, VxxT = rollout_derivs(B, N, dtype, device)
        problem, t0, xs, us, VxT5, VxxT5 = rollout(B, N, dtype, device)
        _, _, _, _, ks, Ks, alpha = rollout_refs(B, N, dtype, device)
        alphas = torch.tensor(cfg.alpha_list, device=device)
        A = len(cfg.alpha_list)
        ric = riccati_ops(4, 1, 1, False)
        # u = u_ref + alpha k + K (x - x_ref), the step, the cost sum
        step = (4 + 1 * (2 * 4 + 2)
                + program_ops(problem, "forward", "step", 4, 1) + 1)
        ops = {"K1": B * N * ric,
               "K5": B * N * (ric + program_ops(problem, "remat", "fields",
                                                4, 1)),
               "K6": B * (N * step + program_ops(problem, "forward", "term",
                                                 4, 1)),
               "K7": A * B * (N * step + program_ops(problem, "forward",
                                                     "term", 4, 1))}
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
            record_time(key, kernel, plain, moved_bytes(key, B, N, 4),
                        ops[key], f"B={B} N={N}", (B, N) == HEADLINE, card)

    for model, (B, N) in (("vertical", VERTICAL), ("cart-pole", HEADLINE)):
        dtype = torch.float32
        cfg = boxed_config(N)
        lam = torch.full((B,), 1e-6, device=device)
        D, bnd, VxT, VxxT = boxed_derivs(model, B, N, dtype, device)
        problem, t0, xs, us, VxT5, VxxT5 = boxed_rollout(model, B, N, dtype,
                                                         device)
        nx, nu = problem.state_dim, problem.input_dim
        stats4, stats5 = {}, {}
        backward_stacked_boxed(cfg, D, bnd, VxT, VxxT, lam, stats=stats4)
        Dr = _stage_derivs_sweep(problem, cfg, t0, xs, us)
        backward_stacked_boxed(cfg, StackedDerivs(*Dr[:7]),
                               StackedBounds(*Dr[-3:]), VxT5, VxxT5, lam,
                               stats=stats5)
        ric = riccati_ops(nx, nu, 1, True)
        gen = (program_ops(problem, "remat_boxed", "fields", nx, nu)
               + program_ops(problem, "remat_boxed", "aux", nx, nu))
        calls = {
            "K4": (lambda: boxed.backward_fused_boxed(cfg, D, bnd, VxT, VxxT,
                                                      lam),
                   lambda: backward_stacked_boxed(cfg, D, bnd, VxT, VxxT,
                                                  lam),
                   B * N * ric + qp_ops(nu, stats4)),
            "K5b": (lambda: remat.backward_remat(problem, cfg, t0, xs, us,
                                                 VxT5, VxxT5, lam,
                                                 boxed=True),
                    lambda: remat.backward_remat_plain(
                        problem, cfg, t0, xs, us, VxT5, VxxT5, lam,
                        boxed=True),
                    B * N * (ric + gen) + qp_ops(nu, stats5)),
        }
        for key, (kernel, plain, n_ops) in calls.items():
            record_time(key, kernel, plain,
                        moved_bytes(key, B, N, 4, nx, nu), n_ops,
                        f"{model} B={B} N={N}", model == "vertical", card,
                        plain_reps=3)

    B, N = HEADLINE
    problem = make_cartpole_problem(DT)
    x0s, us0 = hanging_inputs(B, N, torch.float32, device)
    for pair in PAIRS:
        solver = DDPSolver(problem, DDPConfig(
            horizon_steps=N, max_iter=10, backward_impl=pair[0],
            forward_impl=pair[1]))
        secs = timed_solves(solver, x0s, us0, 10)
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

    B, N = VERTICAL
    x0s, us0 = vertical_start(B, N, torch.float32, device)
    for pair in PAIRS + (("stacked", "scan"),):
        solver = DDPSolver(vertical_problem(), boxed_config(
            N, backward_impl=pair[0], forward_impl=pair[1]))
        secs = timed_solves(solver, x0s, us0, 1 if pair[0] == "stacked"
                            else 10)
        print(f"[times] boxed vertical solve_batch B={B} N={N} max_iter=3 "
              f"fp32 backward={pair[0]} forward={pair[1]}: median "
              f"{statistics.median(secs):.4f} s, "
              f"{B / statistics.median(secs):.1f} solves/s, host syncs "
              f"{solver.host_syncs} [{card}]", flush=True)


def timed_solves(solver, x0s, us0, reps):
    """Host seconds of ``reps`` synced solves after a warm one."""
    solver.solve_batch(0.0, x0s, us0)
    torch.cuda.synchronize()
    secs = []
    for _ in range(reps):
        start = time.perf_counter()
        solver.solve_batch(0.0, x0s, us0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - start)
    return secs


def record_time(key, kernel, plain, nbytes, ops, label, keep, card,
                plain_reps=5):
    """Time a kernel and its plain version, print them beside the bound,
    and keep them in the record when ``keep``."""
    t_kern = cuda_ms(kernel, inner=10)
    t_plain = cuda_ms(plain, reps=plain_reps, warmup=1)
    t_bound, by = bound(nbytes, ops)
    gbs = nbytes / (t_kern * 1e-3) / 1e9
    print(f"[times] {key} {KERNELS[key].name} {label} fp32: kernel "
          f"{t_kern:.4f} ms ({gbs:.1f} GB/s of {nbytes / 1e6:.2f} MB, "
          f"{ops / 1e6:.1f} M ops), plain {t_plain:.3f} ms, bound "
          f"{t_bound * 1e3:.2f} us ({by}) [{card}]", flush=True)
    if keep:
        k = KERNELS[key]
        k.ms, k.plain_ms, k.bound_ms, k.bound_by = t_kern, t_plain, t_bound, by


LAYERS = ("_rollout_lanes", "_derivative_sweep_lanes", "_terminal_quad_lanes",
          "backward_fused", "backward_stacked", "backward_remat",
          "backward_fused_boxed", "backward_stacked_boxed",
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
    """Where one solve's time goes, at both shapes and for the boxed
    vertical config, for each (backward, forward) pair and the plain path:
    synced wall time, synced time per layer, and the device's busy time
    and kernel launches from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    cartpole = make_cartpole_problem(DT)
    cells = []
    for label, (B, N), iters, ls_mode in (("headline", HEADLINE, 10, "auto"),
                                          ("tick", TICK, 3, "sweep")):
        x0s, us0 = hanging_inputs(B, N, torch.float32, device)
        cells.append((label, cartpole, x0s, us0, lambda pair, N=N, i=iters,
                      m=ls_mode: DDPConfig(horizon_steps=N, max_iter=i,
                                           backward_impl=pair[0],
                                           forward_impl=pair[1],
                                           ls_mode=m)))
    B, N = VERTICAL
    x0s, us0 = vertical_start(B, N, torch.float32, device)
    cells.append(("boxed vertical", vertical_problem(), x0s, us0,
                  lambda pair, N=N: boxed_config(N, backward_impl=pair[0],
                                                 forward_impl=pair[1])))
    for label, problem, x0s, us0, make_cfg in cells:
        B, N = us0.shape[:2]
        for pair in PAIRS + (("stacked", "scan"),):
            cfg = make_cfg(pair)
            solver = DDPSolver(problem, cfg)

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
            print(f"[layers] {label} B={B} N={N} max_iter={cfg.max_iter} "
                  f"ls_mode={cfg.ls_mode} backward={pair[0]} forward="
                  f"{pair[1]}: wall {wall * 1e3:.1f} ms, device busy "
                  f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f} %), "
                  f"cudaLaunchKernel {launches}, host syncs "
                  f"{solver.host_syncs}; synced layers (total "
                  f"{synced * 1e3:.1f} ms): {parts}, rest "
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
        "max_abs_err": k.max_abs_err, "ms": k.ms, "plain_ms": k.plain_ms,
        "bound_ms": k.bound_ms, "bound_by": k.bound_by,
        "library_ms": k.library_ms}
        for k in KERNELS.values()]}
    numbers = [v for k in KERNELS.values()
               for v in (k.max_abs_err, k.ms, k.plain_ms, k.bound_ms)]
    if (not all(math.isfinite(v) for v in numbers)
            or not all(k.bound_by and k.launches > 0
                       for k in KERNELS.values())):
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
