#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nmpc_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--layers] [--centroidal-driver]
                          [--qp-groups [--baseline DIR]] [--phases NAME,...]

Phases, one line each (a failed phase exits non-zero):

1. build: generate the remat backward (K5), boxed remat backward (K5
   boxed) and rollout (K6, K7) units of the cart-pole and the
   vertical-motion model from their callables (and K5 of two cart-poles
   on one force, nx = 8, at fp64), the sweep-fed backward in
   its three layouts (K1, K2 chunked, K3 packed) at (nx, nu) = (4, 1) and
   (2, 1) (and (8, 4) at fp64), the sweep-fed boxed backward (K4) at (2,
   2) and (4, 1), the
   FMPC backward in its three layouts (K8 streaming, K9 resident, K10
   packed) at (nx, nu, ng) = (2, 1, 3), (4, 1, 4), (2, 2, 2) and the FMPC
   recursion (K11) at (2, 1), (4, 1), (2, 2), and K1, K2, K3 and K4 at
   the centroidal model's (9, 16) (K1@9x16, K2@9x16, K3@9x16, K4@9x16),
   the wide FMPC units at (12, 3, 30) (K8, K9, K10, K11), (16, 8, 48) and
   (16, 16, 64) (K8, K10, K11),
   for fp32 and fp64 (K1-K5 and K8-K11 with -fmad=false); then compile
   them with nvcc, all at once; print the seconds (the (9, 16) units'
   nvcc seconds apart) and ptxas' registers and spills (the (9, 16)
   units' at fp32, and K1@9x16's at fp64, held to 0); then start
   K4@9x16's plain version on the card host's CPU at B=256, N=100 in four
   processes of their own (``k4-references``: fp32 and fp64, both
   reg_types), which the centroidal phase reads;
2. kernels: hold each kernel against its plain PyTorch version on the card,
   fp32 and fp64: K1 and K5 at the headline shape (B=4096, N=100) and the
   tick shape (B=256, N=200), each with one non-PD lane and one NaN lane;
   K5 at nx = 8, fp64, B=4096 (its field slab sized to the block's shared
   memory); K6 and K7 with gains from a real backward pass, and whether K7's
   column for an alpha equals K6's sum bit for bit; K6 and K7 where they
   launch their TMA ring (the boxed vertical model's step) at B=1024,
   N=100, B=256 and a ragged B=1023 (their references copied once); K4
   and K5 boxed on
   first-iteration vertical-motion data (B=1024, N=100, across the switch
   to two contacts, both regularization types), with a non-PD, a NaN and
   (K4) a planted long-QP lane, and how many lanes ran the QP's iteration
   and Armijo tails; K4 and K5 boxed on boxed cart-pole data (B=4096,
   N=100, fp32); K4 and K5 boxed where one lane's QPs run the whole
   Armijo schedule (``min_step = 0``, a NaN lane, B=1023, fp32 and fp64);
   the boxed kernels bit for bit; K8 against ``_backward_bm`` on first-
   iteration FMPC data (cart-pole B=4096, oscillator B=1024, N=100, both
   ``break_if_llt_fails``, a non-PD and a NaN lane; the two-input non-PD
   case) and K11 against its plain recursion fed K8's gains; the device
   kernels one ``backward_fmpc_fused`` call runs (``torch.profiler``: K8
   and K9 condense in their kernel, one launch each); then the
   layout variants against their plain versions and, bit for bit, their
   parent kernels (a failed check): K2 and K3 against K1 at the headline
   shape and the bipedal shape (B=2048, N=300), K1, K2 and K3 at B=1023
   (K1's fields and K3's P copied once to a lane stride TMA takes), with
   a field at a 4-byte offset (K1 copies it) and at (8, 4) fp64, K9
   against K8 at the oscillator's N=20
   (B=4096) and the cart-pole's largest N that fits, K10 at those and at
   both FMPC shapes of phase 2, K9 and K10 on the two-input case;
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
   ``FmpcSolver.solve_batch`` at the cart-pole serving shape (B=4096,
   N=100, 5 iterations) through ``auto`` (K8 + K11) and the plain path:
   fp64 on the stabilization and swing-up populations, fp32's converged
   set; fp64 with ``enable_line_search``; fp64 ``solve`` of the
   oscillator against the NumPy golden FMPC;
   then the bipedal config #2 (B=2048, N=300, 10 iterations) through
   ``auto`` with each ``backward_dma`` (K1, K2, K3 and the plain rollouts)
   and the plain path, and FMPC through ``backward_variant`` "resident"
   and "stream" (oscillator N=20, B=4096) and "packed" (cart-pole
   serving), at fp64 and fp32 against the plain path, and the headline
   cart-pole solve with ``deriv_dtype="float64"`` (``auto``: K1) against
   the plain path; the fp32 lanes
   whose decisions part from the other path are pinned
   (``UNBOXED_FP32_FLIPS``, ``BOXED_FP32_FLIPS``);
4. serving: ``make_closed_loop_batch`` with 256 cart-pole controllers,
   N=200, 3 iterations, 20 ticks, through the fused path; with 256
   boxed vertical-motion controllers, N=100, 3 iterations, 20 ticks from
   t0=1.8 (the horizon crosses the contact switch), through ``auto``; and
   a warm-started loop of 256 FMPC oscillator controllers at fp64, N=100,
   3 iterations, 100 ticks, every applied input inside the constraints;
   then the driver: ``run_mpc`` with one bipedal controller (fp64, N=300)
   from t=0 for 10 steps (each horizon crosses the footsteps at 1.5, 2
   and 3 s), its planned ZMP within 1e-2 of the reference at every step,
   and its last steps again on the plain path and with
   ``make_closed_loop``;
5. times on the card: each kernel and its plain version (CUDA events)
   beside its bound, the packs apart (and K3 with its pack beside K1), K8
   and K9 also alone (their launch on inputs prepared once), the
   QP work of the boxed kernels' timed inputs (``[qp]``), solves/s and
   tick p50/p99 for each (backward, forward) pair, solves/s of the boxed
   vertical solve and of
   both FMPC configurations for each pair, and of the oscillator at N=20
   and the cart-pole serving shape for each ``backward_variant`` (phase
   3 prints the bipedal config's for each ``backward_dma``); then
   (``fmpc-wide``) FMPC past (nx, nu, ng) = (8, 4, 16) on Wang and Boyd's
   oscillating masses (12, 3, 30): K8, K9 and K10 at the wide shapes
   against ``_backward_bm`` on the card (masses B=1024, 37, 1 at N=30,
   K9 at N=12 where its horizon fits; (16, 8, 48) and (16, 16, 64) at
   B=256 and 37, N=12), fp32 and fp64, both ``break_if_llt_fails``, with a
   non-PD, a NaN and a pivoting lane and masked rows, K9 and K10 bit for
   bit with K8, and K11 fed their gains; the masses' ``solve_batch``
   (B=4096, N=30, fp32, 5 iterations, ``kkt_error_thre=0``) through
   ``auto`` and each ``backward_variant`` (K9 at N=12) with their launch
   counters; fp64 (B=1024, the default config to convergence) and fp32's
   converged set against the plain path; each wide kernel timed beside
   its bound and plain version, and the solve through ``auto`` and the
   plain path;
6. the slice of C/GMRES and the centroidal model: K1@9x16 on centroidal
   sweep data (B=256, N=100, from t0=1.3 across the flight phase, both
   reg_types, fp32 and fp64, a non-PD and a NaN lane; and its first 37
   lanes, and lane 0 alone) bit for bit against its plain version on the
   card host's CPU (the plain version on the card, which reorders its
   sums, beside it), K2@9x16 and K3@9x16 on the same cases bit for bit
   against K1@9x16 and that plain version, and the three timed beside
   their bound at B=256 and B=1, fp32 and fp64 (K3's pack apart);
   ``solve_batch`` of the centroidal model (B=256, N=100, 3 iterations)
   through ``auto`` (K1@9x16, counted) and the plain path, fp64 (statuses,
   iterations, u within 1e-8) and fp32 (u and cost within ``E2E_U_NORM``
   and ``E2E_COST_REL`` or twice the plain path's own difference between
   the card and its host's CPU, parting lanes listed),
   masked inputs exactly 0, and through ``backward_dma="chunked"`` and
   ``"packed"`` (K2@9x16, K3@9x16, counted) bit for bit with the auto
   solve; K4@9x16 on boxed centroidal sweep data (N=100,
   both reg_types, fp32 and fp64, a non-PD and a NaN lane; B=256, its
   first 37 lanes and lane 0 alone) bit for bit against its plain version
   on the card host's CPU (``k4-references``), with the same QP
   iterations, free sets and Armijo candidates, timed beside its bound at
   B=256 and B=1 (and at B=256 beside that plain version's seconds), and
   its fp32 division and square root (``csrc/rn_ops.cuh``) against the
   card's IEEE ones (check_rn_ops: every positive float's root); the
   boxed solve (nu = 16, force limits (0, 1000)) at N=12
   through ``auto`` and ``backward_impl="pallas"`` (K4@9x16, counted)
   against the plain path (fp64 statuses, iterations, u within 1e-8;
   fp32 within the floor rule above) and at B=256, N=100 through
   ``auto``, fp32 and fp64, u[0] in its box, masked u exactly 0, every
   value finite, solves/s, host syncs and K4@9x16's share of the solve
   (CUDA events around each call); the reference's centroidal
   driver (``run_mpc``, fp64, N=100, max_iter=500) over its first 8
   steps, or to 3.0 s with ``--centroidal-driver``; a second-order
   cart-pole ``solve_batch`` (B=256, N=100, fp64, 50 iterations) on the
   card and its host's CPU, against the first-order optimum, and an
   explicit kernel raising; C/GMRES: the analytic damper's first 30
   control steps against the NumPy golden, the damper fleet (512
   controllers, 100 steps, fp32) timed with CUDA events (with
   ``--layers``: kernels a step and the device's busy share; one CUDA
   graph replayed a step, its first steps bit for bit against eager
   steps), the fp64 fleet's 10 chained steps, each against the same step
   on the card host's CPU from the same inputs, and the bounded cart-pole
   fleet inside its force bound;
7. the last modules: ``solve_lqr_parallel`` against
   ``solve_lqr_sequential`` (bench_all.py:277-301's LQR, N=2048, nx=8,
   nu=2, fp32 and fp64) on the card and its host's CPU, timed, and the
   horizon-sharded algorithm on four blocks in one process (``horizon``);
   a one-rank NCCL group (``mesh``): ``make_sharded_solve`` at the
   headline shape bit for bit against ``solve_batch``,
   ``convergence_stats`` through NCCL's all_reduce, the horizon-sharded
   LQR at sp=1; ``ls_mode="serial"`` at the headline shape, fp32 and
   fp64, against ``sweep`` (``serial``); the profiled DDP and FMPC
   solves against the untimed ones, with their CUDA-event phase times
   (``profiled``); the native executor's virtual-time swing-up, cut to 2
   s (500 solves on the card, tests/test_runtime.py's assertions) and 1 s
   of real-time mode, and the swingup example at its defaults, each in a
   process of its own (the example's started right after the build,
   ``examples-start``, beside phases 2-3), beside the other examples
   (constrained and fleet at their defaults, centroidal_jump's first 10
   steps with --profile) in this one (``runtime+examples``);
8. with ``--qp-groups`` only: K4 and K5 boxed built with 1, 4, 8 and 16
   threads per lane (and, with ``--baseline DIR``, from the headers of
   the checkout at DIR), each held to its plain version bit for bit and
   timed in turns, with ptxas' report of each; then K5 (unboxed) built
   with 0, 1, 2, 4 and 8 threads per lane and K1, K2 and K3 with 1, 2, 4
   and 8 at (4, 1), 1 and 2 at (2, 1), 1 and 4 at (8, 4) fp64 (and, with
   ``--baseline DIR``, K1, K2, K3 and K5 from that checkout): every one
   held bit for bit to G = 1, and K1, K2, K3 to the baseline's K1 at fp32
   and fp64, both reg_types, the headline, bipedal and tick shapes, a
   ragged B and N and (8, 4); timed in turns with the baseline's (K5 at
   the headline and tick shapes, K1, K2, K3 at the headline, bipedal and
   tick shapes with the pack), with ptxas' report of each; then
   (``wide-groups``) K1@9x16 at 8, 16 and 32 threads per lane and the
   baseline's, each with its nvcc seconds and ptxas' report, held bit for
   bit to the plain version on the card host's CPU at B=256, 37 and 1,
   fp32 and fp64, and timed in turns at B=256 and 1; then (``k4-wide``)
   K4@9x16, its profile build and the baseline's: check_rn_ops, each
   build's ptxas report and SASS counts, all bit for bit to each other
   with equal QP stats at B=256, 37 and 1, fp32 and fp64, both reg_types,
   timed in turns, and the profile's cycles a phase at B=256 and 1; then
   K8 and K10
   with 1, 2, 4 and 8 threads per lane at (4, 1, 4), 1, 2 and 4 at (2, 1,
   3), 1 and 2 at (2, 2, 2), each with the group's rows of P A, P B and P
   x_bar exchanged and computed by every thread, and K9 at each of those
   G and 8, 16 or 32 lanes a block (and, with ``--baseline DIR``, that
   checkout's K8, K9 and K10): every one bit for bit to G = 1 (K9: to K8
   at G = 1), K8 to the baseline's K8, K9, K10 and the baseline's K9 to
   K8, at fp32 and fp64, both ``break_if_llt_fails``, the FMPC shapes,
   the cart-pole at N=23, the two-input case and ragged B and N; timed in
   turns with the baseline's at the FMPC shapes, fp32 and fp64 (kernels
   alone, and K8's and K9's calls beside the baseline's with its
   condensation); then (``fwd-groups``) K6 and K7 at every chunk of
   stages of their TMA ring (1, 2, 4, 8) and at 0 (the register
   prefetch), and K11 at every (chunk, 1, 2 or 4 threads per lane) at (4,
   1), (2, 1) and (2, 2) (and, with ``--baseline DIR``, that checkout's
   K6, K7 and K11): every one bit for bit to the one-stage build and the
   baseline's, K11 to its plain version, K7's columns to K6's sums and to
   its wrapper's, at fp32 and fp64 on the headline, tick and boxed
   vertical shapes (K6, K7 at 11 alphas, and 10 at the headline), the
   FMPC shapes, the oscillator tick shape and the two-input problem (K11)
   and a ragged B and N; timed in turns with the baseline's, K6 and K7 (one
   alpha) on one warp (B=32, N=100: their chain floor), and (with
   ``--baseline``) K6's, K7's and K11's wrappers in turns with the
   baseline's wrappers; then (``fmpc-wide-groups``) K8-wide and K9-wide
   at the masses' (12, 3, 30), their profile build (clock64() cycles a
   part of the stage, and the producer's), K10-wide (and, with
   ``--baseline DIR``, that checkout's K8-wide and K9-wide), each with
   its ptxas report: all bit for bit with the baseline's K8-wide on the
   fmpc-wide cases (the masses at B=1024, 37 and 1, N=30 and 12; (16, 8,
   48) and (16, 16, 64)), fp32 and fp64, both ``break_if_llt_fails``;
   timed in turns at B=4096 and 1 (N=30; K9 at N=12) beside K10-wide,
   the profile's cycles a part printed, and K8-wide and K9-wide at (16,
   8, 48) and (16, 16, 64) timed in turns with the baseline's;
9. with ``--layers`` only: where one solve's time goes at both shapes,
   for each pair, for the boxed vertical solve, the bipedal config's
   ``auto`` path at 2 iterations and the FMPC configurations (synced time
   per solver layer, the device's busy time and launches from
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
import ctypes
import dataclasses
import functools
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from golden.cartpole_numpy import CartPoleGolden  # noqa: E402
from golden.cgmres_numpy import DamperGolden, GoldenCgmres  # noqa: E402
from golden.ddp_numpy import GoldenConfig, GoldenDDP  # noqa: E402
from golden.fmpc_numpy import (  # noqa: E402
    GoldenFmpc, GoldenFmpcConfig, OscillatorGolden)
from nmpc_tpu_torch.examples import centroidal_jump as ex_centroidal  # noqa: E402
from nmpc_tpu_torch.examples import constrained as ex_constrained  # noqa: E402
from nmpc_tpu_torch.examples import fleet as ex_fleet  # noqa: E402
from nmpc_tpu_torch.examples import swingup as ex_swingup  # noqa: E402
from nmpc_tpu_torch import (  # noqa: E402
    BoxQPConfig, CgmresConfig, CgmresSolver, CgmresState, DDPConfig,
    DDPSolver, DDPStatus, FmpcConfig, FmpcSolver, FmpcStatus,
    FmpcVariable, fmpc_variable_reset)
from nmpc_tpu_torch.core.integrators import INTEGRATORS  # noqa: E402
from nmpc_tpu_torch.core.problem import Problem  # noqa: E402
from nmpc_tpu_torch.kernels import build as kbuild  # noqa: E402
from nmpc_tpu_torch.kernels import ddp_backward_remat as remat  # noqa: E402
from nmpc_tpu_torch.kernels import ddp_forward_remat as fwd  # noqa: E402
from nmpc_tpu_torch.kernels import tileval  # noqa: E402
from nmpc_tpu_torch.kernels import ddp_backward_boxed as boxed  # noqa: E402
from nmpc_tpu_torch.kernels.ddp_backward import (  # noqa: E402
    StackedBounds, StackedDerivs, backward_stacked, backward_stacked_boxed)
from nmpc_tpu_torch.kernels import ddp_backward_fused as k1  # noqa: E402
from nmpc_tpu_torch.kernels.ddp_backward_fused import backward_fused  # noqa: E402
from nmpc_tpu_torch.kernels import fmpc_backward as k8  # noqa: E402
from nmpc_tpu_torch.kernels import fmpc_forward as k11  # noqa: E402
from nmpc_tpu_torch.models.cartpole_cgmres import (  # noqa: E402
    F_MAX, make_cartpole_cgmres_problem)
from nmpc_tpu_torch.models.centroidal import (  # noqa: E402
    example_ref_pos_func, make_centroidal_problem)
from nmpc_tpu_torch.models.damper import make_damper_problem  # noqa: E402
from nmpc_tpu_torch.models.bipedal import (  # noqa: E402
    example_omega2_func, example_ref_zmp_func, make_bipedal_problem)
from nmpc_tpu_torch.models.cartpole import (  # noqa: E402
    CartPoleCostWeight, CartPoleParam, cartpole_xdot,
    make_cartpole_fmpc_problem, make_cartpole_problem)
from nmpc_tpu_torch.models.oscillator import make_oscillator_problem  # noqa: E402
from nmpc_tpu_torch.models.vertical import (  # noqa: E402
    make_vertical_problem, num_contacts)
from nmpc_tpu_torch.mpc.closed_loop import (  # noqa: E402
    make_closed_loop, make_closed_loop_batch)
from nmpc_tpu_torch.mpc.driver import run_mpc, shift_warm_start  # noqa: E402
from nmpc_tpu_torch.parallel.horizon import (  # noqa: E402
    solve_lqr_horizon_blocks, solve_lqr_horizon_sharded)
from nmpc_tpu_torch.parallel.mesh import (  # noqa: E402
    convergence_stats, initialize_multihost, make_mesh, make_sharded_solve,
    shard_batch)
from nmpc_tpu_torch.runtime.executor import (  # noqa: E402
    MpcExecutor, WarmStartedSolve)
from nmpc_tpu_torch.solvers.parallel_riccati import (  # noqa: E402
    LQRStage, solve_lqr_parallel, solve_lqr_sequential)
from nmpc_tpu_torch.utils.profiled import (  # noqa: E402
    estimate_backward_split, profiled_solve_ddp, profiled_solve_fmpc)
from nmpc_tpu_torch.solvers import ddp as ddp_mod  # noqa: E402
from nmpc_tpu_torch.solvers import fmpc as fmpc_mod  # noqa: E402
from nmpc_tpu_torch.solvers.stages import _lanes as stages_lanes  # noqa: E402
from nmpc_tpu_torch.solvers.stages import _stage_derivs_sweep  # noqa: E402
from nmpc_tpu_torch.solvers.stages import _stage_times  # noqa: E402

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
# End-to-end fp32 contract of a kernel path against the plain path, as the
# port holds it (PERF.md §2): u normalized <= E2E_U_NORM and cost rel <=
# E2E_COST_REL (benchmarks/parity_gate.py:72-73).  Statuses and iterations
# may part where an accept or termination test sits at rounding level:
# every lane that parts is listed with its cost update and the threshold
# in ulp of its cost (decision_flips).  fp64 holds statuses and
# iterations equal.
E2E_U_NORM, E2E_COST_REL = 1e-2, 1e-4
# End-to-end fp64 contract of the boxed solves against the plain path.
E2E_U_NORM_FP64 = 1e-8
# fp32 lanes of the boxed solves whose status or iterations part from the
# plain path, per (model, path).  K4 and K5 boxed equal their plain
# versions bit for bit, so these come from the rest of each path (the
# fused rollouts) and must not move when the boxed kernels change.
BOXED_FP32_FLIPS = {("vertical", "K4"): 0, ("vertical", "auto"): 0,
                    ("cart-pole", "K4"): 0, ("cart-pole", "auto"): 647}
# fp32 lanes of the unboxed solves whose status or iterations part from
# the other path: the bipedal config per backward_dma against the plain
# path (K1, K2, K3 and plain rollouts), and the headline's mixed batch,
# auto (K5, K6, K7) against the plain path and against (pallas, scan).
# K1, K2, K3 and K5 build with -fmad=false, so the bipedal path follows the
# plain path's decisions (895 of 2048 parted with FMA contraction).
UNBOXED_FP32_FLIPS = {("bipedal", "stage"): 0, ("bipedal", "chunked"): 0,
                      ("bipedal", "packed"): 0, ("mixed", "plain"): 0,
                      ("mixed", "K1"): 0}
GOLDEN_TOL = 1e-8
# (backward_impl, forward_impl) pairs that are timed; "auto" resolves to
# the last on the card.
PAIRS = (("pallas", "scan"), ("pallas", "fused"), ("remat", "fused"))
# The card's published peaks (H100 SXM data sheet, at 700 W): device
# memory, float32 and float64 outside the tensor cores.
PEAK_BYTES_S, PEAK_FP32_S, PEAK_FP64_S = 3.35e12, 67e12, 34e12
# A 2x2 QP that takes 7 projected-Newton iterations from x0 = 0 under the
# default BoxQPConfig (more than its unroll_iter = 4), planted in one lane
# of K4's input: (H, g, lower, upper) with u = 0.
LONG_QP = ([[1.24, 1.82], [1.82, 2.68]], [2.42, 3.13], [-0.06, -0.9],
           [0.95, 0.52])
# FMPC (B, N): the cart-pole serving shape (benchmarks/bench_all.py:146-171,
# 5 iterations, kkt_error_thre=0, init_complementary_variable) and the
# oscillator's config #4 (:123-143, 5 iterations); the oscillator tick loop
# (256 controllers, 100 ticks, 3 iterations, tests/test_fmpc.py:53-82).
FMPC_SERVING = (4096, 100)
FMPC_OSC = (1024, 100)
FMPC_TICK = (256, 100)
FMPC_SIM_DT = 0.005
# fp32 FMPC contract on converged lanes (benchmarks/parity_gate.py:
# TOL_E2E_FMPC_U) and the fp64 kernel-path vs plain-path contract.
E2E_FMPC_U, E2E_FMPC_FP64 = 2e-4, 1e-8
# (backward_impl, forward_impl) pairs of the FMPC solve that are timed;
# "auto" resolves to the first on the card.
FMPC_PAIRS = (("pallas", "fused"), ("pallas", "scan"), ("stacked", "fused"),
              ("stacked", "scan"))


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
                 "nmpc_tpu_torch/csrc/ddp_backward.cuh",
                 "nmpc_tpu/kernels/ddp_backward_pallas.py:867"),
    "K1@9x16": Kernel("ddp_backward_fused@9x16", backward_fused,
                      "wide_launches",
                      "nmpc_tpu_torch/csrc/ddp_backward_wide.cuh",
                      "nmpc_tpu/kernels/ddp_backward_pallas.py:867"),
    "K2": Kernel("ddp_backward_chunked", backward_fused, "chunked_launches",
                 "nmpc_tpu_torch/csrc/ddp_backward_chunked.cuh",
                 "nmpc_tpu/kernels/ddp_backward_pallas.py:651"),
    "K3": Kernel("ddp_backward_packed", k1.backward_packed, "launches",
                 "nmpc_tpu_torch/csrc/ddp_backward_packed.cuh",
                 "nmpc_tpu/kernels/ddp_backward_pallas.py:1113"),
    "K2@9x16": Kernel("ddp_backward_chunked@9x16", backward_fused,
                      "chunked_wide_launches",
                      "nmpc_tpu_torch/csrc/ddp_backward_chunked_wide.cuh",
                      "nmpc_tpu/kernels/ddp_backward_pallas.py:651"),
    "K3@9x16": Kernel("ddp_backward_packed@9x16", k1.backward_packed,
                      "wide_launches",
                      "nmpc_tpu_torch/csrc/ddp_backward_packed_wide.cuh",
                      "nmpc_tpu/kernels/ddp_backward_pallas.py:1113"),
    "K4": Kernel("ddp_backward_boxed", boxed.backward_fused_boxed,
                 "launches", "nmpc_tpu_torch/csrc/ddp_backward_boxed.cuh",
                 "nmpc_tpu/kernels/ddp_backward_pallas.py:1018"),
    "K4@9x16": Kernel("ddp_backward_boxed@9x16", boxed.backward_fused_boxed,
                      "wide_launches",
                      "nmpc_tpu_torch/csrc/ddp_backward_boxed_wide.cuh",
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
    "K8": Kernel("fmpc_backward_fused", k8.backward_fmpc_fused, "launches",
                 "nmpc_tpu_torch/csrc/fmpc_backward.cuh",
                 "nmpc_tpu/kernels/fmpc_backward_pallas.py:558"),
    "K9": Kernel("fmpc_backward_resident", k8.backward_fmpc_fused,
                 "resident_launches",
                 "nmpc_tpu_torch/csrc/fmpc_backward_resident.cuh",
                 "nmpc_tpu/kernels/fmpc_backward_pallas.py:515"),
    "K10": Kernel("fmpc_backward_packed", k8.backward_fmpc_packed, "launches",
                  "nmpc_tpu_torch/csrc/fmpc_backward_packed.cuh",
                  "nmpc_tpu/kernels/fmpc_backward_pallas.py:632"),
    "K11": Kernel("forward_fmpc_deltas_fused", k11.forward_fmpc_deltas_fused,
                  "launches", "nmpc_tpu_torch/csrc/fmpc_forward.cuh",
                  "nmpc_tpu/kernels/fmpc_forward_pallas.py:113"),
    "K8@12x3x30": Kernel("fmpc_backward_fused@12x3x30",
                         k8.backward_fmpc_fused, "wide_launches",
                         "nmpc_tpu_torch/csrc/fmpc_backward_wide.cuh",
                         "nmpc_tpu/kernels/fmpc_backward_pallas.py:558"),
    "K9@12x3x30": Kernel("fmpc_backward_resident@12x3x30",
                         k8.backward_fmpc_fused, "resident_wide_launches",
                         "nmpc_tpu_torch/csrc/fmpc_backward_wide.cuh",
                         "nmpc_tpu/kernels/fmpc_backward_pallas.py:515"),
    "K10@12x3x30": Kernel("fmpc_backward_packed@12x3x30",
                          k8.backward_fmpc_packed, "wide_launches",
                          "nmpc_tpu_torch/csrc/fmpc_backward_packed_wide.cuh",
                          "nmpc_tpu/kernels/fmpc_backward_pallas.py:632"),
    "K11@12x3x30": Kernel("forward_fmpc_deltas_fused@12x3",
                          k11.forward_fmpc_deltas_fused, "wide_launches",
                          "nmpc_tpu_torch/csrc/fmpc_forward.cuh",
                          "nmpc_tpu/kernels/fmpc_forward_pallas.py:113"),
}
REMAT_PATH = ("K5", "K6", "K7")
FMPC_PATH = ("K8", "K11")
# The bipedal CoM-ZMP config #2 (benchmarks/bench_all.py:56-72): B=2048,
# N=300, 10 iterations, x0 ~ 0.05 N(0, 1), zero inputs, fp32; the walk
# ends at 20 s.  The generator rejects the model, so on the card it runs
# the sweep-fed kernels (K1, K2, K3 by backward_dma) and plain rollouts.
BIPEDAL = (2048, 300)
BIPEDAL_END_T = 20.0
DMA_KERNEL = {"stage": "K1", "chunked": "K2", "packed": "K3"}
# (nx, nu) the sweep-fed units are built at per dtype: the cart-pole, the
# bipedal model and, at fp64, the kernels' largest (WIDE_SWEEP), where
# K1's ring and K2's slots hold the fewest stages a block.
WIDE_SWEEP = (8, 4)
SWEEP_SHAPES = {torch.float32: ((4, 1), (2, 1)),
                torch.float64: ((4, 1), (2, 1), WIDE_SWEEP)}
# The receding-horizon driver: one bipedal controller, fp64, N=300,
# max_iter=500 (tests/test_ddp_models.py:22-40), from x=0 at t=0 to
# DRIVER_END (each solve's 3 s horizon crosses the footsteps at 1.5, 2
# and 3 s; a window across the first applied footstep, 155 solves of
# ~1.6 s, would take half the run's time limit; 10 steps, cut from 35 and
# then 15 to keep the run in its time limit); the plain path and
# make_closed_loop repeat the last DRIVER_WINDOW solves from the kernel
# path's state; the planned ZMP u[0] within ZMP_TOL of the reference at
# every step (TestDDPBipedal.cpp:252-273).
DRIVER_END, DRIVER_WINDOW, ZMP_TOL = 0.10, 5, 1e-2
# K9's design point: the oscillator at N=20, B=4096
# (nmpc_tpu/kernels/fmpc_backward_pallas.py:460-466), 5 iterations.
FMPC_OSC_SHORT = (4096, 20)
VARIANT_KERNEL = {"stream": "K8", "resident": "K9", "packed": "K10"}
# The centroidal model (nx = 9, 16 ridge forces; TestDDPCentroidalMotion.
# cpp:24-204) at bench_all.py:95-121's shape: B=256, N=100, dt 0.03, 3
# iterations, initial_lambda 1e-6, x0 about the standing pose (0.02 N(0,
# 1), seed 0), 5 N a ridge; from t0 = 1.3, so that the horizon crosses the
# flight phase (1.4-1.6 s, every input masked); the boxed solve's force
# limits.  The generator refuses the model (torch.linalg.cross), so auto
# runs K1 at (9, 16) unboxed and K4 at (9, 16) boxed, and the plain
# rollouts.
CENTROIDAL = (256, 100)
CENTROIDAL_DT, CENTROIDAL_T0, CENTROIDAL_ITERS = 0.03, 1.3, 3
CENTROIDAL_FORCE = (0.0, 1000.0)
# The horizon of the boxed solve held against the plain path, cut from
# 100: the plain BoxQP reads the host once per QP and Armijo trip of every
# stage (~400 reads an iteration at N=12), and at N=100 one plain solve
# had not ended after 15 minutes on the card.  12 stages from t0 = 1.3
# still cross the flight phase.  The boxed solve through K4@9x16 runs at
# the full N as well, and check_wide_k4 holds the kernel there.
CENTROIDAL_BOXED_N = 12
# K4@9x16's cases (dtype, reg_type), each held at the full N against its
# plain version on the card host's CPU, which BoxedReferences runs in
# processes of their own beside the phases before the centroidal one
# (inputs and results in REF_DIR; each must end within REF_DEADLINE_S of
# their start).
WIDE_K4_CASES = tuple((dtype, reg_type)
                      for dtype in (torch.float32, torch.float64)
                      for reg_type in (1, 2))
REF_DIR = kbuild.BUILD_DIR / "k4_reference"
REF_DEADLINE_S = 780.0
WIDE_K1 = (9, 16)
# K1@9x16's batches: the centroidal shape, a ragged 37 and run_mpc's
# one controller; the lanes the plain version on the card host's CPU is
# padded to (plain_on_host), and the threads per lane --qp-groups times
# (phase_wide_groups).
WIDE_K1_BATCHES = (CENTROIDAL[0], 37, 1)
PLAIN_LANES = 256
WIDE_GROUPS = (8, 16, 32)
# The reference's centroidal driver (tests/test_centroidal_and_utils.py:
# 22-39): one controller, fp64, N=100, max_iter=500, run_mpc from t=0 to
# 3.0 s: the final CoM within 1e-2 of the reference, momenta below 1.0,
# forces below 1e-12 through the flight; every step's planned position
# within 1.0 of the reference (TestDDPCentroidalMotion.cpp:318).  The
# default run takes its first CENTROIDAL_DRIVER_STEPS steps (every
# horizon crosses the flight phase; cut from 50, which reached into it,
# to make room for the runtime and examples phases, and from 10 for the
# check of K4@9x16's division and square root, check_rn_ops),
# --centroidal-driver the whole.
CENTROIDAL_DRIVER_END, CENTROIDAL_DRIVER_STEPS = 3.0, 8
# Second-order DDP (use_state_eq_second_derivative): cart-pole, B=256,
# N=100, fp64, max_iter=50, x0 hanging with the seed's spread; the plain
# backward on the card (auto) and on the card host's CPU, and the
# first-order optimum's cost (tests/test_centroidal_and_utils.py:77-95).
SECOND_ORDER = (256, 100)
SECOND_ORDER_COST_REL = 1e-5
# C/GMRES: the damper fleet of bench_all.py:204-234 (512 controllers
# about x_initial, 0.1 N(0, 1) from seed 0, 100 control steps, fp32) and
# the bounded cart-pole fleet at that shape; the golden's 30 steps; the
# fp64 fleet's 10 steps on the card and on its host's CPU.
CGMRES_FLEET = (512, 100)
CGMRES_GOLDEN_STEPS, CGMRES_FP64_STEPS, CGMRES_EAGER_STEPS = 30, 10, 3
CGMRES_TOL = 1e-10
# The parallel-in-time LQR of bench_all.py:277-301: (N, nx, nu).
LQR = (2048, 8, 2)
# The native executor's virtual-time swing-up (tests/test_runtime.py:
# 39-54, 6 s there), cut to 2 s, 500 solves, to keep the default run in
# its time limit: the pole is upright from ~1.3 s on (theta error 0.05,
# omega -0.03 at 2 s in a run of the port on the CPU), so the reference's
# final assertions still hold there.
RUNTIME_END = 2.0
RUNTIME_MPC_DT, RUNTIME_SIM_DT = 0.004, 0.002
# The centroidal jump example's steps in the examples phase (its first
# solve uncapped, then max_iter 3), with --profile.
CENTROIDAL_JUMP_STEPS = 10
# Timed headline solves of each (backward, forward) pair in the times
# phase after a warm one (cut from 10, then 5, to keep the run in its time
# limit on a slower card host).
HEADLINE_REPS = 3
# Ticks of each timed tick loop in the times phase (cut from 20 to make
# room for the runtime and examples phases, and from 10 for the fmpc-wide
# phase; the serving phase keeps 20).
TIMED_TICKS = 5


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


def host_us(fn, reps=20, inner=10, warmup=2):
    """Median over ``reps`` samples of the host's time per call in us,
    each sample ``inner`` back-to-back calls with no synchronize among
    them (the card drains between samples)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(inner):
            fn()
        times.append((time.perf_counter() - start) / inner * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def ptxas_report(lib):
    log = lib.with_suffix(".log")
    if not log.exists():
        return "cached build"
    return " | ".join(ln.split(":", 1)[-1].strip()
                      for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln)


def spill_bytes(lib):
    """(spill stores, spill loads) in bytes over the kernels of a built
    library, from ptxas' report beside it; None for a cached build."""
    log = lib.with_suffix(".log")
    if not log.exists():
        return None
    pairs = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       log.read_text())
    return (sum(int(s) for s, _ in pairs), sum(int(ld) for _, ld in pairs))


def phase_build():
    """Generate every unit (tracing runs one at a time), then start one
    nvcc per unit, all together."""
    cartpole = make_cartpole_problem(DT)
    start = time.perf_counter()
    units = []
    for dtype in (torch.float32, torch.float64):
        # the sweep-fed backward in its three layouts (K1, K2, K3): the
        # cart-pole, the bipedal model and, at fp64, the widest shape
        # (check_ragged)
        for nx, nu in SWEEP_SHAPES[dtype]:
            for dma in k1.DMA_MODES:
                units.append((k1.unit_name(nx, nu, dtype, dma),
                              k1.unit_source(nx, nu, dtype, dma),
                              k1.UNIT_FLAGS))
        units.append((remat.unit_name(dtype),
                      remat.unit_source(cartpole, 4, 1, dtype),
                      remat.unit_flags(False)))
        if dtype == torch.float64:   # K5 at nx = 8 (check_wide_remat)
            units.append((remat.unit_name(dtype),
                          remat.unit_source(PAIR, 8, 1, dtype),
                          remat.unit_flags(False)))
        units.append((fwd.unit_name(dtype),
                      fwd.unit_source(cartpole, 4, 1, dtype), ()))
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
        # FMPC: the oscillator, the constrained cart-pole, the two-input
        # problem of the non-PD check
        for nx, nu, ng in ((2, 1, 3), (4, 1, 4), (2, 2, 2)):
            for variant in k8.VARIANTS:
                units.append((k8.unit_name(nx, nu, ng, dtype, variant),
                              k8.unit_source(nx, nu, ng, dtype, variant),
                              k8.FMPC_FLAGS))
            units.append((k11.unit_name(nx, nu, dtype),
                          k11.unit_source(nx, nu, dtype), k8.FMPC_FLAGS))
        # K8-K11 at the wide shapes (phase_fmpc_wide): every variant at
        # the masses' (12, 3, 30), K8 and K10 past it (K9's horizon of
        # WIDE_FMPC_N does not fit a block there)
        for shape in (MASSES,) + WIDE_FMPC_SHAPES:
            for variant in (k8.VARIANTS if shape == MASSES
                            else ("stream", "packed")):
                units.append((k8.unit_name(*shape, dtype, variant),
                              k8.unit_source(*shape, dtype, variant),
                              k8.FMPC_FLAGS))
            units.append((k11.unit_name(*shape[:2], dtype),
                          k11.unit_source(*shape[:2], dtype), k8.FMPC_FLAGS))
        # K1, K2, K3 and K4 at the centroidal model's (9, 16)
        # (phase_centroidal)
        for dma in k1.DMA_MODES:
            units.append((k1.unit_name(*WIDE_K1, dtype, dma),
                          k1.unit_source(*WIDE_K1, dtype, dma),
                          k1.UNIT_FLAGS))
        units.append((boxed.unit_name(*WIDE_K1, dtype),
                      boxed.unit_source(*WIDE_K1, dtype), boxed.BOXED_FLAGS))
    # K4@9x16's fp32 division and square root alone (check_rn_ops)
    units.append(("rn_ops_check", RN_CHECK_UNIT, boxed.BOXED_FLAGS))
    gen_s = time.perf_counter() - start

    def compile_unit(unit):
        name, text, flags = unit
        begin = time.perf_counter()
        lib = kbuild.build_generated(name, text, flags)
        return lib, time.perf_counter() - begin

    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        built = list(pool.map(compile_unit, units))
    secs = time.perf_counter() - start
    wide_units = {k1.unit_name(*WIDE_K1, dtype, dma):
                  f"{DMA_KERNEL[dma]}@9x16"
                  for dtype in (torch.float32, torch.float64)
                  for dma in k1.DMA_MODES}
    wide_units.update({boxed.unit_name(*WIDE_K1, dtype): "K4@9x16"
                       for dtype in (torch.float32, torch.float64)})
    wide_units.update({
        k8.unit_name(*shape, dtype, variant):
            f"{VARIANT_KERNEL[variant]}@{'x'.join(map(str, shape))}"
        for dtype in (torch.float32, torch.float64)
        for shape in (MASSES,) + WIDE_FMPC_SHAPES
        for variant in k8.VARIANTS})
    wide_units.update({
        k11.unit_name(*shape[:2], dtype): f"K11@{shape[0]}x{shape[1]}"
        for dtype in (torch.float32, torch.float64)
        for shape in (MASSES,) + WIDE_FMPC_SHAPES})
    wide = ", ".join(f"{wide_units[name]} {lib.name} {unit_s:.1f} s"
                     for (name, _, _), (lib, unit_s) in zip(units, built)
                     if name in wide_units)
    print(f"[build] {len(built)} units in {secs:.1f} s (generation "
          f"{gen_s:.1f} s; nvcc of the wide units: {wide})", flush=True)
    for (name, _, flags), (lib, _) in zip(units, built):
        print(f"[build] ptxas {lib.name}{' ' + ' '.join(flags) if flags else ''}"
              f": {ptxas_report(lib)}", flush=True)
    for (name, _, _), (lib, _) in zip(units, built):
        if name in wide_units:
            key = wide_units[name]
            spills = spill_bytes(lib)
            print(f"[build] {key} {lib.name}: {ptxas_report(lib)}; spill "
                  f"stores / loads {spills} bytes", flush=True)
            # K1@9x16 at both dtypes, K2@9x16, K3@9x16 and K4@9x16 at
            # fp32 spill nothing; K4@9x16 at fp64 spills a few bytes
            # (ROADMAP R14: 774 before its redesign); the wide FMPC units
            # are printed
            if key == "K1@9x16" or ("float32" in name and "9x16" in key):
                check(spills in (None, (0, 0)), f"{key} ({lib.name}) "
                      f"spills")
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


# K5 at a state wider than the cart-pole's: (B, N) of the check
WIDE = (4096, 50)


def pair_problem():
    """Two cart-poles (pole lengths 2 m and 1 m) on one force, each with the
    cart-pole's weights about the origin: nx = 8, nu = 1, F = 154 fields a
    stage, whose K5 field slab at fp64 holds 16 lanes a block, not 32."""
    a, b = CartPoleParam(), CartPoleParam(pole_length=1.0)
    w = CartPoleCostWeight()

    def dynamics(t, x, u):
        # each pole's state by element (the kernel generator takes select
        # and stack, not slices)
        xa = torch.stack([x[0], x[1], x[2], x[3]])
        xb = torch.stack([x[4], x[5], x[6], x[7]])
        return torch.cat([xa + DT * cartpole_xdot(a, xa, u),
                          xb + DT * cartpole_xdot(b, xb, u)])

    def running_cost(t, x, u):
        wx = torch.tensor(w.running_x * 2, dtype=x.dtype, device=x.device)
        return (0.5 * torch.sum(wx * x**2)
                + 0.5 * w.running_u[0] * torch.sum(u**2))

    def terminal_cost(t, x):
        wx = torch.tensor(w.terminal_x * 2, dtype=x.dtype, device=x.device)
        return 0.5 * torch.sum(wx * x**2)

    return Problem(dt=DT, state_dim=8, input_dim=1, dynamics=dynamics,
                   running_cost=running_cost, terminal_cost=terminal_cost)


PAIR = pair_problem()


def check_wide_remat(device):
    """K5 through its wrapper at nx = 8, fp64, B=4096 (:func:`pair_problem`:
    a block of 16 lanes, its field slab within the 227 KB of shared memory)
    against its plain version: ok masks equal, the rest within
    KERNEL_TOL."""
    B, N = WIDE
    dtype = torch.float64
    rng = np.random.default_rng(8)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    cfg = DDPConfig(horizon_steps=N)
    x0s = (np.tile([0.0, np.pi, 0.0, 0.0], (B, 2))
           + 0.05 * rng.normal(size=(B, 8)))
    us = as_t(0.2 * rng.normal(size=(N, 1, B)))
    t0 = as_t(0.3)
    xs, _ = ddp_mod._rollout_lanes(PAIR, cfg, t0, as_t(x0s.T.copy()), us)
    VxT, VxxT = (a.contiguous() for a in ddp_mod._terminal_quad_lanes(
        PAIR, cfg, t0, xs))
    lam = torch.full((B,), 1e-4, dtype=dtype, device=device)
    plain = remat.backward_remat_plain(PAIR, cfg, t0, xs, us, VxT, VxxT, lam)
    out = remat.backward_remat(PAIR, cfg, t0, xs, us, VxT, VxxT, lam)
    torch.cuda.synchronize()
    label = f"K5 two cart-poles (8, 1) B={B} N={N} float64"
    ok_equal = torch.equal(plain[3], out[3])
    print(f"[kernel] {label}: ok lanes {int(out[3].sum())}/{B}, masks equal "
          f"{ok_equal}", flush=True)
    check(ok_equal and bool(out[3].all()), f"{label}: ok masks differ or a "
          "lane failed")
    report(label, {n: norm_err(a, b) for n, a, b in
                   zip(("ks", "Ks", "dV"), plain, out)}, dtype)


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
    check_fwd_ring(device)
    check_wide_remat(device)
    phase_kernels_boxed(device)


def check_fwd_ring(device):
    """K6 and K7 through their wrappers where they launch their TMA ring
    (``ref_chunk`` 8: the boxed vertical model's step, which the boxed
    vertical solve and its tick loop drive; the cart-pole's takes the
    register prefetch, held above; ``costs_chunk``: K7 on the vertical
    step) vs ``_forward_selected_lanes`` and ``_forward_costs_lanes``: the
    vertical model's first iteration at its solve and tick shapes and a
    ragged B=1023, N=37 (every reference copied once to a lane stride TMA
    takes), fp32 and fp64; K7's columns equal to K6's sums at the first
    and last alpha."""
    problem = vertical_problem()
    for dtype in (torch.float32, torch.float64):
        check(fwd.ref_chunk(problem, 2, 2, dtype) == 8
              and fwd.ref_chunk(make_cartpole_problem(DT), 4, 1, dtype) == 0,
              "K6's feed rule: the vertical step takes the ring, the "
              "cart-pole's the register prefetch")
        ring7 = fwd.costs_chunk(problem, 2, 2, dtype) > 0
        dname = str(dtype)[6:]
        for B, N in (VERTICAL, VERTICAL_TICK, (1023, 37)):
            _, t0, xs, us, ks, Ks, alpha = k6_inputs("vertical", B, N, dtype,
                                                     device)
            cfg = DDPConfig(horizon_steps=N)
            label = f"vertical B={B} N={N} {dname}"
            before = (fwd.forward_selected_remat.padded_copies,
                      fwd.forward_costs_remat.padded_copies)
            out = fwd.forward_selected_remat(problem, cfg, t0, xs, us, ks, Ks,
                                             alpha)
            alphas = torch.tensor(cfg.alpha_list, dtype=dtype, device=device)
            sums = fwd.forward_costs_remat(problem, cfg, t0, xs, us, ks, Ks,
                                           alphas)
            copies = (fwd.forward_selected_remat.padded_copies - before[0],
                      fwd.forward_costs_remat.padded_copies - before[1])
            plain = ddp_mod._forward_selected_lanes(problem, cfg, t0, xs, us,
                                                    ks, Ks, alpha, dtype)
            plain_sums = ddp_mod._forward_costs_lanes(
                problem, cfg, t0, xs, us, ks, Ks, alphas, dtype)
            torch.cuda.synchronize()
            err = report(f"K6 (TMA ring) {label}", {
                n: norm_err(a, b) for n, a, b in
                zip(("xs", "us", "costs", "sum"), plain, out)}, dtype)
            KERNELS["K6"].max_abs_err = max(KERNELS["K6"].max_abs_err, err)
            err = report(f"K7 ({'TMA ring' if ring7 else 'register'}) "
                         f"{label}", {"sums": norm_err(plain_sums, sums)},
                         dtype)
            KERNELS["K7"].max_abs_err = max(KERNELS["K7"].max_abs_err, err)
            same = [same_bits(sums[j], fwd.forward_selected_remat(
                problem, cfg, t0, xs, us, ks, Ks,
                alphas[j].expand(B).contiguous())[3])
                for j in (0, len(alphas) - 1)]
            check(all(same), f"K7 {label}: a column differs from K6's sum")
            untaken = sum((a.shape[-1] * a.element_size()) % 16 != 0
                          or a.data_ptr() % 16 != 0
                          for a in (xs, us, ks, Ks))
            check(copies == (untaken, untaken if ring7 else 0)
                  and (B != 1023 or copies[0] == 4),
                  f"K6/K7 {label}: {copies} references copied for TMA, "
                  f"{untaken} it does not take")


def boxed_bit_equal(plain, out):
    """Whether a boxed kernel's (ks, Ks, dV, ok) equal its plain version's
    bit for bit: ok masks equal, and every value of the lanes that are ok
    with finite gains (a NaN state leaves ok set with NaN gains)."""
    if not torch.equal(plain[3], out[3]):
        return False
    finite = lambda ks: torch.isfinite(ks).flatten(0, -2).all(0)
    lanes = plain[3] & finite(plain[0])
    return (torch.equal(lanes, out[3] & finite(out[0]))
            and all(torch.equal(a[..., lanes], b[..., lanes])
                    for a, b in zip(plain[:3], out[:3])))


def check_boxed(key, label, plain, out, B, config, stats, dtype):
    """Ok masks, errors (the boxed kernels equal their plain versions bit
    for bit) and the QP tails one boxed kernel check ran."""
    check_ok(f"{key} {label}", plain[3], out[3], B)
    err = report(f"{key} {label}", {
        n: norm_err(a, b, plain[3]) for n, a, b in
        zip(("ks", "Ks", "dV"), plain, out)}, dtype)
    check(boxed_bit_equal(plain, out),
          f"{key} {label}: not bit-equal to its plain version")
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
    for dtype in (torch.float32, torch.float64):
        check_exhausted(device, dtype)
    phase_kernels_fmpc(device)


def check_exhausted(device, dtype):
    """K4 and K5 boxed vs their plain versions where one lane's QP runs the
    whole Armijo schedule: ``min_step = 0``, so only the end of the
    max_ls_iter + 1 = 105 steps stops a search that never accepts, on
    vertical data of B = 1023 lanes (a ragged last block for every group
    size), with lane 4 made NaN (K4: a NaN lower bound at the last stage;
    K5 boxed: a NaN state mid-horizon).  Its Quu stays finite, so its QPs
    exhaust with NaN gains and ok set, in both versions: ok masks equal,
    the NaN lane's gains non-finite in both, the rest bit for bit."""
    B, N = VERTICAL[0] - 1, VERTICAL[1]
    dname = str(dtype)[6:]
    config = boxed_config(N, boxqp=BoxQPConfig(min_step=0.0))
    lam = torch.full((B,), 1e-6, dtype=dtype, device=device)
    n_ls = config.boxqp.max_ls_iter + 1
    D, bnd, VxT, VxxT = boxed_derivs("vertical", B, N, dtype, device)
    bnd.lower[N - 1, 0, 4] = float("nan")
    problem, t0, xs, us, VxT5, VxxT5 = boxed_remat_inputs(
        "vertical", B, N, dtype, device)
    xs[N // 2, 0, 4] = float("nan")
    Dr = _stage_derivs_sweep(problem, config, t0, xs, us)
    runs = {
        "K4": (lambda stats: backward_stacked_boxed(
                   config, D, bnd, VxT, VxxT, lam, stats=stats),
               lambda: boxed.backward_fused_boxed(config, D, bnd, VxT, VxxT,
                                                  lam)),
        "K5b": (lambda stats: backward_stacked_boxed(
                    config, StackedDerivs(*Dr[:7]), StackedBounds(*Dr[-3:]),
                    VxT5, VxxT5, lam, stats=stats),
                lambda: remat.backward_remat(problem, config, t0, xs, us,
                                             VxT5, VxxT5, lam, boxed=True))}
    for key, (plain_fn, kernel_fn) in runs.items():
        stats = {}
        plain = plain_fn(stats)
        out = kernel_fn()
        torch.cuda.synchronize()
        visits = int(stats["ls_candidates"][:, 4].max())
        nan_lane = bool(out[3][4]) and not any(
            bool(torch.isfinite(r[0][..., 4]).all()) for r in (plain, out))
        equal = boxed_bit_equal(plain, out)
        print(f"[kernel] {key} exhausted schedule vertical B={B} N={N} "
              f"{dname} min_step=0: the NaN lane visits {visits} of {n_ls} "
              f"Armijo candidates in one iteration, ok with NaN gains in "
              f"both {nan_lane}; ok lanes {int(out[3].sum())}/{B}, equal to "
              f"the plain version bit for bit {equal}", flush=True)
        check(visits == n_ls, f"{key} {dname}: the NaN lane did not run the "
              "whole Armijo schedule")
        check(nan_lane and equal, f"{key} exhausted schedule {dname}: "
              "kernel and plain version differ")


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


def solve_counted(problem, cfg, x0s, us0, t0=0.0, **solver_kw):
    """One solve_batch with every launch counter reset just before and
    read just after."""
    solver = DDPSolver(problem, cfg, **solver_kw)
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
            else:
                want = UNBOXED_FP32_FLIPS["mixed", other]
                check(len(flips) == want, f"mixed batch fp32: {len(flips)} "
                      f"lanes part from {other}, {want} expected")

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
                    else:
                        want = BOXED_FP32_FLIPS[model, name]
                        check(len(flips) == want, f"boxed {model} fp32 "
                              f"{name}: {len(flips)} lanes part from the "
                              f"plain path, {want} expected")
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
    phase_e2e_fmpc(device)


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
    phase_serving_fmpc(device, card)


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


def bound(nbytes, ops, dtype=torch.float32):
    """(least time in ms, which term bounds it): bytes over the card's
    memory rate, operations over its peak for ``dtype`` (float32 or
    float64, outside the tensor cores)."""
    peak = PEAK_FP64_S if dtype == torch.float64 else PEAK_FP32_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / peak * 1e3
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
        for key, stats in (("K4", stats4), ("K5b", stats5)):
            print(qp_line(key, f"{model} B={B} N={N}", stats), flush=True)
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
                        plain_reps=1)

    B, N = HEADLINE
    problem = make_cartpole_problem(DT)
    x0s, us0 = hanging_inputs(B, N, torch.float32, device)
    for pair in PAIRS:
        solver = DDPSolver(problem, DDPConfig(
            horizon_steps=N, max_iter=10, backward_impl=pair[0],
            forward_impl=pair[1]))
        secs = timed_solves(solver, x0s, us0, HEADLINE_REPS)
        print(f"[times] solve_batch B={B} N={N} max_iter=10 fp32 "
              f"backward={pair[0]} forward={pair[1]}: median "
              f"{statistics.median(secs):.4f} s, "
              f"{B / statistics.median(secs):.1f} solves/s, host syncs "
              f"{solver.host_syncs} [{card}]", flush=True)
    for pair in PAIRS:
        tick_loop(device, problem, pair, n_ticks=1)   # warm-up
        ms, _ = tick_loop(device, problem, pair, n_ticks=TIMED_TICKS)
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
                            else 5)
        print(f"[times] boxed vertical solve_batch B={B} N={N} max_iter=3 "
              f"fp32 backward={pair[0]} forward={pair[1]}: median "
              f"{statistics.median(secs):.4f} s, "
              f"{B / statistics.median(secs):.1f} solves/s, host syncs "
              f"{solver.host_syncs} [{card}]", flush=True)
    phase_times_fmpc(device, card)


def qp_group() -> int:
    """The boxed kernels' threads per lane, kQpGroup of csrc/boxqp.cuh."""
    text = (kbuild.CSRC / "boxqp.cuh").read_text()
    return int(re.search(r"constexpr int kQpGroup = (\d+);", text).group(1))


def qp_line(key, label, stats):
    """The QP work a boxed kernel's input needs, from its plain version's
    ``stats`` [N, B]: per lane and stage, QP iterations and Armijo
    candidates (mean, p99, max); per (warp, stage), the slowest lane's, for
    warps of 32 lanes (a thread per lane) and of 32 / kQpGroup lanes."""
    G = qp_group()
    parts = []
    for name, what in (("qp_iters", "QP iterations"),
                       ("ls_evals", "Armijo candidates")):
        a = stats[name].double().cpu()
        warp = []
        for lanes in (32, 32 // G):
            padded = torch.nn.functional.pad(a, (0, (-a.shape[1]) % lanes))
            warp.append(padded.reshape(a.shape[0], -1, lanes).amax(-1)
                        .mean().item())
        parts.append(f"{what} mean {a.mean().item():.3f}, p99 "
                     f"{torch.quantile(a.flatten(), 0.99).item():.0f}, max "
                     f"{a.max().item():.0f}, slowest lane of a warp of 32 "
                     f"lanes {warp[0]:.3f}, of {32 // G} lanes {warp[1]:.3f}")
    return (f"[qp] {key} {label} fp32 (the timed input; the plain "
            f"version's counts) per lane and stage: {'; '.join(parts)}")


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
    and keep them in the record when ``keep``.  A plain version timed once
    (seconds a call) is timed without a warm-up call: the kernel checks
    ran it already."""
    t_kern = cuda_ms(kernel, inner=10)
    t_plain = cuda_ms(plain, reps=plain_reps,
                      warmup=1 if plain_reps > 1 else 0)
    t_bound, by = bound(nbytes, ops)
    gbs = nbytes / (t_kern * 1e-3) / 1e9
    print(f"[times] {key} {KERNELS[key].name} {label} fp32: kernel "
          f"{t_kern:.4f} ms ({gbs:.1f} GB/s of {nbytes / 1e6:.2f} MB, "
          f"{ops / 1e6:.1f} M ops), plain {t_plain:.3f} ms, bound "
          f"{t_bound * 1e3:.2f} us ({by}) [{card}]", flush=True)
    if keep:
        k = KERNELS[key]
        k.ms, k.plain_ms, k.bound_ms, k.bound_by = t_kern, t_plain, t_bound, by


# The threads per lane --qp-groups builds the boxed kernels at.
QP_GROUPS = (1, 4, 8, 16)


def phase_qp_groups(device, card, baseline):
    """K4 and K5 boxed built at every group size of QP_GROUPS and, with
    ``baseline`` (another checkout's root), from that checkout's headers
    at its own geometry: all built at once, each held to the plain
    version bit for bit, then timed on the inputs of phase 5 in turns
    (every variant once, then again in reverse order)."""
    variants = [(f"G={g}", g, kbuild.CSRC) for g in QP_GROUPS]
    if baseline:
        variants.insert(0, ("baseline", None,
                            Path(baseline).resolve() / "nmpc_tpu_torch"
                            / "csrc"))
    models = {"vertical": (VERTICAL, vertical_problem()),
              "cart-pole": (HEADLINE, boxed_cartpole())}
    units = []
    for (B, N), problem in models.values():
        nx, nu = problem.state_dim, problem.input_dim
        for _, group, csrc in variants:
            units.append((boxed.unit_name(nx, nu, torch.float32, group),
                          boxed.unit_source(nx, nu, torch.float32, group),
                          boxed.BOXED_FLAGS, csrc))
            units.append((remat.unit_name(torch.float32, True, group),
                          remat.unit_source(problem, nx, nu, torch.float32,
                                            True, group),
                          remat.unit_flags(True), csrc))
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        libs = list(pool.map(lambda u: kbuild.build_generated(*u), units))
    print(f"[qp-groups] {len(libs)} units in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    for (name, _, _, csrc), lib in zip(units, libs):
        print(f"[qp-groups] ptxas {lib.name} (headers "
              f"{os.path.relpath(csrc, ROOT)}): {ptxas_report(lib)}",
              flush=True)
    for model, ((B, N), problem) in models.items():
        nx, nu = problem.state_dim, problem.input_dim
        dtype = torch.float32
        cfg = boxed_config(N)
        lam = torch.full((B,), 1e-6, device=device)
        D, bnd, VxT, VxxT = boxed_derivs(model, B, N, dtype, device)
        _, t0, xs, us, VxT5, VxxT5 = boxed_rollout(model, B, N, dtype,
                                                   device)
        plain = {"K4": backward_stacked_boxed(cfg, D, bnd, VxT, VxxT, lam),
                 "K5b": remat.backward_remat_plain(
                     problem, cfg, t0, xs, us, VxT5, VxxT5, lam, boxed=True)}
        calls = {}
        for label, group, csrc in variants:
            f4 = boxed.launcher(nx, nu, dtype, group, csrc)
            f5 = remat.launcher(problem, nx, nu, dtype, True, group, csrc)
            calls["K4", label] = functools.partial(
                boxed.launch, f4, cfg, D, bnd, VxT, VxxT, lam)
            calls["K5b", label] = functools.partial(
                remat.launch, f5, problem, cfg, t0, xs, us, VxT5, VxxT5, lam,
                True)
        for (key, label), fn in calls.items():
            out = fn()
            torch.cuda.synchronize()
            check(boxed_bit_equal(plain[key], out),
                  f"{key} {model} {label}: not bit-equal to the plain "
                  "version")
        times = collections.defaultdict(list)
        for order in (list(calls), list(reversed(calls))):
            for key in order:
                times[key].append(cuda_ms(calls[key], inner=10))
        for (key, label), ms in times.items():
            print(f"[qp-groups] {key} {model} B={B} N={N} fp32 {label}: "
                  f"{ms[0]:.4f} / {ms[1]:.4f} ms (in turns), bit-equal to "
                  f"the plain version [{card}]", flush=True)


# The threads per lane --qp-groups builds the unboxed group kernels (K1,
# K2, K3, K5) at, per (nx, nu); K5 also at 0 (one thread per lane, the
# fields in registers, the geometry of an F whose slab no block holds);
# the widest sweep-fed shape (fp64 only) at one thread and kRowGroup.
ROW_GROUPS = {(4, 1): (1, 2, 4, 8), (2, 1): (1, 2), WIDE_SWEEP: (1, 4)}
REMAT_GROUPS = (0,) + ROW_GROUPS[4, 1]
# The inputs K1, K2 and K3 are held to the baseline's K1 on (model, (B, N),
# timed at fp32): the headline, bipedal and tick shapes (timed), a ragged
# B and N (K1's fields copied to a padded stride; N past no multiple of a
# ring or chunk) and the widest shape (fp64).
SWEEP_CASES = (("cart-pole", HEADLINE, True), ("bipedal", BIPEDAL, True),
               ("cart-pole", TICK, True), ("cart-pole", (1023, 37), False),
               ("wide", (1023, 37), False))


def same_bits(a, b):
    """Whether two outputs are equal bit for bit, NaN lanes included (the
    card makes one canonical NaN)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    view = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def parent_module(baseline, name):
    """Another checkout's ``nmpc_tpu_torch/kernels/<name>.py``, loaded
    under a name of its own (its imports resolve to this checkout)."""
    path = Path(baseline) / "nmpc_tpu_torch" / "kernels" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"baseline_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed_in_turns(calls, label, card, note="", tag="row-groups",
                   dtype="fp32"):
    """Time every call once in order, then again in reverse order, and
    print both times of each."""
    times = collections.defaultdict(list)
    for order in (list(calls), list(reversed(calls))):
        for key in order:
            times[key].append(cuda_ms(calls[key], inner=10))
    for key, ms in times.items():
        print(f"[{tag}] {label} {dtype} {key}: {ms[0]:.4f} / {ms[1]:.4f} "
              f"ms (in turns){note} [{card}]", flush=True)


def sweep_inputs(model, B, N, dtype, device):
    """(D, Vx_T, Vxx_T) of a SWEEP_CASES entry."""
    if model == "wide":
        return wide_derivs(B, N, dtype, device)
    return (rollout_derivs if model == "cart-pole" else bipedal_derivs)(
        B, N, dtype, device)


def phase_row_groups(device, card, baseline):
    """K5 (unboxed) built at every group size of REMAT_GROUPS and K1, K2
    and K3 at every one of ROW_GROUPS and, with ``baseline`` (another
    checkout's root), K1, K2, K3 and K5 from that checkout's headers, unit
    text and flags: all built at once with ptxas' report of each.  K5:
    every G held bit for bit to G = 1 (NaN lanes included), G = 1 to its
    plain version within KERNEL_TOL, fp32 and fp64.  K1, K2, K3: on every
    input of SWEEP_CASES at fp32 and fp64 (the widest shape fp64 only) and
    both reg_types, every G bit for bit to the same kernel at G = 1 and,
    on its ok lanes with the same ok mask, to the baseline's K1 (without a
    baseline: this K1 at G = 1).  Then each family timed on the inputs of
    phase 5 in turns with the baseline's: K5 at the headline and tick
    shapes, K1, K2, K3 at the headline, bipedal and tick shapes (K3 with
    its pack timed apart, K1's padding copies at the ragged shape)."""
    parent_csrc = (Path(baseline).resolve() / "nmpc_tpu_torch" / "csrc"
                   if baseline else None)
    cart = make_cartpole_problem(DT)
    fp32, fp64 = torch.float32, torch.float64
    units, index = [], {}

    def unit(key, name, text, flags, csrc=kbuild.CSRC):
        index[key] = len(units)
        units.append((name, text, flags, csrc))

    for dtype in (fp32, fp64):
        for g in REMAT_GROUPS:
            unit(("K5", dtype, g), remat.unit_name(dtype, False, g),
                 remat.unit_source(cart, 4, 1, dtype, False, g),
                 remat.unit_flags(False))
        for nx, nu in SWEEP_SHAPES[dtype]:
            for dma in k1.DMA_MODES:
                for g in ROW_GROUPS[nx, nu]:
                    unit((dma, nx, nu, dtype, g),
                         k1.unit_name(nx, nu, dtype, dma, g),
                         k1.unit_source(nx, nu, dtype, dma, g),
                         k1.UNIT_FLAGS)
    if baseline:
        pk = parent_module(baseline, "ddp_backward_fused")
        pr = parent_module(baseline, "ddp_backward_remat")
        for dtype in (fp32, fp64):
            for nx, nu in SWEEP_SHAPES[dtype]:
                for dma in k1.DMA_MODES:
                    unit(("baseline", dma, nx, nu, dtype),
                         k1.unit_name(nx, nu, dtype, dma) + "_parent",
                         pk.unit_source(nx, nu, dtype, dma), pk.UNIT_FLAGS,
                         parent_csrc)
        unit("K5 baseline", remat.unit_name(fp32) + "_parent",
             pr.unit_source(cart, 4, 1, fp32), pr.unit_flags(False),
             parent_csrc)
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        libs = list(pool.map(lambda u: kbuild.build_generated(*u), units))
    print(f"[row-groups] {len(libs)} units in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    for (name, _, flags, csrc), path in zip(units, libs):
        print(f"[row-groups] ptxas {path.name} (headers "
              f"{os.path.relpath(csrc, ROOT)}, flags {' '.join(flags) or '-'}"
              f"): {ptxas_report(path)}", flush=True)
    loaded = {}

    def lib(key):
        """The library built for ``key``, loaded once."""
        if key not in loaded:
            loaded[key] = kbuild.load(libs[index[key]])
        return loaded[key]

    # K5: every G against G = 1 and the plain version
    for B, N in (HEADLINE, TICK):
        for dtype in (fp32, fp64):
            problem, t0, xs, us, VxT, VxxT = remat_inputs(B, N, dtype,
                                                          device)
            cfg = DDPConfig(horizon_steps=N)
            lam = torch.full((B,), 1e-4, dtype=dtype, device=device)
            label = f"K5 B={B} N={N} {str(dtype)[6:]}"
            plain = remat.backward_remat_plain(problem, cfg, t0, xs, us, VxT,
                                               VxxT, lam)
            calls = {f"G={g}": functools.partial(
                remat.launch, remat.bind(lib(("K5", dtype, g))), problem,
                cfg, t0, xs, us, VxT, VxxT, lam)
                for g in REMAT_GROUPS}
            outs = {key: fn() for key, fn in calls.items()}
            torch.cuda.synchronize()
            ref = outs["G=1"]
            check_ok(label + " G=1", plain[3], ref[3], B)
            report(label + " G=1", {n: norm_err(a, b, plain[3]) for n, a, b
                                    in zip(("ks", "Ks", "dV"), plain, ref)},
                   dtype)
            equal_g = {key: all(same_bits(a, b) for a, b in zip(ref, out))
                       for key, out in outs.items()}
            plain_bits = bit_equal(plain[:3], ref[:3], plain[3])
            print(f"[row-groups] {label}: bit-equal to G=1 {equal_g}; G=1 "
                  f"bit-equal to the plain version on its ok lanes "
                  f"{plain_bits}", flush=True)
            check(all(equal_g.values()), f"{label}: a G differs from G=1")
            if dtype == fp32:
                # timed on phase 5's clean rollout: a NaN state sends sin
                # and cos down their slow path in its lane's warp
                problem, t0, xs, us, VxT, VxxT = rollout(B, N, dtype, device)
                args = (problem, cfg, t0, xs, us, VxT, VxxT, lam)
                calls = {f"G={g}": functools.partial(
                    remat.launch, remat.bind(lib(("K5", dtype, g))), *args)
                    for g in REMAT_GROUPS}
                if baseline:
                    calls["baseline"] = functools.partial(
                        remat.launch, pr.bind(lib("K5 baseline"), False),
                        *args)
                timed_in_turns(calls, f"K5 B={B} N={N}", card)

    # K1, K2, K3: every G against G = 1 and the baseline's K1
    for model, (B, N), timed in SWEEP_CASES:
        for dtype in (fp32, fp64):
            if model == "wide" and dtype == fp32:
                continue
            D, VxT, VxxT = sweep_inputs(model, B, N, dtype, device)
            nx, nu = D.Fx.shape[1], D.Fu.shape[2]
            fields, ld1 = k1.tma_fields(D)
            P, ld3 = k1.padded_packed(k1.pack_derivs(D))
            data = {"stage": (fields, ld1), "chunked": (D, 0),
                    "packed": ((P,), ld3)}
            for reg_type, lam_val in ((1, 1e-4), (2, 0.5)):
                cfg = DDPConfig(horizon_steps=N, reg_type=reg_type)
                lam = torch.full((B,), lam_val, dtype=dtype, device=device)
                calls = {f"{DMA_KERNEL[dma]} G={g}": functools.partial(
                    k1.launch, k1.bind(lib((dma, nx, nu, dtype, g))), dma,
                    cfg, N, nx, nu, *data[dma][:1], VxT, VxxT, lam,
                    data[dma][1])
                    for dma in k1.DMA_MODES for g in ROW_GROUPS[nx, nu]}
                if baseline:
                    for dma in k1.DMA_MODES:
                        calls[f"{DMA_KERNEL[dma]} baseline"] = (
                            functools.partial(
                                pk.launch,
                                pk.bind(lib(("baseline", dma, nx, nu,
                                             dtype))),
                                dma, cfg, N, nx, nu, *data[dma][:1], VxT,
                                VxxT, lam, data[dma][1]))
                outs = {key: fn() for key, fn in calls.items()}
                torch.cuda.synchronize()
                ref = outs["K1 baseline" if baseline else "K1 G=1"]
                label = (f"K1/K2/K3 {model} ({nx}, {nu}) B={B} N={N} "
                         f"{str(dtype)[6:]} reg_type={reg_type}")
                to_ref = {key: torch.equal(ref[3], out[3])
                          and bit_equal(ref[:3], out[:3], ref[3])
                          for key, out in outs.items()}
                to_g1 = {key: all(same_bits(a, b) for a, b in zip(
                    outs[key.split()[0] + " G=1"], out))
                    for key, out in outs.items() if "G=" in key}
                print(f"[row-groups] {label}: ok lanes "
                      f"{int(ref[3].sum())}/{B}; bit-equal to the "
                      f"{'baseline' if baseline else 'G=1'} K1 on its ok "
                      f"lanes {to_ref}; bit-equal to the kernel's G=1 "
                      f"{to_g1}", flush=True)
                check(all(to_ref.values()) and all(to_g1.values()),
                      f"{label}: a kernel differs from the reference K1 or "
                      f"from its G=1")
                if not (timed and dtype == fp32 and reg_type == 1):
                    continue
                calls["pack_derivs"] = functools.partial(k1.pack_derivs, D)
                timed_in_turns(calls, f"{model} B={B} N={N}", card)
    D, VxT, VxxT = rollout_derivs(1023, HEADLINE[1], fp32, device)
    t_pad = cuda_ms(functools.partial(k1.tma_fields, D), inner=10)
    print(f"[row-groups] K1's padding copies (tma_fields, seven fields) "
          f"cart-pole B=1023 N={HEADLINE[1]} fp32: {t_pad:.4f} ms [{card}]",
          flush=True)
    # what bounds a lane's stage: one lane per SM against 31
    B1, N = 132, HEADLINE[1]
    G4 = ROW_GROUPS[4, 1][2]
    per_stage = {}
    for B in (B1, HEADLINE[0]):
        D, VxT, VxxT = rollout_derivs(B, N, fp32, device)
        cfg = DDPConfig(horizon_steps=N)
        lam = torch.full((B,), 1e-4, device=device)
        per_stage[B] = [cuda_ms(functools.partial(
            k1.launch, k1.bind(lib(("stage", 4, 1, fp32, g))), "stage", cfg,
            N, 4, 1, D, VxT, VxxT, lam, B), inner=10) * 1e3 / N
            for g in (1, G4)]
    print(f"[row-groups] a lane's stage, K1 cart-pole N={N} fp32: G=1 "
          f"{per_stage[B1][0]:.3f} us at B={B1} (a lane per SM) / "
          f"{per_stage[HEADLINE[0]][0]:.3f} us at B={HEADLINE[0]}; G={G4} "
          f"{per_stage[B1][1]:.3f} / {per_stage[HEADLINE[0]][1]:.3f} us "
          f"[{card}]", flush=True)


def phase_wide_groups(device, card, baseline):
    """K1@9x16 built at every group size of WIDE_GROUPS and, with
    ``baseline`` (another checkout's root), from that checkout's headers
    and unit text (its K1 at (9, 16)): all at once, with each unit's nvcc
    seconds and ptxas' report.  Every one held bit for bit to the plain
    version on the card host's CPU on its ok lanes with the same ok mask
    (hold_wide_k1), and the builds to each other NaN lanes included, at
    B=256, 37 and 1, fp32 and fp64, both reg_types; then timed in turns at
    B=256 and B=1 (one lane: the chain floor, and run_mpc's batch),
    fp32 and fp64, reg_type 1, on the data without its non-PD and NaN
    lanes."""
    nx, nu = WIDE_K1
    N = CENTROIDAL[1]
    fp32, fp64 = torch.float32, torch.float64
    units, keys = [], []
    for dtype in (fp32, fp64):
        for g in WIDE_GROUPS:
            keys.append((dtype, f"G={g}"))
            units.append((k1.unit_name(nx, nu, dtype, "stage", g),
                          k1.unit_source(nx, nu, dtype, "stage", g),
                          k1.UNIT_FLAGS, kbuild.CSRC))
    if baseline:
        pk = parent_module(baseline, "ddp_backward_fused")
        for dtype in (fp32, fp64):
            keys.append((dtype, "baseline"))
            units.append((k1.unit_name(nx, nu, dtype) + "_parent",
                          pk.unit_source(nx, nu, dtype), pk.UNIT_FLAGS,
                          Path(baseline).resolve() / "nmpc_tpu_torch"
                          / "csrc"))

    def compile_unit(unit):
        begin = time.perf_counter()
        lib = kbuild.build_generated(*unit)
        return lib, time.perf_counter() - begin

    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        built = list(pool.map(compile_unit, units))
    print(f"[wide-groups] {len(built)} units in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    fns = {}
    for (dtype, label), (_, _, _, csrc), (lib, secs) in zip(keys, units,
                                                           built):
        print(f"[wide-groups] K1@9x16 {str(dtype)[6:]} {label} {lib.name} "
              f"(headers {os.path.relpath(csrc, ROOT)}): nvcc {secs:.1f} s; "
              f"{ptxas_report(lib)}; spill stores / loads "
              f"{spill_bytes(lib)} bytes", flush=True)
        mod = pk if label == "baseline" else k1
        fns[dtype, label] = (mod, mod.bind(kbuild.load(lib)))
    for dtype in (fp32, fp64):
        for B in WIDE_K1_BATCHES:
            for reg_type in (1, 2):
                cfg, D, VxT, VxxT, lam = wide_k1_case(B, dtype, device,
                                                      reg_type)
                fields, ld = k1.tma_fields(D)
                calls = {label: functools.partial(
                    mod.launch, fn, "stage", cfg, N, nx, nu, fields, VxT,
                    VxxT, lam, ld)
                    for (dt, label), (mod, fn) in fns.items() if dt == dtype}
                outs = {label: fn() for label, fn in calls.items()}
                torch.cuda.synchronize()
                host = plain_on_host(cfg, D, VxT, VxxT, lam)
                label = (f"K1@9x16 centroidal B={B} N={N} {str(dtype)[6:]} "
                         f"reg_type={reg_type}")
                held = {key: hold_wide_k1(f"{label} {key}", host, out, B,
                                          device)[0]
                        for key, out in outs.items()}
                first = next(iter(outs.values()))
                same = {key: all(same_bits(a, b) for a, b in zip(first, out))
                        for key, out in outs.items()}
                print(f"[wide-groups] {label}: ok lanes {held}, each bit for "
                      f"bit to the plain version on the host CPU on its ok "
                      f"lanes; bit for bit to each other {same}", flush=True)
                check(all(same.values()), f"{label}: the builds part")
                if reg_type != 1 or B not in (CENTROIDAL[0], 1):
                    continue
                cfg, D, VxT, VxxT, lam = wide_k1_case(B, dtype, device, 1,
                                                      poison=False)
                fields, ld = k1.tma_fields(D)
                calls = {label: functools.partial(
                    mod.launch, fn, "stage", cfg, N, nx, nu, fields, VxT,
                    VxxT, lam, ld)
                    for (dt, label), (mod, fn) in fns.items() if dt == dtype}
                timed_in_turns(calls, f"K1@9x16 centroidal B={B} N={N} "
                               "(no non-PD or NaN lane)", card,
                               tag="wide-groups", dtype=str(dtype)[6:])


def sass_counts(lib):
    """What a built library's SASS (``cuobjdump -sass``) holds: local
    loads and stores (LDL, STL), the calls (the IEEE division's and square
    root's slow paths) by callee, MUFU.RCP / MUFU.RSQ (the fast paths'
    seeds), shuffles, warp syncs and all instructions; None where the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     text)
    count = collections.Counter(op.split(".")[0] for op in ops)
    mufu = collections.Counter(op for op in ops if op.startswith("MUFU"))
    calls = collections.Counter(re.findall(r"CALL\.\w+(?:\.\w+)*\s+`?\(?"
                                           r"([\w$]+)", text))
    return {"instructions": len(ops), "LDL": count["LDL"],
            "STL": count["STL"], "CALL": dict(calls), "MUFU": dict(mufu),
            "SHFL": count["SHFL"], "WARPSYNC": count["WARPSYNC"],
            "BAR": count["BAR"], "BRA": count["BRA"], "BSSY": count["BSSY"],
            "LDS": count["LDS"], "STS": count["STS"]}


# csrc/rn_ops.cuh's division and square root on the card: one thread a
# value, RnOps<T> on (a, b) and x, at fp32 and fp64.
RN_CHECK_UNIT = r"""
#include "rn_ops.cuh"

template <typename T>
__global__ void rn_check_kernel(const T* a, const T* b, const T* x, int n,
                                T* q, unsigned char* tiny, T* s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool t = false;
  q[i] = nmpc::RnOps<T>::div(a[i], nmpc::RnOps<T>::rcp(b[i]), t);
  bool u = false;
  s[i] = nmpc::RnOps<T>::sqrt_pos(x[i], u);
  tiny[i] = (t ? 1 : 0) | (u ? 2 : 0);
}

template <typename T>
int rn_check(const void* a, const void* b, const void* x, int n, void* q,
             void* tiny, void* s, void* stream) {
  rn_check_kernel<T><<<(n + 255) / 256, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(x), n, static_cast<T*>(q),
      static_cast<unsigned char*>(tiny), static_cast<T*>(s));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rn_check_f32(const void* a, const void* b, const void* x,
                            int n, void* q, void* tiny, void* s,
                            void* stream) {
  return rn_check<float>(a, b, x, n, q, tiny, s, stream);
}
extern "C" int rn_check_f64(const void* a, const void* b, const void* x,
                            int n, void* q, void* tiny, void* s,
                            void* stream) {
  return rn_check<double>(a, b, x, n, q, tiny, s, stream);
}
"""
# random quotients a / b (b > 0) the check draws a dtype, and the positive
# floats a chunk of the exhaustive fp32 square root check holds
RN_CHECK_PAIRS, RN_CHECK_CHUNK = 1 << 25, 1 << 27


def rn_cases(dtype, device, rng):
    """(a, b) of check_rn_ops at ``dtype``: RN_CHECK_PAIRS finite bit
    patterns over every exponent (a of either sign, b > 0); a = b m for
    midpoints m of the subnormal grid and of normal binades where exact
    (fp32), and their neighbours; zeros, infinities, NaN, b = +inf."""
    n = RN_CHECK_PAIRS
    if dtype == torch.float32:
        top, ity, fty = 0x7f800000, np.int32, np.float32
    else:
        top, ity, fty = 0x7ff0000000000000, np.int64, np.float64
    pos = lambda k: torch.from_numpy(rng.integers(
        0, top, k, dtype=np.int64).astype(ity).view(fty))
    a = pos(n) * torch.from_numpy(np.where(rng.random(n) < 0.5, -1.0,
                                           1.0).astype(fty))
    b = pos(n)
    extra_a, extra_b = [a], [b]
    if dtype == torch.float32:
        k = 1 << 22
        bd = ((2 * rng.integers(1, 1 << 6, k) + 1).astype(np.float64)
              * 2.0 ** rng.integers(-20, 20, k))
        for m in ((2 * rng.integers(0, 1 << 10, k) + 1) * 2.0 ** -150,
                  (2 * rng.integers(1 << 23, 1 << 24, k) + 1) * 2.0 ** -25
                  * 2.0 ** rng.integers(-100, 100, k)):
            prod = bd * m
            exact = prod.astype(np.float32).astype(np.float64) == prod
            near = prod[exact].astype(np.float32)
            for v in (near, np.nextafter(near, np.float32(np.inf)),
                      np.nextafter(near, np.float32(0))):
                extra_a.append(torch.from_numpy(v))
                extra_b.append(torch.from_numpy(bd[exact].astype(
                    np.float32)))
    sa = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 1.0, -1.0,
                       1e-45, -1e-45, 3.4e38], dtype=dtype)
    sb = torch.tensor([1.0, 3.0, 7.0, 0.1, math.inf, 1e-45, 2.0 ** -126,
                       3.4e38, 1e-30], dtype=dtype)
    extra_a.append(sa.repeat_interleave(len(sb)))
    extra_b.append(sb.repeat(len(sa)))
    return torch.cat(extra_a).to(device), torch.cat(extra_b).to(device)


def check_rn_ops(device):
    """RnOps<T> (csrc/rn_ops.cuh: the wide boxed QP's division and square
    root, straight-line at fp32, native at fp64) against the card's IEEE
    division and square root (torch's), fp32 and fp64, on rn_cases: every
    result not marked equal bit for bit (NaN where NaN); every marked fp32
    quotient under 2^-125 (a nonzero numerator) or NaN, or b = +inf (the
    QP computes marked work again natively), no fp64 one marked; then the
    square roots of every positive finite float (fp32, marked only at
    +inf) and of the positive b drawn (fp64, never marked), bit for bit
    where not marked."""
    lib = kbuild.load(kbuild.build_generated("rn_ops_check", RN_CHECK_UNIT,
                                             boxed.BOXED_FLAGS))
    stream = torch.cuda.current_stream(device).cuda_stream
    rng = np.random.default_rng(16)
    view = {torch.float32: torch.int32, torch.float64: torch.int64}

    def same(u, v):
        return (u.view(view[u.dtype]) == v.view(view[u.dtype])) | (
            torch.isnan(u) & torch.isnan(v))

    for dtype, fn in ((torch.float32, lib.rn_check_f32),
                      (torch.float64, lib.rn_check_f64)):
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int

        def run(a, b, x):
            q, s = torch.empty_like(a), torch.empty_like(x)
            mark = torch.empty(a.shape, dtype=torch.uint8, device=device)
            err = fn(a.data_ptr(), b.data_ptr(), x.data_ptr(), a.numel(),
                     q.data_ptr(), mark.data_ptr(), s.data_ptr(), stream)
            check(err == 0, f"rn_check launch failed: CUDA error {err}")
            return q, (mark & 1).bool(), s, (mark & 2).bool()

        name = str(dtype)[6:]
        a, b = rn_cases(dtype, device, rng)
        q, tiny, s, stiny = run(a, b, b)
        ok = same(q, a / b)
        check(bool(ok[~tiny].all()), f"RnOps<{name}>::div parts from IEEE "
              f"on {int((~ok & ~tiny).sum())} of {a.numel()} quotients")
        want = a / b
        why = (((a != 0) & (want.abs() < 2.0 ** -125)) | torch.isnan(want)
               | torch.isinf(b) | torch.isnan(a))
        if dtype == torch.float64:   # the native operations mark nothing
            why = torch.zeros_like(tiny)
        check(bool(why[tiny].all()), f"RnOps<{name}>::div marks a quotient "
              f"it should vouch for")
        pos = torch.isfinite(b) & (b > 0)
        sok = same(s, torch.sqrt(b))
        check(bool(sok[pos & ~stiny].all()), f"RnOps<{name}>::sqrt_pos parts "
              f"from IEEE on {int((~sok & pos & ~stiny).sum())} values")
        if dtype == torch.float64:
            check(not bool(stiny.any()), "RnOps<double>::sqrt_pos marks a "
                  "root")
        roots, sq_marked = int(pos.sum()), int((stiny & pos).sum())
        if dtype == torch.float32:
            for lo in range(1, 0x7f800000, RN_CHECK_CHUNK):
                x = torch.arange(lo, min(lo + RN_CHECK_CHUNK, 0x7f800000),
                                 dtype=torch.int32,
                                 device=device).view(torch.float32)
                _, _, s, stiny = run(x, x, x)
                check(bool(same(s, torch.sqrt(x)).all()
                           and torch.equal(stiny, torch.isinf(x))),
                      f"RnOps<float>::sqrt_pos parts from IEEE in "
                      f"[{lo:#x}, ...)")
                roots += x.numel()
        torch.cuda.synchronize()
        print(f"[kernel] rn_ops {name} (the wide boxed QP's division and "
              f"square root): {a.numel()} quotients equal to the card's "
              f"IEEE division where not marked ({int(tiny.sum())} marked, "
              f"computed natively by the QP); {roots} square roots "
              f"{'(every positive finite float) ' if dtype == torch.float32 else ''}"
              f"equal to its IEEE square root where not marked "
              f"({sq_marked} marked)", flush=True)


def k4_wide_profile(key, stats, ms, ms_plain_build, card):
    """One profile launch's summary (``stats`` from ``boxed.launch(...,
    profile=True)``): for the slowest lane (the most cycles over its
    stages: the launch waits for it) and the mean lane, each phase's
    cycles and share, the QP's phases a QP iteration, the clock the
    slowest lane's cycles imply over the profile kernel's ``ms``."""
    ph = stats["phases"].double().cpu()                 # [P, N, B]
    iters = stats["qp_iters"].double().cpu()            # [N, B]
    evals = stats["ls_evals"].double().cpu()
    lane_total = ph.sum((0, 1))                          # [B]
    slow = int(lane_total.argmax())
    qp_phases = {"gradient", "system", "cholesky", "solve", "armijo"}
    ghz = lane_total[slow].item() / (ms * 1e6)
    for who, cyc, its, evs in (
            (f"slowest lane {slow}", ph[:, :, slow].sum(1),
             iters[:, slow].sum().item(), evals[:, slow].sum().item()),
            ("mean lane", ph.sum(1).mean(1), iters.sum(0).mean().item(),
             evals.sum(0).mean().item())):
        total = cyc.sum().item()
        N = ph.shape[1]
        parts = []
        for name, c in zip(boxed.WIDE_PHASES, cyc.tolist()):
            per = (f"{c / its:.0f} a QP iteration" if name in qp_phases
                   else f"{c / N:.0f} a stage")
            parts.append(f"{name} {100 * c / total:.1f} % ({per})")
        qp_it = sum(c for name, c in zip(boxed.WIDE_PHASES, cyc.tolist())
                    if name in qp_phases) / its
        print(f"[k4-wide] profile {key} {who}: {total:.0f} cycles over {N} "
              f"stages, {its / N:.2f} QP iterations and {evs / N:.2f} Armijo "
              f"candidates a stage; a QP iteration {qp_it:.0f} cycles "
              f"({qp_it / ghz / 1e3:.3f} us); {'; '.join(parts)}",
              flush=True)
    print(f"[k4-wide] profile {key}: the profile kernel {ms:.4f} ms, the "
          f"normal build {ms_plain_build:.4f} ms; {ghz:.3f} GHz (the slowest "
          f"lane's cycles over the profile kernel's time) [{card}]",
          flush=True)


def phase_k4_wide(device, card, baseline):
    """K4@9x16 (the wide boxed unit), its profile build (cycles a phase,
    boxqp_wide.cuh::WidePhase) and, with ``baseline``, that checkout's
    unit (its own unit text and headers): built at once, each with its
    nvcc seconds, ptxas' report and SASS counts (sass_counts); held bit
    for bit to each other, QP iterations, free sets and Armijo candidates
    equal, on the check's data (wide_k4_case: B=256, 37 and 1, fp32 and
    fp64, both reg_types; the default run holds the unit to its plain
    version on the card host's CPU); timed in turns (this one's, the
    baseline's, then in reverse) at each of those; then the profile at
    B=256 and 1, fp32 and fp64, reg_type 1, beside the normal build's
    time."""
    nx, nu = WIDE_K1
    N = CENTROIDAL[1]
    fp32, fp64 = torch.float32, torch.float64
    check_rn_ops(device)
    units, keys = [], []
    for dtype in (fp32, fp64):
        for label, profile in (("this", False), ("profile", True)):
            keys.append((dtype, label))
            units.append((boxed.unit_name(nx, nu, dtype, profile=profile),
                          boxed.unit_source(nx, nu, dtype, profile=profile),
                          boxed.BOXED_FLAGS, kbuild.CSRC))
    if baseline:
        pk = parent_module(baseline, "ddp_backward_boxed")
        for dtype in (fp32, fp64):
            keys.append((dtype, "baseline"))
            units.append((boxed.unit_name(nx, nu, dtype) + "_parent",
                          pk.unit_source(nx, nu, dtype), pk.BOXED_FLAGS,
                          Path(baseline).resolve() / "nmpc_tpu_torch"
                          / "csrc"))

    def compile_unit(unit):
        begin = time.perf_counter()
        lib = kbuild.build_generated(*unit)
        return lib, time.perf_counter() - begin

    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        built = list(pool.map(compile_unit, units))
    print(f"[k4-wide] {len(built)} units in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    fns = {}
    for (dtype, label), (_, _, _, csrc), (lib, secs) in zip(keys, units,
                                                           built):
        print(f"[k4-wide] K4@9x16 {str(dtype)[6:]} {label} {lib.name} "
              f"(headers {os.path.relpath(csrc, ROOT)}): nvcc {secs:.1f} s; "
              f"{ptxas_report(lib)}; spill stores / loads "
              f"{spill_bytes(lib)} bytes; SASS {sass_counts(lib)}",
              flush=True)
        fn = kbuild.load(lib).boxed_backward_launch
        fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 10
                       + boxed.QP_ARGTYPES)
        fn.restype = ctypes.c_int
        fns[dtype, label] = fn
    normal_ms = {}
    for dtype in (fp32, fp64):
        dname = str(dtype)[6:]
        for B in WIDE_K1_BATCHES:
            for reg_type in (1, 2):
                case = wide_k4_case(B, dtype, device, reg_type)
                outs, stats = {}, {}
                for (dt, label), fn in fns.items():
                    if dt == dtype:
                        stats[label] = {}
                        outs[label] = boxed.launch(
                            fn, *case, stats=stats[label],
                            profile=label == "profile")
                torch.cuda.synchronize()
                label = (f"K4@9x16 centroidal boxed B={B} N={N} {dname} "
                         f"reg_type={reg_type}")
                first = outs["this"]
                same = {k: all(same_bits(a, b) for a, b in zip(first, o))
                        and all(torch.equal(stats["this"][q], stats[k][q])
                                for q in ("qp_iters", "free", "ls_evals"))
                        for k, o in outs.items()}
                print(f"[k4-wide] {label}: bit for bit to this build, QP "
                      f"stats equal: {same}", flush=True)
                check(all(same.values()), f"{label}: the builds part")
                calls = {k: functools.partial(boxed.launch, fn, *case)
                         for (dt, k), fn in fns.items()
                         if dt == dtype and k != "profile"}
                times = collections.defaultdict(list)
                for order in (list(calls), list(reversed(calls))):
                    for k in order:
                        times[k].append(cuda_ms(calls[k], reps=10, inner=2))
                normal_ms[dtype, B, reg_type] = times["this"][0]
                print(f"[k4-wide] {label}: " + "; ".join(
                    f"{k} {ms[0]:.4f} / {ms[1]:.4f} ms"
                    for k, ms in times.items()) + f" (in turns) [{card}]",
                    flush=True)
    for dtype in (fp32, fp64):
        for B in (CENTROIDAL[0], 1):
            case = wide_k4_case(B, dtype, device, 1)
            fn = fns[dtype, "profile"]
            stats = {}
            boxed.launch(fn, *case, stats=stats, profile=True)
            torch.cuda.synchronize()
            ms = cuda_ms(functools.partial(boxed.launch, fn, *case),
                         reps=10, inner=2)
            k4_wide_profile(f"K4@9x16 centroidal boxed B={B} N={N} "
                            f"{str(dtype)[6:]} reg_type=1", stats, ms,
                            normal_ms[dtype, B, 1], card)


# The FMPC group kernels (K8, K10) are built at, per (nx, nu, ng): every
# G measured, each with the group's rows of P A, P B and P x_bar exchanged
# by shuffles (share) and computed by every thread (redundant); K9 at
# every G and every lanes a block of K9_LANES that is a whole number of
# its warps' lanes.
FMPC_GROUPS = {(4, 1, 4): (1, 2, 4, 8), (2, 1, 3): (1, 2, 4),
               (2, 2, 2): (1, 2)}
K9_LANES = (8, 16, 32)
# The inputs every G, K10, K9 (N <= 32) and the baseline's K8 and K9 are
# held on (model, (B, N), timed): the three FMPC shapes of §4 and the
# cart-pole at N = 23 (timed at fp32 and fp64), the two-input non-PD case
# and a ragged B with an odd N (the fields copied to a padded stride).
FMPC_GROUP_CASES = (("cart-pole", FMPC_SERVING, True),
                    ("oscillator", FMPC_OSC, True),
                    ("oscillator", FMPC_OSC_SHORT, True),
                    ("cart-pole", (4096, 23), True),
                    ("two-input", (128, 8), False),
                    ("cart-pole", (1023, 37), False),
                    ("oscillator", (1023, 31), False))


def fmpc_group_inputs(model, B, N, dtype, device):
    """(problem, config, coefficients, variable, masks, eps) of a
    FMPC_GROUP_CASES entry, with its non-PD and NaN lanes."""
    if model == "two-input":
        problem, co, v, gms, eps = two_input_inputs(dtype, device, B, N)
        return problem, FmpcConfig(horizon_steps=N), co, v, gms, eps
    problem, config, co, v, gms, eps, _ = fmpc_kernel_inputs(
        model, B, N, dtype, device)
    return problem, config, co, v, gms, eps


def as_k8_outputs(out, nx, nu, N):
    """(ks, Ks, s, P, ok, finite) of rows 0 .. N-1 from a K8 result or a
    K10 one (its [N, Fout, B] buffer unpacked)."""
    if len(out) == 3:
        o = k8.unpack_fields(out[0], k8._out_shapes(nx, nu))
        return o["k"], o["K"], o["svec"], o["P"], out[1], out[2]
    return out[0], out[1], out[2][:N], out[3][:N], out[4], out[5]


def phase_fmpc_groups(device, card, baseline):
    """K8 and K10 built at every group size of FMPC_GROUPS, with and
    without ``share``, K9 at every (G, lanes a block of K9_LANES), and,
    with ``baseline`` (another checkout's root), the baseline's K8, K9 and
    K10 from that checkout's headers, unit text and flags: all built at
    once with ptxas' report of each.  On every input of FMPC_GROUP_CASES at
    fp32 and fp64 and both break_if_llt_fails: every G of K8 and of K10
    bit for bit equal to the same kernel at G = 1 (NaN lanes included),
    every K9 (those whose horizon fits a block, and the wrapper's build)
    bit for bit equal to K8 at G = 1, K8 at G = 1 equal to the baseline's
    K8 (launched by the baseline module's own ``launch_stream``; without a
    baseline: this K8) and each K10 and K9 and the baseline's K9 (fed the
    torch condensation) equal to this K8 on its finite lanes with the same
    ok and finite masks.  Then each timed in turns with the baseline's at
    the timed shapes, fp32 and fp64: the kernels alone on inputs prepared
    once, and the calls (K8 and K9 through ``launch_stream``, their host
    work included; the baseline's K9 with its torch condensation)."""
    parent_csrc = (Path(baseline).resolve() / "nmpc_tpu_torch" / "csrc"
                   if baseline else None)
    fp32, fp64 = torch.float32, torch.float64
    units, index = [], {}

    def unit(key, name, text, flags, csrc=kbuild.CSRC):
        index[key] = len(units)
        units.append((name, text, flags, csrc))

    for dtype in (fp32, fp64):
        for shape, groups in FMPC_GROUPS.items():
            for variant in ("stream", "packed"):
                for g, share in ((g, share) for g in groups
                                 for share in (True, False)):
                    unit((variant, shape, dtype, g, share),
                         k8.unit_name(*shape, dtype, variant, g, share),
                         k8.unit_source(*shape, dtype, variant, g, share),
                         k8.FMPC_FLAGS)
            for g, lanes in ((g, L) for g in groups for L in K9_LANES
                             if L % (32 // g) == 0):
                unit(("resident", shape, dtype, g, lanes),
                     k8.unit_name(*shape, dtype, "resident", g, None, lanes),
                     k8.unit_source(*shape, dtype, "resident", g, None,
                                    lanes), k8.FMPC_FLAGS)
    if baseline:
        pk8 = parent_module(baseline, "fmpc_backward")
        for dtype in (fp32, fp64):
            for shape in FMPC_GROUPS:
                for variant in ("stream", "packed", "resident"):
                    unit(("baseline", variant, shape, dtype),
                         k8.unit_name(*shape, dtype, variant) + "_parent",
                         pk8.unit_source(*shape, dtype, variant),
                         pk8.FMPC_FLAGS, parent_csrc)
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        libs = list(pool.map(lambda u: kbuild.build_generated(*u), units))
    print(f"[fmpc-groups] {len(libs)} units in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    for (name, _, flags, csrc), path in zip(units, libs):
        print(f"[fmpc-groups] ptxas {path.name} (headers "
              f"{os.path.relpath(csrc, ROOT)}, flags {' '.join(flags) or '-'}"
              f"): {ptxas_report(path)}", flush=True)

    def launcher(key):
        lib = kbuild.load(libs[index[key]])
        if key[0] == "baseline":
            return pk8.bind(lib, key[1])
        return k8.bind(lib, key[0])

    for model, (B, N), timed in FMPC_GROUP_CASES:
        for dtype in (fp32, fp64):
            dname = str(dtype)[6:]
            problem, config, co, v, gms, eps = fmpc_group_inputs(
                model, B, N, dtype, device)
            shape = (problem.state_dim, problem.input_dim, problem.ineq_dim)
            nx, nu, ng = shape
            nu_s, tilde = k8.condensation(co, v.ss, v.nus, gms, eps)
            P_in, ld3 = k8.padded_lanes(k8.pack_fmpc_inputs(co, nu_s, tilde))
            s_T, P_T = -co.Lx_bar_term, co.Lxx_term
            resident = k8.resident_fits(*shape, N, dtype)
            base9 = baseline and pk8.resident_fits(*shape, N, dtype)
            keys = [key for key in index if key[0] != "baseline"
                    and key[1] == shape and key[2] == dtype and (
                        key[0] != "resident" or resident
                        and k8.resident_block_fits(*shape, N, dtype, key[3],
                                                   key[4]))]

            def name_of(key):
                if key[0] == "resident":
                    return f"K9 G={key[3]} L={key[4]}"
                return (f"{'K8' if key[0] == 'stream' else 'K10'} "
                        f"G={key[3]}{'' if key[4] else ' redundant'}")

            for brk in (False, True):
                cfg = dataclasses.replace(config, break_if_llt_fails=brk)
                calls = {}
                for key in keys:
                    if key[0] == "packed":
                        calls[name_of(key)] = functools.partial(
                            k8.launch_packed, launcher(key), problem, cfg,
                            P_in, ld3, s_T, P_T, nx, nu, ng)
                    else:
                        calls[name_of(key)] = functools.partial(
                            k8.launch_stream, launcher(key), problem, cfg, co,
                            v.ss, v.nus, gms, eps)
                if resident:   # the wrapper's K9 (its rules' G and lanes)
                    calls["K9"] = functools.partial(
                        k8.launch_stream, k8.launcher(*shape, dtype,
                                                      "resident"),
                        problem, cfg, co, v.ss, v.nus, gms, eps)
                if baseline:
                    calls["K8 baseline"] = functools.partial(
                        pk8.launch_stream,
                        launcher(("baseline", "stream", shape, dtype)),
                        problem, cfg, co, v.ss, v.nus, gms, eps)
                    calls["K10 baseline"] = functools.partial(
                        pk8.launch_packed,
                        launcher(("baseline", "packed", shape, dtype)),
                        problem, cfg, P_in, ld3, s_T, P_T, nx, nu, ng)
                if base9:
                    # the baseline's K9 takes K8's arguments (the
                    # condensation folded in), as a call and alone
                    fn9 = launcher(("baseline", "resident", shape, dtype))
                    calls["K9 baseline"] = functools.partial(
                        pk8.launch_stream, fn9, problem, cfg, co, v.ss,
                        v.nus, gms, eps)
                    k9_alone = fmpc_kernel_alone(problem, cfg, co, v, gms,
                                                 eps, "resident", fn=fn9)
                outs = {key: as_k8_outputs(fn(), nx, nu, N)
                        for key, fn in calls.items()}
                torch.cuda.synchronize()
                ref = outs["K8 baseline" if baseline else "K8 G=1"]
                k8_one = outs["K8 G=1"]
                label = (f"K8/K10 {model} {shape} B={B} N={N} {dname} "
                         f"break_if_llt_fails={brk}")

                def equal_on(a, b, lanes):
                    return (torch.equal(a[4], b[4])
                            and torch.equal(a[5], b[5])
                            and bit_equal(a[:4], b[:4], lanes))

                to_g1 = {key: all(same_bits(a, b) for a, b in zip(
                    outs["K8 G=1" if key.startswith("K9") else
                         key.split()[0] + " G=1"], out))
                    for key, out in outs.items()
                    if "G=" in key or key == "K9"}
                to_ref = {key: equal_on(ref, out, ref[5])
                          for key, out in outs.items()}
                print(f"[fmpc-groups] {label}: ok {int(ref[4].sum())}/{B}, "
                      f"finite {int(ref[5].sum())}/{B}; bit-equal to the "
                      f"kernel's G=1 (K9: K8's) {to_g1}; K8 G=1 equal to the "
                      f"{'baseline' if baseline else 'G=1'} K8 on its finite "
                      f"lanes {to_ref['K8 G=1']}; every kernel equal to it "
                      f"{to_ref}", flush=True)
                check(all(to_g1.values()) and all(to_ref.values())
                      and equal_on(k8_one, outs["K10 G=1"], k8_one[5]),
                      f"{label}: a kernel differs from G=1 or from the "
                      f"reference K8")
                if not (timed and not brk):
                    continue
                times = {}
                for key in keys:
                    name = name_of(key)
                    if key[0] == "packed":
                        times[name] = calls[name]
                        continue
                    times[name + " alone"] = fmpc_kernel_alone(
                        problem, cfg, co, v, gms, eps, key[0],
                        fn=launcher(key))
                    times[name + " call"] = calls[name]
                if resident:
                    times["K9 alone"] = fmpc_kernel_alone(
                        problem, cfg, co, v, gms, eps, "resident")
                    times["K9 call"] = calls["K9"]
                if baseline:
                    times["K8 baseline alone"] = fmpc_kernel_alone(
                        problem, cfg, co, v, gms, eps,
                        fn=launcher(("baseline", "stream", shape, dtype)))
                    times["K8 baseline call"] = calls["K8 baseline"]
                    times["K10 baseline"] = calls["K10 baseline"]
                if base9:
                    times["K9 baseline alone"] = k9_alone
                    times["K9 baseline call"] = calls["K9 baseline"]
                timed_in_turns(times, f"{model} B={B} N={N}", card,
                               tag="fmpc-groups", dtype=dname)


# The forward recursions (K6, K7 and K11) are built at every chunk of
# stages of FWD_CHUNKS of their TMA ring (csrc/fwd_ring.cuh), K6 and K7
# also at 0 (each thread's one-stage register prefetch, the parent's
# design; K6 and K7 at one chunk share a unit), K11 also at every threads
# per lane of FWD_GROUPS.
FWD_CHUNKS = (1, 2, 4, 8)
FWD_GROUPS = {(4, 1): (1, 2, 4), (2, 1): (1, 2, 4), (2, 2): (1, 2, 4)}
# The inputs each build is held and timed on, (model, (B, N), timed): K6
# and K7 (at the sweep's 11 alphas, and the head path's last 10 at the
# headline) at the headline, tick and boxed vertical shapes; K11 at the
# FMPC
# cart-pole serving shape, the oscillator at B=1024 and at N=20, the
# oscillator tick shape and the two-input problem; both at a ragged B with
# an odd N (the ring's fields copied to a padded stride, a last chunk
# shorter than C).
K6_CASES = (("cart-pole", HEADLINE, True), ("cart-pole", TICK, True),
            ("vertical", VERTICAL, True), ("cart-pole", (1023, 37), False))
K11_CASES = (("cart-pole", FMPC_SERVING, True),
             ("oscillator", FMPC_OSC, True),
             ("oscillator", FMPC_OSC_SHORT, True),
             ("oscillator", FMPC_TICK, True), ("two-input", (1024, 100), True),
             ("cart-pole", (1023, 37), False),
             ("oscillator", (1023, 37), False),
             ("two-input", (1023, 37), False))
# K6's and K7's chain floor: one warp's lanes, the headline's horizon (K7
# at one alpha)
CHAIN_FLOOR = (32, 100)


def k6_inputs(model, B, N, dtype, device):
    """(problem, t0, xs, us, ks, Ks, alpha) of a K6_CASES entry: the
    cart-pole's rollout_refs, or the boxed vertical model's first
    iteration with the gains of its boxed backward (K5 boxed)."""
    if model == "cart-pole":
        return rollout_refs(B, N, dtype, device)
    problem, t0, xs, us, VxT, VxxT = boxed_rollout(model, B, N, dtype,
                                                   device)
    lam = torch.full((B,), 1e-6, dtype=dtype, device=device)
    ks, Ks, _, _ = remat.backward_remat(problem, boxed_config(N), t0, xs, us,
                                        VxT, VxxT, lam, boxed=True)
    alpha = torch.as_tensor(np.random.default_rng(3).uniform(0.1, 1.0, B),
                            dtype=dtype, device=device)
    return problem, t0, xs, us, ks, Ks, alpha


def k11_inputs(model, B, N, dtype, device):
    """(A, Bm, x_bar, ks, Ks, dx0) of a K11_CASES entry: first-iteration
    FMPC coefficients (fmpc_kernel_inputs, a non-PD and a NaN lane; the
    two-input problem's random iterate, half its lanes pivoting) and K8's
    gains, dx0 = 0.1 x0 (the two-input problem's from a seed)."""
    if model == "two-input":
        problem, co, v, gms, eps = two_input_inputs(dtype, device, B, N)
        x0 = torch.as_tensor(np.random.default_rng(9).normal(size=(2, B)),
                             dtype=dtype, device=device)
    else:
        problem, _, co, v, gms, eps, x0 = fmpc_kernel_inputs(
            model, B, N, dtype, device)
    ks, Ks = k8.backward_fmpc_fused(problem, FmpcConfig(horizon_steps=N),
                                    co, v.ss, v.nus, gms, eps)[:2]
    return co.A, co.B, co.x_bar, ks, Ks, (0.1 * x0).contiguous()


def bare_launch(fn, *args):
    """A call of the unit function ``fn`` on ``args`` (ints, floats,
    tensors for their addresses), its outputs allocated by the caller:
    the kernel's launch and no other host work, for timing."""
    flat = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream

    def call(_inputs=args):   # holds the tensors while the call may run
        err = fn(*flat, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def tma_taken(fields):
    """``fields`` as the wrappers hand them to the TMA ring
    (``ddp_backward_fused.padded_fields``: copied once where TMA does not
    take them as they are)."""
    return k1.padded_fields(fields)[0]


def parent_wrapper(baseline, name):
    """Another checkout's wrapper module ``name`` (``parent_module``) with
    its units built from that checkout's headers."""
    mod = parent_module(baseline, name)
    mod.build_generated = functools.partial(
        kbuild.build_generated,
        csrc=Path(baseline).resolve() / "nmpc_tpu_torch" / "csrc")
    return mod


def phase_fwd_groups(device, card, baseline):
    """K6 and K7 built at every chunk of FWD_CHUNKS and at 0 (each
    thread's register prefetch), K11 at every (chunk, threads per lane of
    FWD_GROUPS), and, with ``baseline`` (another checkout's root), the
    baseline's K6, K7 and K11 from that checkout's headers, unit text and
    flags: all built at once, with ptxas' report of each.  K6 and K7 on
    every input of K6_CASES and K11 on every one of K11_CASES, fp32 and
    fp64, each build on the fields as its wrapper hands them (the ring's
    copied once where TMA does not take them): every one bit for bit equal
    to the one-stage build (K6, K7: C = 0; K11: C = 1, G = 1) and to the
    baseline's kernel (NaN lanes included); K11's one-stage build equal to
    ``forward_fmpc_deltas_plain`` on its finite lanes; K7's one-stage
    build equal to the wrapper's ``forward_costs_remat``, and its columns
    of the first, sixth and last alpha to every K6 build's sum at that
    alpha.  Then each build timed in turns with the baseline's on the
    timed shapes (the unit's launch alone, outputs allocated once), K6 and
    K7 (one alpha) at B=32, N=100 (one warp: their chain floor), and, with
    ``baseline``, K6's, K7's and K11's wrappers in turns with the
    baseline's wrappers (their host work included)."""
    parent_csrc = (Path(baseline).resolve() / "nmpc_tpu_torch" / "csrc"
                   if baseline else None)
    fp32, fp64 = torch.float32, torch.float64
    models = {"cart-pole": make_cartpole_problem(DT),
              "vertical": vertical_problem()}
    units, index = [], {}

    def unit(key, name, text, flags, csrc=kbuild.CSRC):
        index[key] = len(units)
        units.append((name, text, flags, csrc))

    for dtype in (fp32, fp64):
        for model, problem in models.items():
            nx, nu = problem.state_dim, problem.input_dim
            for c in (0,) + FWD_CHUNKS:
                unit(("K6", model, dtype, c),
                     fwd.unit_name(dtype, c, c) + f"_{model}",
                     fwd.unit_source(problem, nx, nu, dtype, c, c), ())
        for (nx, nu), groups in FWD_GROUPS.items():
            for g in groups:
                for c in FWD_CHUNKS:
                    unit(("K11", (nx, nu), dtype, g, c),
                         k11.unit_name(nx, nu, dtype, g, c),
                         k11.unit_source(nx, nu, dtype, g, c), k8.FMPC_FLAGS)
    if baseline:
        pf = parent_wrapper(baseline, "ddp_forward_remat")
        p11 = parent_wrapper(baseline, "fmpc_forward")
        for dtype in (fp32, fp64):
            for model, problem in models.items():
                unit(("K6", model, dtype, "baseline"),
                     fwd.unit_name(dtype) + f"_{model}_parent",
                     pf.unit_source(problem, problem.state_dim,
                                    problem.input_dim, dtype), (),
                     parent_csrc)
            for nx, nu in FWD_GROUPS:
                unit(("K11", (nx, nu), dtype, "baseline"),
                     k11.unit_name(nx, nu, dtype) + "_parent",
                     p11.unit_source(nx, nu, dtype), k8.FMPC_FLAGS,
                     parent_csrc)
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        libs = list(pool.map(lambda u: kbuild.build_generated(*u), units))
    print(f"[fwd-groups] {len(libs)} units in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    for (name, _, flags, csrc), path in zip(units, libs):
        print(f"[fwd-groups] ptxas {path.name} (headers "
              f"{os.path.relpath(csrc, ROOT)}, flags {' '.join(flags) or '-'}"
              f"): {ptxas_report(path)}", flush=True)

    def lib(key):
        return kbuild.load(libs[index[key]])

    def runs(kernel, prefix):
        """(label, key) of every build of ``prefix``, the baseline's
        last."""
        keys = [k for k in index if k[:3] == prefix]
        label = (lambda k: f"C={k[3]}" if kernel == "K6"
                 else f"G={k[3]} C={k[4]}")
        return ([(label(k), k) for k in keys if k[-1] != "baseline"]
                + [("baseline", k) for k in keys if k[-1] == "baseline"])

    def unit_of(key):
        """The launch functions of the K6 / K7 build ``key`` (the
        baseline's bound by its own module)."""
        if key[-1] == "baseline":
            return pf.bind(lib(key), 0)
        return fwd.bind(lib(key), key[3], key[3])

    def k6_launch(key, problem, refs, ring, a, t0, out):
        """A bare launch of the K6 build ``key`` on references ``refs``
        (the untouched ones for the register prefetch and the baseline,
        whose ring the vertical model's aligned references feed as they
        are; ``ring`` for the TMA ring) at alphas ``a``, into ``out``."""
        N, B = out[1].shape[0], a.shape[0]
        take = refs if key[-1] == "baseline" or not key[3] else ring
        return bare_launch(unit_of(key).selected, N, B, take[0].shape[-1],
                           float(problem.dt), N * problem.dt, *take, a, t0,
                           *out)

    def k7_launch(key, problem, refs, ring, a, t0, out):
        """A bare launch of the K7 build ``key`` (K6's unit) on ``refs``
        (or ``ring``, as k6_launch) at the alphas ``a``, into ``out``; the
        baseline's K7 takes contiguous references and no lane stride."""
        N, (A, B) = refs[1].shape[0], out.shape
        args = (float(problem.dt), N * problem.dt)
        if key[-1] == "baseline":
            return bare_launch(unit_of(key).costs, N, B, A, *args, *refs, a,
                               t0, out)
        take = ring if key[3] else refs
        return bare_launch(unit_of(key).costs, N, B, A, take[0].shape[-1],
                           *args, *take, a, t0, out)

    def k7_bound(problem, B, N, A, itemsize):
        nx, nu = problem.state_dim, problem.input_dim
        step = (nx + nu * (2 * nx + 2) + 1
                + program_ops(problem, "forward", "step", nx, nu))
        return bound(moved_bytes("K7", B, N, itemsize, nx, nu, A),
                     A * B * (N * step + program_ops(problem, "forward",
                                                     "term", nx, nu)))

    # K6: every build against the one-stage build, the baseline and K7
    for model, (B, N), timed in K6_CASES:
        for dtype in (fp32, fp64):
            dname = str(dtype)[6:]
            problem, t0, xs, us, ks, Ks, alpha = k6_inputs(model, B, N, dtype,
                                                           device)
            nx, nu = problem.state_dim, problem.input_dim
            refs = (xs, us, ks, Ks)
            ring = tma_taken(refs)
            new = lambda *shape: torch.empty(shape, dtype=dtype,
                                             device=device)
            builds = runs("K6", ("K6", model, dtype))

            def run_all(a):
                outs = {}
                for label, key in builds:
                    out = (new(N + 1, nx, B), new(N, nu, B), new(N + 1, B),
                           new(B))
                    k6_launch(key, problem, refs, ring, a, t0, out)()
                    outs[label] = out
                return outs

            outs = run_all(alpha)
            torch.cuda.synchronize()
            ref = outs["C=0"]
            to_one = {k: all(same_bits(a, b) for a, b in zip(ref, o))
                      for k, o in outs.items()}
            alphas = torch.tensor(DDPConfig().alpha_list, dtype=dtype,
                                  device=device)
            cols = fwd.forward_costs_remat(problem, DDPConfig(
                horizon_steps=N), t0, xs, us, ks, Ks, alphas)
            k7 = collections.defaultdict(list)
            for j in (0, 5, len(alphas) - 1):
                for label, o in run_all(alphas[j].expand(B).contiguous()
                                        ).items():
                    k7[label].append(same_bits(cols[j], o[3]))
            torch.cuda.synchronize()
            k7 = {k: all(v) for k, v in k7.items()}
            label = f"K6 {model} B={B} N={N} {dname}"
            print(f"[fwd-groups] {label}: bit-equal to C=0 (register "
                  f"prefetch) {to_one}; K7's alpha columns equal to the sum "
                  f"{k7}", flush=True)
            check(all(to_one.values()) and all(k7.values()),
                  f"{label}: a build differs from the one-stage build, the "
                  f"baseline or K7")
            # K7: every build at the sweep's alphas and the head path's
            # last ten
            k7_alphas = {11: alphas, 10: alphas[1:].contiguous()}
            for A, a in k7_alphas.items():
                outs7 = {}
                for b_label, key in builds:
                    outs7[b_label] = new(A, B)
                    k7_launch(key, problem, refs, ring, a, t0,
                              outs7[b_label])()
                torch.cuda.synchronize()
                to_one = {k: same_bits(outs7["C=0"], o)
                          for k, o in outs7.items()}
                wrapper = same_bits(cols[11 - A:], outs7["C=0"])
                label7 = f"K7 {model} B={B} N={N} A={A} {dname}"
                print(f"[fwd-groups] {label7}: bit-equal to C=0 (register "
                      f"prefetch) {to_one}; C=0 equal to the wrapper's "
                      f"columns {wrapper}", flush=True)
                check(all(to_one.values()) and wrapper,
                      f"{label7}: a build differs from the one-stage build, "
                      f"the baseline or the wrapper")
            if not timed:
                continue
            t_bound, by = bound(moved_bytes("K6", B, N, dtype.itemsize, nx,
                                            nu), 0)
            out = (new(N + 1, nx, B), new(N, nu, B), new(N + 1, B), new(B))
            timed_in_turns({label: k6_launch(key, problem, refs, ring, alpha,
                                             t0, out)
                            for label, key in builds},
                           f"K6 {model} B={B} N={N}", card,
                           note=f", bound {t_bound * 1e3:.2f} us ({by})",
                           tag="fwd-groups", dtype=dname)
            for A, a in k7_alphas.items():
                if A == 10 and (B, N) != HEADLINE:
                    continue
                t_bound, by = k7_bound(problem, B, N, A, dtype.itemsize)
                out = new(A, B)
                timed_in_turns({label: k7_launch(key, problem, refs, ring, a,
                                                 t0, out)
                                for label, key in builds},
                               f"K7 {model} B={B} N={N} A={A}", card,
                               note=f", bound {t_bound * 1e3:.2f} us ({by})",
                               tag="fwd-groups", dtype=dname)

    # K6's and K7's chain floor: the headline's horizon on one warp (K7 at
    # one alpha), fp32
    B, N = CHAIN_FLOOR
    problem, t0, xs, us, ks, Ks, alpha = k6_inputs("cart-pole", B, N, fp32,
                                                   device)
    out = [torch.empty(shape, device=device) for shape in
           ((N + 1, 4, B), (N, 1, B), (N + 1, B), (B,))]
    refs = (xs, us, ks, Ks)
    builds = runs("K6", ("K6", "cart-pole", fp32))
    timed_in_turns({label: k6_launch(key, problem, refs, tma_taken(refs),
                                     alpha, t0, out)
                    for label, key in builds},
                   f"K6 chain floor (one warp) cart-pole B={B} N={N}", card,
                   tag="fwd-groups")
    a, out = alpha[:1].contiguous(), torch.empty((1, B), device=device)
    timed_in_turns({label: k7_launch(key, problem, refs, tma_taken(refs), a,
                                     t0, out)
                    for label, key in builds},
                   f"K7 chain floor (one warp, A=1) cart-pole B={B} N={N}",
                   card, tag="fwd-groups")

    # K11: every build against the one-stage build, the baseline and the
    # plain version
    for model, (B, N), timed in K11_CASES:
        for dtype in (fp32, fp64):
            dname = str(dtype)[6:]
            args = k11_inputs(model, B, N, dtype, device)
            nx, nu = args[0].shape[1], args[1].shape[2]
            fields = tma_taken(args[:5])
            new = lambda *shape: torch.empty(shape, dtype=dtype,
                                             device=device)
            builds = runs("K11", ("K11", (nx, nu), dtype))

            def k11_launch(key, out):
                fn = (p11.bind(lib(key)) if key[-1] == "baseline"
                      else k11.bind(lib(key)))
                return bare_launch(fn, N, B, fields[0].shape[-1], *fields,
                                   args[5], *out)

            outs = {}
            for label, key in builds:
                outs[label] = (new(N + 1, nx, B), new(N, nu, B))
                k11_launch(key, outs[label])()
            torch.cuda.synchronize()
            ref = outs["G=1 C=1"]
            plain = k11.forward_fmpc_deltas_plain(*args)
            finite = fmpc_mod._finite(plain[0]) & fmpc_mod._finite(plain[1])
            to_plain = bit_equal(plain, ref, finite)
            to_one = {k: all(same_bits(a, b) for a, b in zip(ref, o))
                      for k, o in outs.items()}
            label = f"K11 {model} ({nx}, {nu}) B={B} N={N} {dname}"
            print(f"[fwd-groups] {label}: finite lanes "
                  f"{int(finite.sum())}/{B}; G=1 C=1 bit-equal to the plain "
                  f"version on them {to_plain}; bit-equal to G=1 C=1 "
                  f"{to_one}", flush=True)
            check(to_plain and all(to_one.values()),
                  f"{label}: a build differs from the one-stage build, the "
                  f"baseline or the plain version")
            if not timed:
                continue
            t_bound, by = bound(fmpc_bytes("K11", B, N, dtype.itemsize, nx,
                                           nu, 0), 0)
            out = (new(N + 1, nx, B), new(N, nu, B))
            timed_in_turns({label: k11_launch(key, out)
                            for label, key in builds},
                           f"K11 {model} B={B} N={N}", card,
                           note=f", bound {t_bound * 1e3:.2f} us ({by})",
                           tag="fwd-groups", dtype=dname)

    if not baseline:
        return

    def wrapper_turns(calls, label):
        """CUDA-event ms a call, then the host's us a call, in turns."""
        for call in calls.values():
            call()
        timed_in_turns(calls, label, card, tag="fwd-groups")
        times = collections.defaultdict(list)
        for order in (list(calls), list(reversed(calls))):
            for key in order:
                times[key].append(host_us(calls[key]))
        for key, us in times.items():
            print(f"[fwd-groups] {label} fp32 {key}: host {us[0]:.1f} / "
                  f"{us[1]:.1f} us a call (in turns) [{card}]", flush=True)

    # the wrappers, host work included, in turns with the baseline's; on
    # the vertical model also the bare launches of its ring (C = 8), of
    # its register prefetch (C = 0) and of the baseline's unit
    for model, (B, N) in (("cart-pole", HEADLINE), ("cart-pole", TICK),
                          ("vertical", VERTICAL)):
        problem, t0, xs, us, ks, Ks, alpha = k6_inputs(model, B, N, fp32,
                                                       device)
        cfg = DDPConfig(horizon_steps=N)
        wrapper_turns({mod_label: functools.partial(
            mod.forward_selected_remat, problem, cfg, t0, xs, us, ks, Ks,
            alpha) for mod_label, mod in (("this", fwd), ("baseline", pf))},
            f"K6 wrapper (forward_selected_remat) {model} B={B} N={N}")
        alphas = torch.tensor(cfg.alpha_list, device=device)
        wrapper_turns({mod_label: functools.partial(
            mod.forward_costs_remat, problem, cfg, t0, xs, us, ks, Ks,
            alphas) for mod_label, mod in (("this", fwd), ("baseline", pf))},
            f"K7 wrapper (forward_costs_remat) {model} B={B} N={N}")
        if model == "vertical":
            refs = (xs, us, ks, Ks)
            out = (torch.empty(N + 1, 2, B, device=device),
                   torch.empty(N, 2, B, device=device),
                   torch.empty(N + 1, B, device=device),
                   torch.empty(B, device=device))
            wrapper_turns({label: k6_launch(key, problem, refs, refs, alpha,
                                            t0, out)
                           for label, key in runs("K6", ("K6", model, fp32))
                           if label in ("C=0", "C=8", "baseline")},
                          f"K6 bare launch {model} B={B} N={N}")
    args = k11_inputs("cart-pole", *FMPC_SERVING, fp32, device)
    wrapper_turns({mod_label: functools.partial(
        mod.forward_fmpc_deltas_fused, *args)
        for mod_label, mod in (("this", k11), ("baseline", p11))},
        f"K11 wrapper (forward_fmpc_deltas_fused) cart-pole "
        f"B={FMPC_SERVING[0]} N={FMPC_SERVING[1]}")


LAYERS = ("_rollout_lanes", "_derivative_sweep_lanes", "_terminal_quad_lanes",
          "backward_fused", "backward_stacked", "backward_remat",
          "backward_fused_boxed", "backward_stacked_boxed",
          "_forward_selected_lanes", "_forward_costs_lanes",
          "forward_selected_remat", "forward_costs_remat")


@contextlib.contextmanager
def layer_clock(acc, count, module=ddp_mod, names=LAYERS):
    """Wrap each solver layer ``names`` of ``module`` with a device
    synchronize and the host clock on both sides; restore the layers on
    exit."""
    saved = {name: getattr(module, name) for name in names}

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
        setattr(module, name, timed(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def phase_layers(device, card):
    """Where one solve's time goes, at both shapes and for the boxed
    vertical config, for each (backward, forward) pair and the plain path,
    and for the bipedal config's ``auto`` path at 2 iterations:
    synced wall time, synced time per layer, and the device's busy time
    and kernel launches from ``torch.profiler``."""
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
    runs = [(label, problem, x0s, us0, make_cfg(pair), pair, "stage")
            for label, problem, x0s, us0, make_cfg in cells
            for pair in PAIRS + (("stacked", "scan"),)]
    # the bipedal config's auto path at 2 of its 10 iterations: the
    # profiler takes minutes to sort the ~60,000 launches of each of its
    # iterations (the plain rollouts)
    B, N = BIPEDAL
    x0s, us0 = bipedal_start(B, N, torch.float32, device)
    runs.append(("bipedal", bipedal_problem(), x0s, us0, DDPConfig(
        horizon_steps=N, max_iter=2), ("pallas", "scan"), "stage"))
    for label, problem, x0s, us0, cfg, pair, dma in runs:
        B, N = us0.shape[:2]
        solver = DDPSolver(problem, cfg, backward_dma=dma)
        wall, busy, launches, acc, count, synced = layered_solve(
            lambda: solver.solve_batch(0.0, x0s, us0), acc_module=ddp_mod,
            names=LAYERS)
        parts = ", ".join(f"{name} {acc[name] * 1e3:.1f} ms x{count[name]}"
                          for name in LAYERS if count[name])
        rest = synced - sum(acc.values())
        print(f"[layers] {label} B={B} N={N} max_iter={cfg.max_iter} "
              f"ls_mode={cfg.ls_mode} backward={pair[0]} forward="
              f"{pair[1]}{f' backward_dma={dma}' if dma != 'stage' else ''}: "
              f"wall {wall * 1e3:.1f} ms, device busy "
              f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f} %), "
              f"cudaLaunchKernel {launches}, host syncs "
              f"{solver.host_syncs}; synced layers (total "
              f"{synced * 1e3:.1f} ms): {parts}, rest "
              f"{rest * 1e3:.1f} ms [{card}]", flush=True)
    phase_layers_fmpc(device, card)


def layered_solve(solve, acc_module, names):
    """One warm solve, then (wall seconds of a synced solve, device busy
    ms and kernel launches of a profiled solve, the synced seconds per
    layer and their counts, the synced solve's seconds with the layers
    clocked)."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        solve()
        torch.cuda.synchronize()

    run()
    start = time.perf_counter()
    run()
    wall = time.perf_counter() - start
    acc, count = collections.defaultdict(float), collections.Counter()
    with layer_clock(acc, count, acc_module, names):
        start = time.perf_counter()
        run()
        synced = time.perf_counter() - start
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events
                   if e.key.startswith("cudaLaunchKernel"))
    check(busy > 0, "the profiler saw no device time")
    return wall, busy, launches, acc, count, synced


# --------------------------------------------------------------------------
# FMPC: the condensed Riccati backward (K8) and the Δx/Δu recursion (K11)
# --------------------------------------------------------------------------

VARIABLE = ("xs", "us", "lambdas", "ss", "nus")


def two_input_problem():
    """The synthetic linear nx=2, nu=2, ng=2 problem of the JAX non-PD test
    (tests/test_pallas_kernels.py:694-717): G is a genuine 2x2 block, so
    the Gauss-Jordan fallback pivots."""
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


def fmpc_config(model, N, **kw):
    """The benchmarked configurations: cart-pole serving (fixed work:
    kkt_error_thre=0, init_complementary_variable) and oscillator #4."""
    if model == "cart-pole":
        kw = {"kkt_error_thre": 0.0, "init_complementary_variable": True,
              **kw}
    return FmpcConfig(**{"horizon_steps": N, "max_iter": 5, **kw})


def fmpc_start(model, B, N, dtype, device, population="stabilization",
               seed=0):
    """(problem, x0s [B, nx], reset variables [B, ...], eps [B]) of a
    benchmarked population: the oscillator near [0, 1] (bench_all.py:
    130-133), the cart-pole near upright, x0 ~ 0.15 N(0, 1) (:159), or
    near hanging for the swing-up population."""
    rng = np.random.default_rng(seed)
    if model == "oscillator":
        problem = make_oscillator_problem(DT)
        x0 = np.tile([0.0, 1.0], (B, 1)) + 0.05 * rng.normal(size=(B, 2))
    else:
        problem = make_cartpole_fmpc_problem(DT)
        x0 = 0.15 * rng.normal(size=(B, 4))
        if population == "swing-up":
            x0 = np.tile([0.0, np.pi, 0.0, 0.0], (B, 1)) + 0.05 * rng.normal(
                size=(B, 4))
    v1 = fmpc_variable_reset(N, problem.state_dim, problem.input_dim,
                             problem.ineq_dim, dtype=dtype, device=device)
    var = FmpcVariable(**{f: getattr(v1, f).expand(
        B, *getattr(v1, f).shape).contiguous() for f in VARIABLE})
    return (problem, torch.as_tensor(x0, dtype=dtype, device=device), var,
            torch.full((B,), 1e-4, dtype=dtype, device=device))


def fmpc_kernel_inputs(model, B, N, dtype, device, poison=True):
    """First-iteration K8/K11 inputs as benchmarks/parity_gate.py::
    _fmpc_case builds them (the reset iterate, s and nu from the
    complementary initialization), with each lane's state trajectory held
    at its x0 so that the lanes differ; with ``poison`` lane 1 is made
    non-PD (Luu = -1e4: G < 0 on every stage) and lane 2 NaN (one NaN A).
    Returns (problem, config, coefficients, variable, masks, eps, x0)
    batch-minor; x0 [nx, B]."""
    problem, x0s, var, eps = fmpc_start(model, B, N, dtype, device)
    x0 = x0s.T.contiguous()
    t0 = torch.zeros((), dtype=dtype, device=device)
    ts = t0 + DT * torch.arange(N, dtype=dtype, device=device)
    bm = lambda a: torch.movedim(a, 0, -1).contiguous()
    xs = x0[None].expand(N + 1, *x0.shape).contiguous()
    us = bm(var.us)
    g0 = torch.func.vmap(stages_lanes(problem.ineq_const, 2))(
        ts, xs[:-1], us).contiguous()
    ss = 1.01 * torch.clamp(-g0, min=1e-2)
    nus = 1.01 * torch.clamp(eps[None, None, :] / ss, min=1e-2)
    v = FmpcVariable(xs=xs, us=us, lambdas=bm(var.lambdas), ss=ss, nus=nus)
    config = fmpc_config(model, N)
    co = fmpc_mod._coeffs_bm(problem, config, t0, v)
    if poison:
        co.Luu[:, :, :, 1] = -1e4
        co.A[N // 2, 0, 0, 2] = float("nan")
    gms = fmpc_mod._ineq_masks(problem, ts, dtype)
    return problem, config, co, v, gms, eps, x0


def two_input_inputs(dtype, device, B=128, N=8):
    """The non-PD case of tests/test_pallas_kernels.py:720-772: a random
    iterate (seed 7) of the two-input problem, Luu = -400 I on stages 2
    and 5 of half the lanes."""
    problem = two_input_problem()
    rng = np.random.default_rng(7)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    v = FmpcVariable(xs=as_t(0.3 * rng.normal(size=(N + 1, 2, B))),
                     us=as_t(0.3 * rng.normal(size=(N, 2, B))),
                     lambdas=as_t(0.3 * rng.normal(size=(N + 1, 2, B))),
                     ss=as_t(0.2 + rng.uniform(size=(N, 2, B))),
                     nus=as_t(0.2 + rng.uniform(size=(N, 2, B))))
    t0 = torch.zeros((), dtype=dtype, device=device)
    co = fmpc_mod._coeffs_bm(problem, FmpcConfig(horizon_steps=N), t0, v)
    eye = torch.eye(2, dtype=dtype, device=device)[:, :, None]
    for i in (2, 5):
        co.Luu[i, :, :, :B // 2] = -400.0 * eye
    gms = fmpc_mod._ineq_masks(problem, t0 + problem.dt * torch.arange(
        N, dtype=dtype, device=device), dtype)
    return problem, co, v, gms, torch.full((B,), 1e-4, dtype=dtype,
                                            device=device)


def hold_fmpc_backward(label, plain, out, dtype, B, key="K8", lanes=None):
    """An FMPC backward kernel (K8, K9, K10) vs its plain version: ok and
    finite masks equal, outputs within the kernel tolerance on the finite
    lanes (or on ``lanes``); returns the largest absolute difference and
    whether every output is equal bit for bit."""
    masks = torch.equal(plain[4], out[4]) and torch.equal(plain[5], out[5])
    lanes = plain[5] if lanes is None else lanes
    errs = {n: norm_err(a, b, lanes) for n, a, b in
            zip(("ks", "Ks", "s", "P"), plain[:4], out[:4])}
    bits = all(torch.equal(a[..., lanes], b[..., lanes])
               for a, b in zip(plain[:4], out[:4]))
    print(f"[kernel] {key} {label}: ok lanes {int(out[4].sum())}/{B}, "
          f"finite {int(out[5].sum())}/{B}, masks equal {masks}, bit-equal "
          f"{bits}", flush=True)
    check(masks, f"{key} {label}: kernel and plain ok/finite masks differ")
    return report(f"{key} {label}", errs, dtype), bits


def phase_kernels_fmpc(device):
    """K8 vs ``_backward_bm`` and K11 vs its plain recursion (fed K8's
    gains), on the card: the cart-pole serving shape and the oscillator
    config at fp32 and fp64, both ``break_if_llt_fails``, with a non-PD
    and a NaN lane; then the two-input non-PD case."""
    bit_equal = collections.Counter()
    for model, (B, N) in (("cart-pole", FMPC_SERVING),
                          ("oscillator", FMPC_OSC)):
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype)[6:]
            problem, config, co, v, gms, eps, x0 = fmpc_kernel_inputs(
                model, B, N, dtype, device)
            for brk in (False, True):
                cfg = dataclasses.replace(config, break_if_llt_fails=brk)
                label = (f"{model} B={B} N={N} {dname} "
                         f"break_if_llt_fails={brk}")
                plain = fmpc_mod._backward_bm(problem, cfg, co, v.ss, v.nus,
                                              gms, eps)
                out = k8.backward_fmpc_fused(problem, cfg, co, v.ss, v.nus,
                                             gms, eps)
                torch.cuda.synchronize()
                err, bits = hold_fmpc_backward(label, plain, out, dtype, B)
                bit_equal[dname] += bits
                clean = torch.ones((B,), dtype=torch.bool, device=device)
                clean[1:3] = False
                check(not bool(out[5][2]) and bool(out[5][clean].all()),
                      f"K8 {label}: the NaN lane must be non-finite, the "
                      f"clean lanes finite")
                check(bool(out[4][1]) != brk,
                      f"K8 {label}: the non-PD lane's ok is wrong")
                KERNELS["K8"].max_abs_err = max(KERNELS["K8"].max_abs_err,
                                                err)
                if not brk:
                    gains = out[:2]
            # K11 on the gains of the fallback run (the non-PD lane's LU
            # gains included) from dx0 = 0.1 x0, on the lanes where the
            # plain result is finite
            dx0 = (0.1 * x0).contiguous()
            args = (co.A, co.B, co.x_bar, *gains, dx0)
            plain = k11.forward_fmpc_deltas_plain(*args)
            out = k11.forward_fmpc_deltas_fused(*args)
            torch.cuda.synchronize()
            label = f"{model} B={B} N={N} {dname}"
            finite = (fmpc_mod._finite(plain[0])
                      & fmpc_mod._finite(plain[1]))
            bits = all(torch.equal(a[..., finite], b[..., finite])
                       for a, b in zip(plain, out))
            print(f"[kernel] K11 {label}: gains from K8, bit-equal {bits}",
                  flush=True)
            err = report(f"K11 {label}", {
                n: norm_err(a, b, finite)
                for n, a, b in zip(("dxs", "dus"), plain, out)}, dtype)
            KERNELS["K11"].max_abs_err = max(KERNELS["K11"].max_abs_err, err)

    for dtype in (torch.float32, torch.float64):
        problem, co, v, gms, eps = two_input_inputs(dtype, device)
        B = eps.shape[0]
        for brk in (False, True):
            cfg = FmpcConfig(horizon_steps=8, break_if_llt_fails=brk)
            label = (f"two-input non-PD B={B} N=8 {str(dtype)[6:]} "
                     f"break_if_llt_fails={brk}")
            plain = fmpc_mod._backward_bm(problem, cfg, co, v.ss, v.nus, gms,
                                          eps)
            out = k8.backward_fmpc_fused(problem, cfg, co, v.ss, v.nus, gms,
                                         eps)
            torch.cuda.synchronize()
            err, _ = hold_fmpc_backward(label, plain, out, dtype, B)
            ok = out[4].cpu()
            check(bool(ok.all()) if not brk else
                  (not ok[:B // 2].any() and bool(ok[B // 2:].all())),
                  f"K8 {label}: the poisoned lanes' ok is wrong")
            KERNELS["K8"].max_abs_err = max(KERNELS["K8"].max_abs_err, err)
    print(f"[kernel] K8 checks bit-equal to the plain version on every "
          f"finite lane: {dict(bit_equal)} of 4 per dtype", flush=True)
    # what one call of a wrapper launches on the card: K8 and K9 (at its
    # design point) condense in their kernel, one launch each
    for key, variant, model, (B, N) in (
            ("K8", "stream", "cart-pole", FMPC_SERVING),
            ("K9", "resident", "oscillator", FMPC_OSC_SHORT)):
        problem, cfg, co, v, gms, eps, _ = fmpc_kernel_inputs(
            model, B, N, torch.float32, device, poison=False)
        names = device_kernels(lambda: k8.backward_fmpc_fused(
            problem, cfg, co, v.ss, v.nus, gms, eps, variant=variant))
        own = [n for n in names if "fmpc_backward" in n]
        print(f"[kernel] {key} one backward_fmpc_fused call ({model} B={B} "
              f"N={N} fp32): {len(names)} device kernels by torch.profiler, "
              f"{len(own)} of the FMPC backward, {len(names) - len(own)} "
              f"other {sorted(set(n[:48] for n in names if n not in own))}",
              flush=True)
        check(len(own) == 1 and len(names) == 1,
              f"{key}'s call launched another kernel than its own")


def device_kernels(fn):
    """Names of the device kernels one call of ``fn`` runs, as
    torch.profiler traces them (after a warm call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def fmpc_solve_counted(problem, cfg, x0s, var, eps, t0=0.0):
    """One FMPC solve_batch with every launch counter reset just before
    and read just after."""
    solver = FmpcSolver(problem, cfg)
    reset_counts()
    res = solver.solve_batch(t0, x0s, var, eps)
    torch.cuda.synchronize()
    return res, read_counts(), solver.host_syncs


def fmpc_compare(a, b):
    """(statuses equal, iterations equal, the largest normalized
    difference over the variable's fields, status counts of ``a``)."""
    st = torch.equal(a.status, b.status)
    it = torch.equal(a.iters, b.iters)
    dv = max(norm_err(getattr(b.variable, f), getattr(a.variable, f))[0]
             for f in VARIABLE)
    return st, it, dv, torch.bincount(a.status, minlength=7).tolist()


def phase_e2e_fmpc(device):
    """``FmpcSolver.solve_batch`` at the cart-pole serving shape through
    ``auto`` (K8 + K11) and the plain path (``stacked``, ``scan``): the
    fp32 main path with the launch counters; fp64 on the stabilization and
    swing-up populations (statuses and iterations equal, variables within
    1e-8); fp32 stabilization at kkt_error_thre=1e-2 (the converged set
    equal, u within 2e-4 on it); then fp64 ``solve`` of the oscillator
    against the NumPy golden."""
    B, N = FMPC_SERVING
    plain_kw = {"backward_impl": "stacked", "forward_impl": "scan"}
    problem, x0s, var, eps = fmpc_start("cart-pole", B, N, torch.float32,
                                        device)
    cfg = fmpc_config("cart-pole", N)
    res, counts, syncs = fmpc_solve_counted(problem, cfg, x0s, var, eps)
    for key in FMPC_PATH:
        KERNELS[key].launches = counts[key]
    finite = all(bool(torch.isfinite(getattr(res.variable, f)).all())
                 for f in VARIABLE)
    print(f"[e2e] FMPC cart-pole serving B={B} N={N} max_iter=5 "
          f"kkt_error_thre=0 fp32 auto: launches {counts}, host syncs "
          f"{syncs}, status counts "
          f"{torch.bincount(res.status, minlength=7).tolist()}, finite "
          f"{finite}", flush=True)
    check(all(counts[k] == cfg.max_iter for k in FMPC_PATH)
          and sum(counts.values()) == 2 * cfg.max_iter,
          "the FMPC auto solve did not run K8 and K11 once per iteration")
    check(finite, "non-finite FMPC solve output")

    for population in ("stabilization", "swing-up"):
        problem, x0s, var, eps = fmpc_start("cart-pole", B, N,
                                            torch.float64, device,
                                            population)
        a, ca, _ = fmpc_solve_counted(problem, cfg, x0s, var, eps)
        b, cb, _ = fmpc_solve_counted(problem, dataclasses.replace(
            cfg, **plain_kw), x0s, var, eps)
        st, it, dv, n_status = fmpc_compare(a, b)
        print(f"[e2e] FMPC cart-pole {population} B={B} N={N} max_iter=5 "
              f"fp64: auto launches {ca}, status counts {n_status}; auto vs "
              f"plain: status equal {st}, iters equal {it}, variable norm "
              f"diff {dv:.3e} (tol {E2E_FMPC_FP64:g})", flush=True)
        check(ca["K8"] > 0 and ca["K11"] > 0 and not any(cb.values()),
              "FMPC fp64: auto skipped a kernel or plain launched one")
        check(st and it and dv <= E2E_FMPC_FP64,
              f"FMPC fp64 {population}: auto vs plain out of the contract")

    # the l1-merit line search through K8 at fp64 (ROADMAP C2)
    problem, x0s, var, eps = fmpc_start("cart-pole", B, N, torch.float64,
                                        device)
    cfg_ls = fmpc_config("cart-pole", N, enable_line_search=True)
    a, ca, _ = fmpc_solve_counted(problem, cfg_ls, x0s, var, eps)
    b, cb, _ = fmpc_solve_counted(problem, dataclasses.replace(
        cfg_ls, **plain_kw), x0s, var, eps)
    st, it, dv, n_status = fmpc_compare(a, b)
    print(f"[e2e] FMPC cart-pole stabilization B={B} N={N} max_iter=5 fp64 "
          f"enable_line_search=True: auto launches {ca}, status counts "
          f"{n_status}; auto vs plain: status equal {st}, iters equal {it}, "
          f"variable norm diff {dv:.3e} (tol {E2E_FMPC_FP64:g})", flush=True)
    check(ca["K8"] > 0 and not any(cb.values()),
          "FMPC line search: auto skipped K8 or plain launched a kernel")
    check(st and it and dv <= E2E_FMPC_FP64,
          "FMPC fp64 line search: auto vs plain out of the contract")

    problem, x0s, var, eps = fmpc_start("cart-pole", B, N, torch.float32,
                                        device)
    cfg32 = FmpcConfig(horizon_steps=N, max_iter=10, kkt_error_thre=1e-2,
                       init_complementary_variable=True)
    a = fmpc_solve_counted(problem, cfg32, x0s, var, eps)[0]
    b = fmpc_solve_counted(problem, dataclasses.replace(cfg32, **plain_kw),
                           x0s, var, eps)[0]
    conv = a.status == FmpcStatus.SUCCEEDED
    same = torch.equal(conv, b.status == FmpcStatus.SUCCEEDED)
    n_conv = int(conv.sum())
    du = ((a.variable.us - b.variable.us)[conv].abs().max().item()
          if n_conv else math.nan)
    print(f"[e2e] FMPC cart-pole stabilization B={B} N={N} max_iter=10 "
          f"kkt_error_thre=1e-2 fp32: converged {n_conv}/{B} (plain "
          f"{int((b.status == FmpcStatus.SUCCEEDED).sum())}), converged set "
          f"equal {same}, max|du| on it {du:.3e} (tol {E2E_FMPC_U:g}); "
          f"statuses equal on all lanes {torch.equal(a.status, b.status)}",
          flush=True)
    check(same and n_conv >= B // 4 and du <= E2E_FMPC_U,
          "FMPC fp32 converged-lane contract failed")

    Ng = 100
    golden = GoldenFmpc(OscillatorGolden(DT),
                        GoldenFmpcConfig(horizon_steps=Ng, max_iter=10))
    v1 = fmpc_variable_reset(Ng, 2, 1, 3, dtype=torch.float64, device=device)
    x0 = torch.tensor([0.0, 1.0], dtype=torch.float64, device=device)
    solver = FmpcSolver(make_oscillator_problem(DT),
                        FmpcConfig(horizon_steps=Ng, max_iter=10))
    reset_counts()
    r = solver.solve(0.0, x0, v1)
    torch.cuda.synchronize()
    got = read_counts()
    g = golden.solve(0.0, x0.cpu().numpy(),
                     {f: getattr(v1, f).cpu().numpy() for f in VARIABLE})
    dvar = max(np.abs(getattr(r.variable, f).cpu().numpy() - g[f]).max()
               for f in ("xs", "us", "ss", "nus"))
    kkt = np.asarray(g["kkt_trace"])
    dkkt = np.abs(r.trace.kkt_error[1:len(kkt) + 1].cpu().numpy() / kkt
                  - 1).max()
    deps = abs(float(r.barrier_eps) / g["barrier_eps"] - 1)
    print(f"[e2e] FMPC fp64 oscillator solve N={Ng} vs NumPy golden: status "
          f"{FmpcStatus(int(r.status)).name} / {g['status']}, iters "
          f"{int(r.iters)} / {g['iters']}, max|dvar| {dvar:.3e} (tol "
          f"{GOLDEN_TOL:g}), KKT trace rel {dkkt:.3e}, eps rel {deps:.3e}, "
          f"launches {got}", flush=True)
    check(int(r.status) == g["status"] and int(r.iters) == g["iters"],
          "FMPC golden: status or iterations differ")
    check(dvar <= GOLDEN_TOL and dkkt <= 1e-8 and deps <= 1e-10,
          "FMPC golden: out of tolerance")
    check(got["K8"] > 0 and got["K11"] > 0, "FMPC solve skipped a kernel")


def oscillator_step(x, u, h):
    """The oscillator plant, one explicit Euler step of ``h`` seconds per
    lane: x [B, 2], u [B, 1] (tests/test_fmpc.py:62-64)."""
    xdot0 = (1.0 - x[:, 1] ** 2) * x[:, 0] - x[:, 1] + u[:, 0]
    return x + h * torch.stack([xdot0, x[:, 0]], dim=1)


def phase_serving_fmpc(device, card):
    """A warm-started receding-horizon loop of 256 oscillator controllers
    at fp64 (tests/test_fmpc.py:53-82): each tick one ``solve_batch`` with
    N=100 and 3 iterations through ``auto``, the plant advanced 5 ms by
    the first input, 100 ticks; every applied input satisfies
    g(x, u0) <= 1e-10 and every status is SUCCEEDED or
    MAX_ITERATION_REACHED."""
    B, N = FMPC_TICK
    problem, x, var, eps = fmpc_start("oscillator", B, N, torch.float64,
                                      device)
    solver = FmpcSolver(problem, FmpcConfig(horizon_steps=N, max_iter=3))
    good = (int(FmpcStatus.SUCCEEDED), int(FmpcStatus.MAX_ITERATION_REACHED))
    ms, g_max, bad = [], [], []
    reset_counts()
    t = 0.0
    for _ in range(100):
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = solver.solve_batch(t, x, var, eps)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - start) * 1e3)
        u0 = res.variable.us[:, 0]
        g = torch.stack([-x[:, 1] - 0.05, -u0[:, 0] - 1.0, u0[:, 0] - 0.9])
        g_max.append(g.max())
        bad.append(((res.status != good[0]) & (res.status != good[1])).sum())
        x = oscillator_step(x, u0, FMPC_SIM_DT)
        var, eps = res.variable, res.barrier_eps
        t += FMPC_SIM_DT
    counts = read_counts()
    worst, n_bad = float(torch.stack(g_max).max()), int(sum(bad))
    print(f"[serving] FMPC {B} oscillator controllers N={N} max_iter=3 fp64 "
          f"auto, {len(ms)} ticks: tick p50 {np.percentile(ms, 50):.2f} ms, "
          f"p99 {np.percentile(ms, 99):.2f} ms, first {ms[0]:.2f} ms; "
          f"max g(x, u0) {worst:.3e} (tol 1e-10), lane-ticks with another "
          f"status {n_bad}, final max|x| {float(x.abs().max()):.3e}; "
          f"launches {counts} [{card}]", flush=True)
    check(worst <= 1e-10 and n_bad == 0,
          "an FMPC controller violated a constraint or failed")
    check(all(counts[k] > 0 for k in FMPC_PATH),
          "the FMPC tick loop skipped a kernel")


def fmpc_stage_ops(nx, nu, ng):
    """Arithmetic operations of one stage of csrc/fmpc_stage.cuh (the
    Cholesky path) with the (s, nu) condensation of that stage."""
    cond = ((nx * nx + nx * nu + nu * nu) * (3 * ng + 1)
            + (nx + nu) * 2 * ng)
    products = (nx * nx * (2 * nx - 1) + nx * nu * (2 * nx - 1)
                + nx * (2 * nx - 1) + nx * nx * 2 * nx + nx * nu * 2 * nx
                + nu * nu * 2 * nx + nu * 3 * nx)
    factor = chol_ops(nu) + solve_ops(nu, 1) + solve_ops(nu, nx) + nu * (
        1 + nx)
    value = (nx * (3 * nx + 2 * nu) + nu * nx * (2 * nu - 1)
             + nx * nx * 2 * nu + nx * nx * 2)
    return cond + products + factor + value + 5 * ng


def fmpc_bytes(key, B, N, itemsize, nx, nu, ng):
    """Bytes K8 (and K9) or K11 must move at (B, N): inputs read once,
    outputs written once.  K8 reads ten coefficient fields, g_bar, s and
    nu per stage, the terminal (s, P) and eps, and writes k, K and the N+1
    rows of s and P, and two flag bytes; K11 reads A, B, x_bar, k, K per
    stage and dx0, and writes N+1 dx and N du."""
    if key == "K8":
        fields = (2 * nx * nx + 2 * nx * nu + ng * nx + ng * nu + nu * nu
                  + 2 * nx + nu + 3 * ng)
        return (itemsize * B * (N * fields + nx + nx * nx + 1
                                + N * (nu + nu * nx)
                                + (N + 1) * (nx + nx * nx)) + 2 * B)
    stage = nx * nx + 2 * nx * nu + nx + nu
    return itemsize * B * (N * stage + nx + (N + 1) * nx + N * nu)


def fmpc_kernel_alone(problem, cfg, co, v, gms, eps, variant="stream",
                      fn=None, prof=None):
    """K8's or K9's launch as ``backward_fmpc_fused`` makes it, on inputs
    prepared once (the fields as their tensor maps take them), into
    outputs allocated once; ``fn`` another build of the ``variant``'s
    unit, ``prof`` a profile build's cycles."""
    nx, nu, ng = co.A.shape[1], co.B.shape[2], co.C.shape[1]
    N, B, dtype, device = co.A.shape[0], eps.shape[0], eps.dtype, eps.device
    fn = fn or k8.launcher(nx, nu, ng, dtype, variant)
    fields, ld = k8.tma_fields(co, v.ss, v.nus)
    ptrs = (ctypes.c_void_p * len(fields))(*(a.data_ptr() for a in fields))
    outs = [torch.empty(shape, dtype=dtype, device=device) for shape in
            ((N, nu, B), (N, nu, nx, B), (N + 1, nx, B), (N + 1, nx, nx, B))]
    outs += [torch.empty((B,), dtype=torch.bool, device=device)
             for _ in range(2)]
    stream = torch.cuda.current_stream(device).cuda_stream

    def call(_inputs=fields):   # holds the inputs while the call may run
        err = fn(N, B, ld, float(problem.dt), int(cfg.break_if_llt_fails),
                 int(cfg.check_nan), ptrs, gms.data_ptr(), gms.stride(0),
                 eps.data_ptr(),
                 co.Lx_bar_term.data_ptr(), co.Lxx_term.data_ptr(),
                 *(o.data_ptr() for o in outs), stream,
                 *(() if prof is None else (prof.data_ptr(),)))
        check(err == 0, f"the FMPC {variant} kernel's launch failed: CUDA "
              f"error {err}")
        return outs
    return call


def time_kernel_alone(key, call, B, N, nx, nu, ng, label, card):
    """Print the time of K8's or K9's launch alone beside its bound (both
    read s, nu and g_bar and condense)."""
    t = cuda_ms(call, inner=10)
    t_bound, by = bound(fmpc_bytes("K8", B, N, 4, nx, nu, ng),
                        B * N * fmpc_stage_ops(nx, nu, ng))
    print(f"[times] {key} kernel alone (its inputs prepared once) {label} "
          f"fp32: {t:.4f} ms, bound {t_bound * 1e3:.2f} us ({by}) [{card}]",
          flush=True)


def timed_fmpc(solver, x0s, var, eps, reps):
    """Host seconds of ``reps`` synced FMPC solves after a warm one."""
    solver.solve_batch(0.0, x0s, var, eps)
    torch.cuda.synchronize()
    secs = []
    for _ in range(reps):
        start = time.perf_counter()
        solver.solve_batch(0.0, x0s, var, eps)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - start)
    return secs


def phase_times_fmpc(device, card):
    """K8 and K11 against their plain versions (CUDA events) beside their
    bounds at both FMPC shapes (the record keeps the cart-pole serving
    shape), then solves/s of both configurations for each (backward,
    forward) pair."""
    for model, (B, N) in (("cart-pole", FMPC_SERVING),
                          ("oscillator", FMPC_OSC)):
        dtype = torch.float32
        problem, cfg, co, v, gms, eps, x0 = fmpc_kernel_inputs(
            model, B, N, dtype, device, poison=False)
        nx, nu, ng = problem.state_dim, problem.input_dim, problem.ineq_dim
        ks, Ks, *_ = k8.backward_fmpc_fused(problem, cfg, co, v.ss, v.nus,
                                            gms, eps)
        args = (co.A, co.B, co.x_bar, ks, Ks, (0.1 * x0).contiguous())
        calls = {
            "K8": (lambda: k8.backward_fmpc_fused(problem, cfg, co, v.ss,
                                                  v.nus, gms, eps),
                   lambda: fmpc_mod._backward_bm(problem, cfg, co, v.ss,
                                                 v.nus, gms, eps),
                   B * N * fmpc_stage_ops(nx, nu, ng)),
            "K11": (lambda: k11.forward_fmpc_deltas_fused(*args),
                    lambda: k11.forward_fmpc_deltas_plain(*args),
                    B * N * (2 * nx * nu + nx * (2 * nx + 2 * nu))),
        }
        for key, (kernel, plain, n_ops) in calls.items():
            record_time(key, kernel, plain,
                        fmpc_bytes(key, B, N, 4, nx, nu, ng), n_ops,
                        f"{model} B={B} N={N}", model == "cart-pole", card)
        time_kernel_alone("K8", fmpc_kernel_alone(problem, cfg, co, v, gms,
                                                  eps),
                          B, N, nx, nu, ng, f"{model} B={B} N={N}", card)

    for model, (B, N) in (("cart-pole", FMPC_SERVING),
                          ("oscillator", FMPC_OSC)):
        problem, x0s, var, eps = fmpc_start(model, B, N, torch.float32,
                                            device)
        for pair in FMPC_PAIRS:
            solver = FmpcSolver(problem, fmpc_config(
                model, N, backward_impl=pair[0], forward_impl=pair[1]))
            secs = timed_fmpc(solver, x0s, var, eps,
                              1 if pair[0] == "stacked" else 5)
            med = statistics.median(secs)
            print(f"[times] FMPC {model} solve_batch B={B} N={N} max_iter=5 "
                  f"fp32 backward={pair[0]} forward={pair[1]}"
                  f"{' (= auto)' if pair == FMPC_PAIRS[0] else ''}: median "
                  f"{med:.4f} s, {B / med:.1f} solves/s, host syncs "
                  f"{solver.host_syncs} [{card}]", flush=True)


FMPC_LAYERS = ("_coeffs_bm", "_kkt_error_bm", "backward_fmpc_fused",
               "_backward_bm", "_forward_bm", "_update_bm")
FMPC_INNER = ("forward_fmpc_deltas_fused", "forward_fmpc_deltas_plain")


def phase_layers_fmpc(device, card):
    """Where one FMPC solve's time goes at both shapes for each pair, and
    at the oscillator's N=20 for each backward variant: synced time of the
    coefficient sweep, KKT, backward, forward (the recursion and the
    post-passes apart) and update, the host syncs, and the device's busy
    time and launches from ``torch.profiler``."""
    runs = [(model, shape, pair, "stream")
            for model, shape in (("cart-pole", FMPC_SERVING),
                                 ("oscillator", FMPC_OSC))
            for pair in FMPC_PAIRS]
    runs += [("oscillator", FMPC_OSC_SHORT, FMPC_PAIRS[0], variant)
             for variant in k8.VARIANTS]
    for model, (B, N), pair, variant in runs:
        problem, x0s, var, eps = fmpc_start(model, B, N, torch.float32,
                                            device)
        solver = FmpcSolver(problem, fmpc_config(
            model, N, backward_impl=pair[0], forward_impl=pair[1]),
            backward_variant=variant)
        wall, busy, launches, acc, count, synced = layered_solve(
            lambda: solver.solve_batch(0.0, x0s, var, eps), fmpc_mod,
            FMPC_LAYERS + FMPC_INNER)
        parts = ", ".join(f"{name} {acc[name] * 1e3:.1f} ms x{count[name]}"
                          for name in FMPC_LAYERS + FMPC_INNER
                          if count[name])
        inner = sum(acc[n] for n in FMPC_INNER)
        rest = synced - sum(acc[n] for n in FMPC_LAYERS)
        print(f"[layers] FMPC {model} B={B} N={N} max_iter=5 backward="
              f"{pair[0]} forward={pair[1]}"
              f"{f' backward_variant={variant}' if variant != 'stream' else ''}"
              f": wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
              f"({100 * busy / (wall * 1e3):.1f} %), cudaLaunchKernel "
              f"{launches}, host syncs {solver.host_syncs}; synced "
              f"layers (total {synced * 1e3:.1f} ms): {parts}; forward "
              f"post-passes {(acc['_forward_bm'] - inner) * 1e3:.1f} ms, "
              f"rest {rest * 1e3:.1f} ms [{card}]", flush=True)


# --------------------------------------------------------------------------
# The layout variants: the chunked and packed DDP backward (K2, K3) on the
# bipedal model, the resident and packed FMPC backward (K9, K10), and the
# receding-horizon driver
# --------------------------------------------------------------------------


@functools.cache
def bipedal_problem():
    """The bipedal CoM-ZMP model of config #2, one object for the run."""
    return make_bipedal_problem(DT, example_ref_zmp_func(BIPEDAL_END_T),
                                example_omega2_func())


def bipedal_start(B, N, dtype, device):
    """Config #2's batch (benchmarks/bench_all.py:66-68): x0 ~ 0.05 N(0, 1)
    from seed 0, zero inputs."""
    rng = np.random.default_rng(0)
    return (torch.as_tensor(0.05 * rng.normal(size=(B, 2)), dtype=dtype,
                            device=device),
            torch.zeros((B, N, 1), dtype=dtype, device=device))


def bipedal_derivs(B, N, dtype, device):
    """K1/K2/K3's bipedal input: the stage derivatives of a rollout from
    t0=1.2 (the horizon crosses the footsteps and the squat's start) with
    inputs 0.02 N(0, 1), lane 1 made non-PD (Luu = -10) and lane 2
    NaN-poisoned."""
    problem, config = bipedal_problem(), DDPConfig(horizon_steps=N)
    rng = np.random.default_rng(1)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    t0, us = as_t(1.2), as_t(0.02 * rng.normal(size=(N, 1, B))).contiguous()
    xs, _ = ddp_mod._rollout_lanes(
        problem, config, t0, as_t(0.05 * rng.normal(size=(2, B))), us)
    D, VxT, VxxT = ddp_mod._derivative_sweep_lanes(problem, config, t0, xs,
                                                   us)
    D = StackedDerivs(*D[:7])
    D.Luu[:, :, :, 1] = -10.0
    D.Fx[N // 2, 0, 0, 2] = float("nan")
    return D, VxT, VxxT


def bit_equal(ref, out, lanes):
    return all(torch.equal(a[..., lanes], b[..., lanes])
               for a, b in zip(ref, out))


def phase_kernels_variants(device):
    """K2 and K3 vs the plain version and vs K1 at the headline shape and
    the bipedal shape; K9 vs ``_backward_bm`` and K8 at the oscillator's
    N=20 and the cart-pole's largest fitting N; K10 at the cart-pole
    serving shape and the oscillator's config #4; K9 and K10 on the
    two-input non-PD case; fp32 and fp64."""
    bits = collections.Counter()
    for model, (B, N) in (("cart-pole", HEADLINE), ("bipedal", BIPEDAL)):
        for dtype in (torch.float32, torch.float64):
            D, VxT, VxxT = (rollout_derivs if model == "cart-pole"
                            else bipedal_derivs)(B, N, dtype, device)
            cfg = DDPConfig(horizon_steps=N)
            lam = torch.full((B,), 1e-4, dtype=dtype, device=device)
            plain = backward_stacked(cfg, D, VxT, VxxT, lam)
            parent = backward_fused(cfg, D, VxT, VxxT, lam)
            for key, dma in (("K2", "chunked"), ("K3", "packed")):
                out = backward_fused(cfg, D, VxT, VxxT, lam, dma=dma)
                torch.cuda.synchronize()
                label = f"{model} B={B} N={N} {str(dtype)[6:]}"
                if dma == "chunked":
                    C = k1.chunk_stages(D.Fx.shape[1], 1, N, dtype)
                    label += f" C={C} (last chunk {N - (N - 1) // C * C})"
                check_ok(f"{key} {label}", plain[3], out[3], B)
                err = report(f"{key} {label}", {
                    n: norm_err(a, b, plain[3]) for n, a, b in
                    zip(("ks", "Ks", "dV"), plain, out)}, dtype)
                KERNELS[key].max_abs_err = max(KERNELS[key].max_abs_err, err)
                same = (torch.equal(parent[3], out[3])
                        and bit_equal(parent[:3], out[:3], parent[3]))
                bits[key] += same
                print(f"[kernel] {key} {label}: bit-equal to K1 on its ok "
                      f"lanes {same}", flush=True)
                check(same, f"{key} {label}: not bit-equal to K1")
    check_ragged(device)

    def fmpc_case(label, problem, cfg, co, v, gms, eps, B):
        plain = fmpc_mod._backward_bm(problem, cfg, co, v.ss, v.nus, gms, eps)
        parent = k8.backward_fmpc_fused(problem, cfg, co, v.ss, v.nus, gms,
                                        eps)
        for key, variant in (("K9", "resident"), ("K10", "packed")):
            if key == "K9" and not k8.resident_fits(
                    problem.state_dim, problem.input_dim, problem.ineq_dim,
                    co.A.shape[0], eps.dtype):
                continue
            out = k8.backward_fmpc_fused(problem, cfg, co, v.ss, v.nus, gms,
                                         eps, variant=variant)
            torch.cuda.synchronize()
            err, _ = hold_fmpc_backward(label, plain, out, eps.dtype, B, key)
            KERNELS[key].max_abs_err = max(KERNELS[key].max_abs_err, err)
            same = (torch.equal(parent[4], out[4])
                    and torch.equal(parent[5], out[5])
                    and bit_equal(parent[:4], out[:4], parent[5]))
            bits[key] += same
            print(f"[kernel] {key} {label}: bit-equal to K8 on its finite "
                  f"lanes {same}", flush=True)
            yield key, out

    for dtype in (torch.float32, torch.float64):
        fits_n = max(n for n in range(1, 33)
                     if k8.resident_fits(4, 1, 4, n, dtype))
        cases = (("oscillator", FMPC_OSC_SHORT), ("cart-pole", (4096, fits_n)),
                 ("cart-pole", FMPC_SERVING), ("oscillator", FMPC_OSC))
        for model, (B, N) in cases:
            problem, config, co, v, gms, eps, _ = fmpc_kernel_inputs(
                model, B, N, dtype, device)
            for brk in (False, True):
                cfg = dataclasses.replace(config, break_if_llt_fails=brk)
                label = (f"{model} B={B} N={N} {str(dtype)[6:]} "
                         f"break_if_llt_fails={brk}")
                for key, out in fmpc_case(label, problem, cfg, co, v, gms,
                                          eps, B):
                    clean = torch.ones((B,), dtype=torch.bool, device=device)
                    clean[1:3] = False
                    check(not bool(out[5][2]) and bool(out[5][clean].all())
                          and bool(out[4][1]) != brk,
                          f"{key} {label}: the NaN or non-PD lane's flags "
                          f"are wrong")
        problem, co, v, gms, eps = two_input_inputs(dtype, device)
        for brk in (False, True):
            cfg = FmpcConfig(horizon_steps=8, break_if_llt_fails=brk)
            label = (f"two-input non-PD B={eps.shape[0]} N=8 "
                     f"{str(dtype)[6:]} break_if_llt_fails={brk}")
            for _ in fmpc_case(label, problem, cfg, co, v, gms, eps,
                               eps.shape[0]):
                pass
    print(f"[kernel] checks bit-equal to the parent kernel (K1 for K2/K3, K8 "
          f"for K9/K10): {dict(bits)}", flush=True)


def wide_derivs(B, N, dtype, device, nx=WIDE_SWEEP[0], nu=WIDE_SWEEP[1]):
    """Stage fields of a random linear-quadratic problem at (nx, nu), made
    from a seed: Fx near the identity, positive definite Lxx, Luu and
    Vxx_T; lane 1 non-PD (Luu = -10 I), lane 2 NaN from stage N/2."""
    rng = np.random.default_rng(9)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)

    def spd(n, scale):
        M = rng.normal(size=(N, B, n, n))
        return np.moveaxis(M @ np.swapaxes(M, -1, -2) / n
                           + scale * np.eye(n), 1, -1)

    D = StackedDerivs(
        as_t(np.eye(nx)[None, :, :, None] + 0.05 * rng.normal(
            size=(N, nx, nx, B))),
        as_t(0.1 * rng.normal(size=(N, nx, nu, B))),
        as_t(0.1 * rng.normal(size=(N, nx, B))),
        as_t(0.1 * rng.normal(size=(N, nu, B))),
        as_t(spd(nx, 0.1)), as_t(spd(nu, 1.0)),
        as_t(0.01 * rng.normal(size=(N, nx, nu, B))))
    D = StackedDerivs(*(a.contiguous() for a in D))
    D.Luu[:, :, :, 1] = -10.0 * torch.eye(nu, dtype=dtype, device=device)
    D.Fx[N // 2, 0, 0, 2] = float("nan")
    VxT = as_t(0.1 * rng.normal(size=(nx, B)))
    VxxT = as_t(spd(nx, 1.0)[0]).contiguous()
    return D, VxT, VxxT


def check_ragged(device):
    """K1, K2 and K3 where TMA does not take a field as it is, where a
    block has warps past the batch, and at the kernels' widest shape: the
    cart-pole at B=1023 (K1 copies its seven fields and K3 its buffer once
    to a padded lane stride, K2 copies nothing), fp32 and fp64, at B=4100
    (blocks of 32 lanes: the last block's K1 ring waits for one consumer
    warp of four), and with Lxx given as a view at a 4-byte offset
    (B=1024: K1 copies that field alone); (8, 4) fp64 at B=1023,
    N=37 (K1's ring of two one-stage buffers, K2's one-stage slots).  K1
    within KERNEL_TOL of the plain version with the same ok mask, K2 and
    K3 bit for bit to K1 on its ok lanes, each copy counted."""
    N = HEADLINE[1]
    cases = [(f"cart-pole B=1023 N={N} {str(dtype)[6:]}", dtype,
              rollout_derivs(1023, N, dtype, device), 7, 1)
             for dtype in (torch.float32, torch.float64)]
    cases.append((f"cart-pole B=4100 N={N} float32 (a last block of four "
                  f"warps, one with lanes)", torch.float32,
                  rollout_derivs(4100, N, torch.float32, device), 0, 0))
    D, VxT, VxxT = rollout_derivs(1024, N, torch.float32, device)
    flat = torch.empty(D.Lxx.numel() + 1, device=device)
    view = flat[1:].view(D.Lxx.shape)
    view.copy_(D.Lxx)
    cases.append((f"cart-pole B=1024 N={N} float32, Lxx at a 4-byte offset",
                  torch.float32, (D._replace(Lxx=view), VxT, VxxT), 1, 0))
    cases.append(("(8, 4) B=1023 N=37 float64", torch.float64,
                  wide_derivs(1023, 37, torch.float64, device), 7, 1))
    for label, dtype, (D, VxT, VxxT), k1_copies, k3_copies in cases:
        B, N = VxT.shape[-1], D.Fx.shape[0]
        cfg = DDPConfig(horizon_steps=N)
        lam = torch.full((B,), 1e-4, dtype=dtype, device=device)
        plain = backward_stacked(cfg, D, VxT, VxxT, lam)
        before = (backward_fused.padded_copies,
                  k1.backward_packed.padded_copies)
        outs = {key: backward_fused(cfg, D, VxT, VxxT, lam, dma=dma)
                for dma, key in DMA_KERNEL.items()}
        torch.cuda.synchronize()
        copies = (backward_fused.padded_copies - before[0],
                  k1.backward_packed.padded_copies - before[1])
        parent = outs["K1"]
        check_ok(f"K1 {label}", plain[3], parent[3], B)
        err = report(f"K1 {label}", {
            n: norm_err(a, b, plain[3]) for n, a, b in
            zip(("ks", "Ks", "dV"), plain, parent)}, dtype)
        KERNELS["K1"].max_abs_err = max(KERNELS["K1"].max_abs_err, err)
        same = {key: torch.equal(parent[3], out[3])
                and bit_equal(parent[:3], out[:3], parent[3])
                for key, out in outs.items() if key != "K1"}
        print(f"[kernel] K1/K2/K3 {label}: fields copied to a padded lane "
              f"stride K1 {copies[0]}, K3 {copies[1]}; bit-equal to K1 on "
              f"its ok lanes {same}", flush=True)
        check(all(same.values()) and copies == (k1_copies, k3_copies),
              f"{label}: K2 or K3 not bit-equal to K1, or the copies are "
              f"not {(k1_copies, k3_copies)}")


def resolved_impls(problem, cfg, dtype, device):
    """(backward, forward) that the DDP solver resolves for ``cfg``."""
    bw = ddp_mod._resolve_backward_impl(cfg, problem, dtype, device, False,
                                        False)
    fw = ddp_mod._resolve_forward_impl(cfg, problem, dtype, device, dtype)
    return bw, fw


def phase_e2e_variants(device):
    """The bipedal solve of config #2 through ``auto`` with each
    ``backward_dma`` (K1, K2, K3) and on the plain path, fp64 (statuses
    and iterations equal, u within 1e-8) and fp32 (u and cost to the
    contract, decision flips listed); FMPC at the oscillator's N=20
    through ``"resident"`` (K9) and ``"stream"`` (K8), and at the
    cart-pole serving shape through ``"packed"`` (K10), against the plain
    path with the contracts of the existing FMPC checks."""
    B, N = BIPEDAL
    problem = bipedal_problem()
    cfg = DDPConfig(horizon_steps=N, max_iter=10)
    plain_kw = {"backward_impl": "stacked", "forward_impl": "scan"}
    print(f"[e2e] bipedal: auto resolves to (backward, forward) = "
          f"{resolved_impls(problem, cfg, torch.float32, device)}",
          flush=True)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype)[6:]
        x0s, us0 = bipedal_start(B, N, dtype, device)
        runs, secs = {}, {}
        for name in k1.DMA_MODES + ("plain",):
            start = time.perf_counter()
            runs[name] = (solve_counted(problem, dataclasses.replace(
                cfg, **plain_kw), x0s, us0) if name == "plain" else
                solve_counted(problem, cfg, x0s, us0, backward_dma=name))
            secs[name] = time.perf_counter() - start
        ref = runs["plain"][0]
        for name, (res, counts, syncs) in runs.items():
            finite = bool(torch.isfinite(res.us).all()
                          and torch.isfinite(res.xs).all())
            st, it, du, dc = e2e_compare(res, ref)
            flips = decision_flips(res, ref, cfg.cost_update_thre)
            same = all(torch.equal(getattr(res, f), getattr(runs["stage"][0], f))
                       for f in ("status", "iters", "us", "xs"))
            print(f"[e2e] bipedal B={B} N={N} max_iter=10 {dname} "
                  f"backward_dma={name}: {secs[name]:.4f} s "
                  f"({B / secs[name]:.1f} solves/s, host clock, one synced "
                  f"solve), launches {counts}, host syncs {syncs}, status "
                  f"counts "
                  f"{torch.bincount(res.status, minlength=5).tolist()}; vs "
                  f"plain: status equal {st}, iters equal {it}, u norm diff "
                  f"{du:.3e}, cost rel diff {dc:.3e}; lanes that differ: "
                  f"{'; '.join(flips[:8]) or 'none'}"
                  f"{f' (+{len(flips) - 8} more)' if len(flips) > 8 else ''}"
                  f"; equal to the stage run bit for bit {same}", flush=True)
            check(finite, f"bipedal {dname} {name}: non-finite output")
            check(du <= E2E_U_NORM and dc <= E2E_COST_REL,
                  f"bipedal {dname} {name}: u or cost vs plain out of the "
                  f"contract")
            if dtype == torch.float64:
                check(st and it and du <= E2E_U_NORM_FP64,
                      f"bipedal fp64 {name} vs plain")
            elif name != "plain":
                want = UNBOXED_FP32_FLIPS["bipedal", name]
                check(len(flips) == want, f"bipedal fp32 {name}: "
                      f"{len(flips)} lanes part from the plain path, {want} "
                      f"expected")
            if name == "plain":
                check(not any(counts.values()),
                      "the plain bipedal solve launched a kernel")
                continue
            key = DMA_KERNEL[name]
            others = {"K1", "K2", "K3", "K5", "K6", "K7"} - {key}
            check(counts[key] > 0 and not any(counts[k] for k in others),
                  f"bipedal backward_dma={name} did not run {key} alone")
            if dtype == torch.float32:
                KERNELS[key].launches = counts[key]

    check_deriv64(device)

    def fmpc_runs(model, B, N, dtype, cfg, variants):
        problem, x0s, var, eps = fmpc_start(model, B, N, dtype, device)
        out = {}
        for variant in variants:
            solver = FmpcSolver(problem, cfg, backward_variant=variant)
            reset_counts()
            res = solver.solve_batch(0.0, x0s, var, eps)
            torch.cuda.synchronize()
            out[variant] = (res, read_counts(), solver.host_syncs)
        out["plain"] = fmpc_solve_counted(problem, dataclasses.replace(
            cfg, backward_impl="stacked", forward_impl="scan"), x0s, var, eps)
        return out

    for model, (B, N), variants in (
            ("oscillator", FMPC_OSC_SHORT, ("resident", "stream")),
            ("cart-pole", FMPC_SERVING, ("packed",))):
        cfg = fmpc_config(model, N)
        runs = fmpc_runs(model, B, N, torch.float32, cfg, variants)
        for variant in variants:
            res, counts, syncs = runs[variant]
            key = VARIANT_KERNEL[variant]
            others = {"K8", "K9", "K10"} - {key}
            finite = all(bool(torch.isfinite(getattr(res.variable, f)).all())
                         for f in VARIABLE)
            print(f"[e2e] FMPC {model} B={B} N={N} max_iter=5 fp32 "
                  f"backward_variant={variant}: launches {counts}, host syncs "
                  f"{syncs}, status counts "
                  f"{torch.bincount(res.status, minlength=7).tolist()}, "
                  f"finite {finite}", flush=True)
            check(finite and counts[key] > 0 and counts["K11"] > 0
                  and not any(counts[k] for k in others),
                  f"FMPC {model} {variant}: non-finite or not through {key}")
            if key != "K8":
                KERNELS[key].launches = counts[key]
        runs = fmpc_runs(model, B, N, torch.float64, cfg, variants)
        for variant in variants:
            st, it, dv, n_status = fmpc_compare(runs[variant][0],
                                                runs["plain"][0])
            print(f"[e2e] FMPC {model} B={B} N={N} max_iter=5 fp64 "
                  f"backward_variant={variant}: status counts {n_status}; vs "
                  f"plain: status equal {st}, iters equal {it}, variable "
                  f"norm diff {dv:.3e} (tol {E2E_FMPC_FP64:g})", flush=True)
            check(st and it and dv <= E2E_FMPC_FP64,
                  f"FMPC {model} fp64 {variant} vs plain out of the contract")
        # fp32: the converged set equal to the plain path's and u within
        # E2E_FMPC_U on it; the oscillator at N=20 converges on no lane
        # within 10 iterations at kkt_error_thre=1e-2, so there the
        # statuses must be equal and u within E2E_FMPC_U on every lane
        cfg32 = dataclasses.replace(cfg, max_iter=10, kkt_error_thre=1e-2)
        runs = fmpc_runs(model, B, N, torch.float32, cfg32, variants)
        b = runs["plain"][0]
        for variant in variants:
            a = runs[variant][0]
            conv = a.status == FmpcStatus.SUCCEEDED
            same = torch.equal(conv, b.status == FmpcStatus.SUCCEEDED)
            n_conv = int(conv.sum())
            lanes = conv if n_conv >= B // 4 else torch.ones_like(conv)
            du = (a.variable.us - b.variable.us)[lanes].abs().max().item()
            st = torch.equal(a.status, b.status)
            print(f"[e2e] FMPC {model} B={B} N={N} max_iter=10 "
                  f"kkt_error_thre=1e-2 fp32 backward_variant={variant}: "
                  f"converged {n_conv}/{B}, converged set equal to the plain "
                  f"path's {same}, statuses equal {st}, max|du| on "
                  f"{'it' if n_conv >= B // 4 else 'every lane'} {du:.3e} "
                  f"(tol {E2E_FMPC_U:g})", flush=True)
            check(same and du <= E2E_FMPC_U and (n_conv >= B // 4 or st),
                  f"FMPC {model} fp32 {variant}: converged-lane contract")


def check_deriv64(device):
    """The headline cart-pole solve at fp32 with ``deriv_dtype="float64"``,
    which ``auto`` sends to K1 (fp64 unit, plain rollouts) where the
    generator would otherwise take it, against the plain path with the
    same derivatives: statuses and iterations equal, u within
    E2E_U_NORM_FP64."""
    B, N = HEADLINE
    problem = make_cartpole_problem(DT)
    cfg = DDPConfig(horizon_steps=N, max_iter=10, deriv_dtype="float64")
    x0s, us0 = hanging_inputs(B, N, torch.float32, device)
    impl = ddp_mod._resolve_backward_impl(cfg, problem, torch.float32,
                                          device, False, False)
    res, counts, _ = solve_counted(problem, cfg, x0s, us0)
    ref, ref_counts, _ = solve_counted(problem, dataclasses.replace(
        cfg, backward_impl="stacked", forward_impl="scan"), x0s, us0)
    st, it, du, dc = e2e_compare(res, ref)
    print(f"[e2e] cart-pole B={B} N={N} max_iter=10 float32 "
          f"deriv_dtype=float64: auto's backward {impl}, launches "
          f"{counts}; vs plain: status equal {st}, iters equal {it}, u norm "
          f"diff {du:.3e} (tol {E2E_U_NORM_FP64:g}), cost rel diff {dc:.3e}",
          flush=True)
    others = {key for key in KERNELS if key != "K1"}
    check(impl == "pallas" and counts["K1"] > 0
          and not any(counts[k] for k in others)
          and not any(ref_counts.values()),
          "deriv_dtype=float64: auto did not run K1 alone")
    check(st and it and du <= E2E_U_NORM_FP64,
          "deriv_dtype=float64: K1 path vs plain out of the contract")


def phase_driver(device, card):
    """``run_mpc`` with one bipedal controller (fp64, N=300) from x=0 at
    t=0 to DRIVER_END through ``auto`` (K1 at (2, 1) and the plain
    rollouts): the planned ZMP within ZMP_TOL of the reference at every
    step; then the last DRIVER_WINDOW steps again on the plain path and
    with ``make_closed_loop``, from the kernel path's state and warm
    start: iterations and statuses equal, states and inputs within
    1e-8."""
    problem, N = bipedal_problem(), BIPEDAL[1]
    cfg = DDPConfig(horizon_steps=N, max_iter=500)
    ref = example_ref_zmp_func(BIPEDAL_END_T)
    end_t = DRIVER_END - 0.5 * DT
    errs, warm = [], []

    def record(t, x, u, res):
        t64 = torch.tensor(t, dtype=torch.float64)
        errs.append(abs(float(u[0]) - float(ref(t64))))
        warm.append(shift_warm_start(problem, t + DT, res.us))

    reset_counts()
    log = run_mpc(DDPSolver(problem, cfg),
                  torch.zeros(2, dtype=torch.float64, device=device),
                  t0=0.0, end_t=end_t, callback=record)
    counts = read_counts()
    k = len(log.ts) - DRIVER_WINDOW
    t_k, x_k = float(log.ts[k]), torch.as_tensor(log.xs[k], device=device)
    reset_counts()
    plain = run_mpc(DDPSolver(problem, dataclasses.replace(
        cfg, backward_impl="stacked", forward_impl="scan")), x_k, t0=t_k,
        end_t=end_t, us_init=warm[k - 1])
    plain_counts = read_counts()
    closed = make_closed_loop(DDPSolver(problem, cfg), DRIVER_WINDOW)(
        t_k, x_k, warm[k - 1])
    torch.cuda.synchronize()
    rows = slice(k, None)
    d_plain = max(np.abs(plain.xs - log.xs[rows]).max(),
                  np.abs(plain.us - log.us[rows]).max())
    d_closed = max(np.abs(closed.xs.cpu().numpy() - log.xs[rows]).max(),
                   np.abs(closed.us.cpu().numpy() - log.us[rows]).max())
    same_plain = (np.array_equal(plain.solve_iters, log.solve_iters[rows])
                  and np.array_equal(plain.solve_status,
                                     log.solve_status[rows]))
    same_closed = (np.array_equal(closed.iters.cpu().numpy(),
                                  log.solve_iters[rows])
                   and np.array_equal(closed.status.cpu().numpy(),
                                      log.solve_status[rows]))
    wall = log.solve_wall_ms
    print(f"[driver] run_mpc bipedal N={N} fp64 auto, t=0..{log.ts[-1]:.2f} "
          f"({len(log.ts)} solves): max |u0 - ref ZMP| {max(errs):.3e} (tol "
          f"{ZMP_TOL:g}), iterations {int(log.solve_iters.min())}.."
          f"{int(log.solve_iters.max())}, statuses "
          f"{sorted(set(log.solve_status.tolist()))}, solve wall p50 "
          f"{np.percentile(wall, 50):.2f} ms, p99 {np.percentile(wall, 99):.2f}"
          f" ms; launches {counts} [{card}]", flush=True)
    print(f"[driver] last {DRIVER_WINDOW} steps from t={t_k:.2f}: plain path "
          f"(launches {plain_counts}) iterations and statuses equal "
          f"{same_plain}, max|dx|,|du| {d_plain:.3e}, solve wall p50 "
          f"{np.percentile(plain.solve_wall_ms, 50):.2f} ms; make_closed_loop "
          f"iterations and statuses equal {same_closed}, max|dx|,|du| "
          f"{d_closed:.3e} (tol {E2E_U_NORM_FP64:g})", flush=True)
    check(max(errs) <= ZMP_TOL, "driver: the planned ZMP left the reference")
    check(counts["K1"] > 0 and not any(counts[key] for key in REMAT_PATH),
          "driver: the bipedal solves did not run K1")
    check(not any(plain_counts.values()),
          "driver: the plain path launched a kernel")
    check(same_plain and same_closed and d_plain <= E2E_U_NORM_FP64
          and d_closed <= E2E_U_NORM_FP64,
          "driver: the plain path or make_closed_loop parts from run_mpc")


def fmpc_packed_parts(problem, cfg, co, v, gms, eps):
    """K10's own call: (its packed input, the terminal (s_T, P_T), the
    pack as a function)."""
    nu_s, tilde = k8.condensation(co, v.ss, v.nus, gms, eps)
    pack = lambda: k8.pack_fmpc_inputs(co, nu_s, tilde)
    return pack(), -co.Lx_bar_term, co.Lxx_term, pack


def phase_times_variants(device, card):
    """K2, K3, K9 and K10 against their plain versions and their parent
    kernel (CUDA events) beside their bounds, the packs' time apart; then
    solves/s of the oscillator at N=20 and the cart-pole serving shape per
    ``backward_variant`` (the bipedal solves/s per ``backward_dma`` are
    phase 3's, one 11-13 s solve each)."""
    dtype = torch.float32
    for model, (B, N) in (("cart-pole", HEADLINE), ("bipedal", BIPEDAL)):
        D, VxT, VxxT = (rollout_derivs if model == "cart-pole"
                        else bipedal_derivs)(B, N, dtype, device)
        nx = D.Fx.shape[1]
        cfg = DDPConfig(horizon_steps=N)
        lam = torch.full((B,), 1e-4, device=device)
        P = k1.pack_derivs(D)
        nbytes = moved_bytes("K1", B, N, 4, nx, 1)
        ops = B * N * riccati_ops(nx, 1, 1, False)
        label = f"{model} B={B} N={N}"
        keep = model == "cart-pole"
        plain = lambda: backward_stacked(cfg, D, VxT, VxxT, lam)
        t_k1 = cuda_ms(lambda: backward_fused(cfg, D, VxT, VxxT, lam),
                       inner=10)
        t_pack = cuda_ms(lambda: k1.pack_derivs(D), inner=10)
        print(f"[times] K1 {label} fp32 in this phase: {t_k1:.4f} ms; "
              f"pack_derivs {t_pack:.4f} ms [{card}]", flush=True)
        record_time("K2", lambda: backward_fused(cfg, D, VxT, VxxT, lam,
                                                 dma="chunked"),
                    plain, nbytes, ops, label, keep, card)
        record_time("K3", lambda: k1.backward_packed(cfg, P, nx, 1, VxT, VxxT,
                                                     lam),
                    lambda: backward_stacked(cfg, k1.unpack_derivs(P, nx, 1),
                                             VxT, VxxT, lam),
                    nbytes, ops, label, keep, card)
        t_both = cuda_ms(lambda: k1.backward_packed(
            cfg, k1.pack_derivs(D), nx, 1, VxT, VxxT, lam), inner=10)
        print(f"[times] K3 + pack_derivs {label} fp32: {t_both:.4f} ms beside "
              f"K1 {t_k1:.4f} ms [{card}]", flush=True)

    for key, model, (B, N), keep in (
            ("K9", "oscillator", FMPC_OSC_SHORT, True),
            ("K9", "cart-pole", (4096, 23), False),
            ("K10", "cart-pole", FMPC_SERVING, True),
            ("K10", "oscillator", FMPC_OSC, False)):
        problem, cfg, co, v, gms, eps, _ = fmpc_kernel_inputs(
            model, B, N, dtype, device, poison=False)
        nx, nu, ng = problem.state_dim, problem.input_dim, problem.ineq_dim
        label = f"{model} B={B} N={N}"
        t_k8 = cuda_ms(lambda: k8.backward_fmpc_fused(
            problem, cfg, co, v.ss, v.nus, gms, eps), inner=10)
        plain = lambda: fmpc_mod._backward_bm(problem, cfg, co, v.ss, v.nus,
                                              gms, eps)
        if key == "K9":
            print(f"[times] K8 {label} fp32 in this phase: {t_k8:.4f} ms "
                  f"[{card}]", flush=True)
            record_time(key, lambda: k8.backward_fmpc_fused(
                problem, cfg, co, v.ss, v.nus, gms, eps, variant="resident"),
                plain, fmpc_bytes("K8", B, N, 4, nx, nu, ng),
                B * N * fmpc_stage_ops(nx, nu, ng), label, keep, card)
            for k, variant in (("K9", "resident"), ("K8", "stream")):
                time_kernel_alone(k, fmpc_kernel_alone(
                    problem, cfg, co, v, gms, eps, variant), B, N, nx, nu,
                    ng, label, card)
            continue
        P_in, s_T, P_T, pack = fmpc_packed_parts(problem, cfg, co, v, gms,
                                                 eps)
        _, Fin, _, Fout = k8.field_offsets(nx, nu, ng)
        t_pack = cuda_ms(pack, inner=10)
        t_whole = cuda_ms(lambda: k8.backward_fmpc_fused(
            problem, cfg, co, v.ss, v.nus, gms, eps, variant="packed"),
            inner=10)
        print(f"[times] K8 {label} fp32 in this phase: {t_k8:.4f} ms; "
              f"pack_fmpc_inputs {t_pack:.4f} ms; the packed variant "
              f"end to end (condensation, pack, K10, slicing) {t_whole:.4f} "
              f"ms [{card}]", flush=True)
        record_time(key, lambda: k8.backward_fmpc_packed(
            problem, cfg, P_in, s_T, P_T, nx, nu, ng),
            lambda: k8.backward_fmpc_packed_plain(
                problem, cfg, P_in, s_T, P_T, nx, nu, ng),
            4 * B * (N * (Fin + Fout) + nx + nx * nx) + 2 * B,
            B * N * (fmpc_stage_ops(nx, nu, ng) - 5 * ng), label, keep, card)

    for model, (B, N) in (("oscillator", FMPC_OSC_SHORT),
                          ("cart-pole", FMPC_SERVING)):
        problem, x0s, var, eps = fmpc_start(model, B, N, dtype, device)
        for variant in k8.VARIANTS:
            solver = FmpcSolver(problem, fmpc_config(model, N),
                                backward_variant=variant)
            secs = timed_fmpc(solver, x0s, var, eps, 5)
            med = statistics.median(secs)
            print(f"[times] FMPC {model} solve_batch B={B} N={N} max_iter=5 "
                  f"fp32 backward_variant={variant}: median {med:.4f} s, "
                  f"{B / med:.1f} solves/s [{card}]", flush=True)


# --------------------------------------------------------------------------
# FMPC at the wide shapes: K8-K11 past (8, 4, 16) on the oscillating masses
# --------------------------------------------------------------------------

# The oscillating masses of Y. Wang and S. Boyd, "Fast Model Predictive
# Control Using Online Optimization", IEEE TCST 18(2), 2010, section V: six
# unit masses on a line, joined to each other and to the walls by unit
# springs (K = tridiag(-1, 2, -1), no damping), actuator j pushing masses
# 2j - 1 and 2j apart, exact zero-order hold at dt = 0.5, running cost
# (|x|^2 + |u|^2) / 2, terminal |x|^2 / 2, |x| <= 4, |u| <= 0.5: (nx, nu,
# ng) = (12, 3, 30), N = 30.  Eight masses with a force on each, (16, 8,
# 48), and seeded random stage fields at the kernels' ceiling, (16, 16,
# 64), for the kernel checks.  The main path: solve_batch at B=4096, N=30,
# fp32, 5 iterations, kkt_error_thre=0 (fixed work, as the FMPC serving
# cell); K9 where its horizon fits a block (N <= 14 at the masses:
# MASSES_RESIDENT_N).
MASSES = (12, 3, 30)
MASSES_DT = 0.5
MASSES_SOLVE = (4096, 30)
MASSES_RESIDENT_N = 12
MASSES_BATCHES = (1024, 37, 1)
MASSES_PLAIN_B = 1024
WIDE_FMPC_SHAPES = ((16, 8, 48), (16, 16, 64))
WIDE_FMPC_BATCHES, WIDE_FMPC_N = (256, 37), 12
WIDE_FMPC_KEY = {"stream": "K8@12x3x30", "resident": "K9@12x3x30",
                 "packed": "K10@12x3x30"}


def masses_matrices(n_masses, pairs):
    """(A, B) float64 of ``n_masses`` unit masses joined by unit springs,
    actuator j pushing mass pairs[j][0] by +1 and pairs[j][1] (if any) by
    -1, with an exact zero-order hold at MASSES_DT."""
    import scipy.linalg
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


@functools.lru_cache(maxsize=None)
def masses_problem(shape=MASSES):
    """The masses problem at (12, 3, 30), or the eight masses at (16, 8,
    48)."""
    A, Bm = masses_matrices(*({(12, 3, 30): (6, [(0, 1), (2, 3), (4, 5)]),
                               (16, 8, 48): (8, [(j,) for j in range(8)])}
                              [shape]))
    nx, nu, ng = shape
    mat = lambda a, x: torch.as_tensor(a, dtype=x.dtype, device=x.device)
    return Problem(
        dt=MASSES_DT, state_dim=nx, input_dim=nu, ineq_dim=ng,
        dynamics=lambda t, x, u: mat(A, x) @ x + mat(Bm, x) @ u,
        running_cost=lambda t, x, u: 0.5 * (torch.sum(x * x)
                                            + torch.sum(u * u)),
        terminal_cost=lambda t, x: 0.5 * torch.sum(x * x),
        ineq_const=lambda t, x, u: torch.cat([x - 4.0, -x - 4.0, u - 0.5,
                                              -u - 0.5]))


def masses_start(B, N, dtype, device, seed=0):
    """(problem, x0s [B, 12] uniform in [-1.5, 1.5] from a seed, the reset
    warm start, eps [B])."""
    problem = masses_problem()
    x0 = np.random.default_rng(seed).uniform(-1.5, 1.5, size=(B, 12))
    v1 = fmpc_variable_reset(N, *MASSES, dtype=dtype, device=device)
    var = FmpcVariable(**{f: getattr(v1, f).expand(
        B, *getattr(v1, f).shape).contiguous() for f in VARIABLE})
    return (problem, torch.as_tensor(x0, dtype=dtype, device=device), var,
            torch.full((B,), 1e-4, dtype=dtype, device=device))


def wide_fmpc_inputs(shape, B, N, dtype, device, poison=True, seed=5):
    """First-iteration K8-K11 inputs at a wide shape, made from a seed:
    the masses shapes through ``_coeffs_bm`` at a random iterate (s, nu in
    [0.2, 1.2)), the ceiling's random stage fields (A near the identity,
    positive definite Lxx, Luu, Lxx_term); mask row 0 off on every third
    stage; with ``poison`` (B > 3) lane 1 non-PD (Luu = -1e4 I), lane 2
    NaN (one NaN A at stage 5), lane 3's Luu large and indefinite on
    stages 1 and N - 2 (its G pivots in the Gauss-Jordan fallback).
    Returns (problem (its dt), config, coefficients, variable, masks, eps,
    x0 [nx, B])."""
    nx, nu, ng = shape
    rng = np.random.default_rng(seed)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    v = FmpcVariable(
        xs=as_t(0.3 * rng.normal(size=(N + 1, nx, B))),
        us=as_t(0.3 * rng.normal(size=(N, nu, B))),
        lambdas=as_t(0.3 * rng.normal(size=(N + 1, nx, B))),
        ss=as_t(0.2 + rng.uniform(size=(N, ng, B))),
        nus=as_t(0.2 + rng.uniform(size=(N, ng, B))))
    cfg = FmpcConfig(horizon_steps=N)
    if shape in (MASSES, (16, 8, 48)):
        problem = masses_problem(shape)
        co = fmpc_mod._coeffs_bm(problem, cfg, torch.zeros(
            (), dtype=dtype, device=device), v)
    else:
        problem = types.SimpleNamespace(dt=0.01)

        def spd(n, lead):
            m = rng.normal(size=(*lead, n, n, B)) / np.sqrt(n)
            return (np.einsum("...ikb,...jkb->...ijb", m, m)
                    + np.eye(n)[..., None])

        f = lambda a: as_t(a).contiguous()
        co = fmpc_mod._StCoeffs(
            A=f(np.eye(nx)[None, :, :, None]
                + 0.05 * rng.normal(size=(N, nx, nx, B))),
            B=f(0.1 * rng.normal(size=(N, nx, nu, B))),
            C=f(rng.normal(size=(N, ng, nx, B)) / np.sqrt(ng)),
            D=f(rng.normal(size=(N, ng, nu, B)) / np.sqrt(ng)),
            Lx=f(rng.normal(size=(N, nx, B))),
            Lu=f(rng.normal(size=(N, nu, B))),
            Lxx=f(spd(nx, (N,))), Luu=f(spd(nu, (N,))),
            Lxu=f(0.1 * rng.normal(size=(N, nx, nu, B))),
            x_bar=f(0.1 * rng.normal(size=(N, nx, B))),
            g_bar=f(rng.normal(size=(N, ng, B))),
            Lx_bar=f(rng.normal(size=(N, nx, B))),
            Lu_bar=f(rng.normal(size=(N, nu, B))),
            Lx_term=f(rng.normal(size=(nx, B))),
            Lxx_term=f(spd(nx, ())),
            Lx_bar_term=f(rng.normal(size=(nx, B))))
    gms = torch.ones((N, ng), dtype=dtype, device=device)
    gms[::3, 0] = 0.0
    if poison and B > 3:
        co.Luu[:, :, :, 1] = -1e4 * torch.eye(nu, dtype=dtype,
                                              device=device)[None]
        co.A[min(5, N - 1), 0, 0, 2] = float("nan")
        m = rng.normal(size=(nu, nu))
        for i in {1, N - 2}:
            co.Luu[i, :, :, 3] = as_t(200.0 * (m + m.T))
    x0 = as_t(rng.normal(size=(nx, B))).contiguous()
    return (problem, cfg, co, v, gms,
            torch.full((B,), 1e-4, dtype=dtype, device=device), x0)


def first_of(case, B, N):
    """A ``wide_fmpc_inputs`` case cut to its first B lanes and N stages
    (the terminal fields' first B lanes)."""
    problem, config, co, v, gms, eps, x0 = case
    cut = lambda a, staged=True: (a[:N] if staged else a)[..., :B].contiguous()
    co = fmpc_mod._StCoeffs(*(cut(a, name not in (
        "Lx_term", "Lxx_term", "Lx_bar_term"))
        for name, a in zip(fmpc_mod._StCoeffs._fields, co)))
    v = dataclasses.replace(v, ss=cut(v.ss), nus=cut(v.nus))
    return (problem, dataclasses.replace(config, horizon_steps=N), co, v,
            gms[:N].contiguous(), eps[:B].contiguous(), cut(x0, False))


def hold_wide_fmpc(case, variants, batches):
    """The wide backward kernels of ``variants`` and K11 on the first B
    lanes of one case (``wide_fmpc_inputs``, ``first_of``) for each B of
    ``batches`` against their plain versions on the card, both
    ``break_if_llt_fails`` (the plain backward run once on the case's
    lanes, each lane's result its own): masks equal, within KERNEL_TOL
    normalized on the finite lanes (the ok ones with
    ``break_if_llt_fails``); K9 and K10 bit for bit with K8; K11 fed K8's
    fallback gains.  Updates the record's max_abs_err; returns the checks
    that were bit for bit with K8."""
    problem, config, co, v, gms, eps, _ = case
    N, nx, nu, ng = co.A.shape[0], co.A.shape[1], co.B.shape[2], co.C.shape[1]
    dtype = eps.dtype
    name = f"{nx}x{nu}x{ng}"
    same = 0
    gains = {}
    for brk in (False, True):
        cfg = dataclasses.replace(config, break_if_llt_fails=brk)
        whole = fmpc_mod._backward_bm(problem, cfg, co, v.ss, v.nus, gms, eps)
        for B in batches:
            _, _, co_b, v_b, _, eps_b, _ = first_of(case, B, N)
            plain = tuple(a[..., :B] for a in whole)
            label = (f"{name} B={B} N={N} {str(dtype)[6:]} "
                     f"break_if_llt_fails={brk}")
            outs = {variant: k8.backward_fmpc_fused(
                problem, cfg, co_b, v_b.ss, v_b.nus, gms, eps_b,
                variant=variant) for variant in variants}
            torch.cuda.synchronize()
            # a lane whose LLT failed with break_if_llt_fails runs on with a
            # factor of unit pivots, whose values the solve discards and the
            # order of a sum moves freely: the values are held on the ok
            # lanes
            lanes = plain[5] & plain[4] if brk else plain[5]
            for variant, out in outs.items():
                key = WIDE_FMPC_KEY[variant]
                err, _ = hold_fmpc_backward(label, plain, out, dtype, B,
                                            key=key, lanes=lanes)
                KERNELS[key].max_abs_err = max(KERNELS[key].max_abs_err, err)
                if variant != "stream":
                    bits = all(same_bits(a, b)
                               for a, b in zip(outs["stream"], out))
                    same += bits
                    check(bits, f"{key} {label}: not bit for bit with "
                          f"K8-wide")
            if B > 3:
                fin = plain[5]
                check(not bool(fin[2]) and bool(fin[0])
                      and bool(fin[4:].all()) and bool(plain[4][1]) != brk,
                      f"K8-wide {label}: the poisoned lanes' masks are wrong")
            if not brk:
                gains[B] = outs["stream"][:2]
    for B in batches:
        _, _, co_b, _, _, _, x0 = first_of(case, B, N)
        args = (co_b.A, co_b.B, co_b.x_bar, *gains[B], (0.1 * x0).contiguous())
        plain = k11.forward_fmpc_deltas_plain(*args)
        out = k11.forward_fmpc_deltas_fused(*args)
        torch.cuda.synchronize()
        finite = fmpc_mod._finite(plain[0]) & fmpc_mod._finite(plain[1])
        err = report(f"K11@{name} B={B} N={N} {str(dtype)[6:]}", {
            n: norm_err(a, b, finite)
            for n, a, b in zip(("dxs", "dus"), plain, out)}, dtype)
        KERNELS["K11@12x3x30"].max_abs_err = max(
            KERNELS["K11@12x3x30"].max_abs_err, err)
    return same


def masses_solve(cfg, B, N, dtype, device, variant="stream", seed=0):
    """One masses solve_batch with every launch counter reset just before
    and read just after: (result, counts, host syncs, resolved impls,
    seconds)."""
    problem, x0s, var, eps = masses_start(B, N, dtype, device, seed)
    solver = FmpcSolver(problem, cfg, backward_variant=variant)
    impls = fmpc_mod._resolve_impls(cfg, problem, dtype, device)
    torch.cuda.synchronize()
    reset_counts()
    start = time.perf_counter()
    res = solver.solve_batch(0.0, x0s, var, eps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    return res, read_counts(), solver.host_syncs, impls, secs


def phase_fmpc_wide(device, card):
    """FMPC past (8, 4, 16): K8, K9, K10 and K11 at the wide shapes
    (``csrc/fmpc_backward_wide.cuh``, ``fmpc_backward_packed_wide.cuh``,
    ``fmpc_stage_wide.cuh``; K11 ``fmpc_forward.cuh``'s wide group) against
    their plain versions on the card, the masses solves through ``auto``
    and each ``backward_variant`` with their launch counters, fp64 and
    fp32 against the plain path, and the kernels' times."""
    nx, nu, ng = MASSES
    dtypes = (torch.float32, torch.float64)
    same = 0
    start = time.perf_counter()
    for dtype in dtypes:
        # each shape's cases are the first lanes and stages of one
        case = wide_fmpc_inputs(MASSES, MASSES_BATCHES[0], MASSES_SOLVE[1],
                                dtype, device)
        for n, variants in ((MASSES_SOLVE[1], ("stream", "packed")),
                            (MASSES_RESIDENT_N, ("stream", "resident"))):
            same += hold_wide_fmpc(first_of(case, MASSES_BATCHES[0], n),
                                   variants, MASSES_BATCHES)
        for shape in WIDE_FMPC_SHAPES:
            case = wide_fmpc_inputs(shape, WIDE_FMPC_BATCHES[0], WIDE_FMPC_N,
                                    dtype, device)
            variants = ("stream", "packed") + (
                ("resident",) if k8.resident_fits(*shape, WIDE_FMPC_N, dtype)
                else ())
            same += hold_wide_fmpc(case, variants, WIDE_FMPC_BATCHES)
    print(f"[fmpc-wide] K9-wide and K10-wide bit for bit with K8-wide in "
          f"{same} checks; the checks {time.perf_counter() - start:.1f} s",
          flush=True)
    start = time.perf_counter()

    # the main path: the masses through auto, and per backward_variant
    B, N = MASSES_SOLVE
    cfg = FmpcConfig(horizon_steps=N, max_iter=5, kkt_error_thre=0.0)
    for variant, n, keys in (("stream", N, ("K8@12x3x30", "K11@12x3x30")),
                             ("resident", MASSES_RESIDENT_N,
                              ("K9@12x3x30", "K11@12x3x30")),
                             ("packed", N, ("K10@12x3x30", "K11@12x3x30"))):
        res, counts, syncs, impls, secs = masses_solve(
            dataclasses.replace(cfg, horizon_steps=n), B, n, torch.float32,
            device, variant)
        finite = all(bool(torch.isfinite(getattr(res.variable, f)).all())
                     for f in VARIABLE)
        ran = {k: c for k, c in counts.items() if c}
        print(f"[e2e] FMPC masses B={B} N={n} max_iter=5 kkt_error_thre=0 "
              f"fp32 backward_variant={variant} ({impls}): launches {ran}, "
              f"host syncs {syncs}, {secs:.3f} s, status counts "
              f"{torch.bincount(res.status, minlength=7).tolist()}, finite "
              f"{finite} [{card}]", flush=True)
        check(impls == ("pallas", "fused") and finite
              and ran == {k: cfg.max_iter for k in keys},
              f"the masses solve ({variant}) did not run {keys} once an "
              f"iteration, and nothing else")
        KERNELS[keys[0]].launches = counts[keys[0]]
        if variant == "stream":
            KERNELS["K11@12x3x30"].launches = counts["K11@12x3x30"]

    # against the plain path: fp64 to convergence, fp32's converged set
    plain_kw = {"backward_impl": "stacked", "forward_impl": "scan"}
    B = MASSES_PLAIN_B
    cfg = FmpcConfig(horizon_steps=N, max_iter=30)
    a, ca, _, _, ta = masses_solve(cfg, B, N, torch.float64, device)
    b, cb, _, _, tb = masses_solve(dataclasses.replace(cfg, **plain_kw), B,
                                   N, torch.float64, device)
    st, it, dv, n_status = fmpc_compare(a, b)
    print(f"[e2e] FMPC masses B={B} N={N} fp64 default config, "
          f"max_iter=30: auto launches {ca['K8@12x3x30']} K8-wide, "
          f"{ca['K11@12x3x30']} "
          f"K11-wide, {ta:.3f} s; plain {tb:.3f} s; status counts "
          f"{n_status}, iterations {torch.unique(a.iters).tolist()}; auto "
          f"vs plain: status equal {st}, iters equal {it}, variable norm "
          f"diff {dv:.3e} (tol {E2E_FMPC_FP64:g}) [{card}]", flush=True)
    check(ca["K8@12x3x30"] > 0 and not any(cb.values()),
          "FMPC masses fp64: auto skipped K8-wide or plain launched one")
    check(st and it and dv <= E2E_FMPC_FP64
          and int((a.status == FmpcStatus.SUCCEEDED).sum()) >= B // 2,
          "FMPC masses fp64: auto vs plain out of the contract, or fewer "
          "than half the lanes converged")
    cfg32 = FmpcConfig(horizon_steps=N, max_iter=30, kkt_error_thre=1e-2)
    a = masses_solve(cfg32, B, N, torch.float32, device)[0]
    b = masses_solve(dataclasses.replace(cfg32, **plain_kw), B, N,
                     torch.float32, device)[0]
    conv = a.status == FmpcStatus.SUCCEEDED
    same_set = torch.equal(conv, b.status == FmpcStatus.SUCCEEDED)
    n_conv = int(conv.sum())
    du = ((a.variable.us - b.variable.us)[conv].abs().max().item()
          if n_conv else math.nan)
    print(f"[e2e] FMPC masses B={B} N={N} max_iter=30 kkt_error_thre=1e-2 "
          f"fp32: converged {n_conv}/{B} (plain "
          f"{int((b.status == FmpcStatus.SUCCEEDED).sum())}), converged set "
          f"equal {same_set}, max|du| on it {du:.3e} (tol {E2E_FMPC_U:g})",
          flush=True)
    check(same_set and n_conv >= B // 4 and du <= E2E_FMPC_U,
          "FMPC masses fp32 converged-lane contract failed")
    print(f"[fmpc-wide] the solves {time.perf_counter() - start:.1f} s",
          flush=True)

    # times at the main path's shape (K9 at its horizon)
    B, N = MASSES_SOLVE
    for key, n in (("K8@12x3x30", N), ("K9@12x3x30", MASSES_RESIDENT_N),
                   ("K10@12x3x30", N), ("K11@12x3x30", N)):
        problem, cfg, co, v, gms, eps, x0 = wide_fmpc_inputs(
            MASSES, B, n, torch.float32, device, poison=False)
        ops = B * n * fmpc_stage_ops(nx, nu, ng)
        label = f"masses B={B} N={n}"
        if key in ("K8@12x3x30", "K9@12x3x30"):
            variant = "stream" if key.startswith("K8") else "resident"
            record_time(key, lambda: k8.backward_fmpc_fused(
                problem, cfg, co, v.ss, v.nus, gms, eps, variant=variant),
                lambda: fmpc_mod._backward_bm(problem, cfg, co, v.ss, v.nus,
                                              gms, eps),
                fmpc_bytes("K8", B, n, 4, nx, nu, ng), ops, label, True,
                card)
        elif key == "K10@12x3x30":
            P_in, s_T, P_T, pack = fmpc_packed_parts(problem, cfg, co, v,
                                                     gms, eps)
            _, Fin, _, Fout = k8.field_offsets(nx, nu, ng)
            print(f"[times] pack_fmpc_inputs {label} fp32: "
                  f"{cuda_ms(pack, inner=10):.4f} ms [{card}]", flush=True)
            record_time(key, lambda: k8.backward_fmpc_packed(
                problem, cfg, P_in, s_T, P_T, nx, nu, ng),
                lambda: k8.backward_fmpc_packed_plain(
                    problem, cfg, P_in, s_T, P_T, nx, nu, ng),
                4 * B * (n * (Fin + Fout) + nx + nx * nx) + 2 * B,
                B * n * (fmpc_stage_ops(nx, nu, ng) - 5 * ng), label, True,
                card)
        else:
            ks, Ks, *_ = k8.backward_fmpc_fused(problem, cfg, co, v.ss,
                                                v.nus, gms, eps)
            args = (co.A, co.B, co.x_bar, ks, Ks, (0.1 * x0).contiguous())
            record_time(key, lambda: k11.forward_fmpc_deltas_fused(*args),
                        lambda: k11.forward_fmpc_deltas_plain(*args),
                        fmpc_bytes("K11", B, n, 4, nx, nu, ng),
                        B * n * (2 * nx * nu + nx * (2 * nx + 2 * nu)),
                        label, True, card)
    problem, x0s, var, eps = masses_start(B, N, torch.float32, device)
    for pair in (("auto", "auto"), ("stacked", "scan")):
        solver = FmpcSolver(problem, FmpcConfig(
            horizon_steps=N, max_iter=5, kkt_error_thre=0.0,
            backward_impl=pair[0], forward_impl=pair[1]))
        secs = timed_fmpc(solver, x0s, var, eps,
                          1 if pair[0] == "stacked" else 3)
        med = statistics.median(secs)
        print(f"[times] FMPC masses solve_batch B={B} N={N} max_iter=5 "
              f"kkt_error_thre=0 fp32 backward={pair[0]} forward={pair[1]}: "
              f"median {med:.4f} s, {B / med:.1f} solves/s, host syncs "
              f"{solver.host_syncs} [{card}]", flush=True)


# The wide FMPC backward (K8@12x3x30, K9@12x3x30) beside the parent's
# build: the fmpc-wide phase's cases it is held on (shape, B of the
# case's first lanes, N, variants), and the shapes it is timed at (B, N)
# with K9 at its horizon.
FMPC_WIDE_GROUPS_CASES = (
    [(MASSES, B, MASSES_SOLVE[1], ("stream", "packed"))
     for B in MASSES_BATCHES]
    + [(MASSES, B, MASSES_RESIDENT_N, ("stream", "resident"))
       for B in MASSES_BATCHES]
    + [(shape, B, WIDE_FMPC_N, ("stream", "packed", "resident"))
       for shape in WIDE_FMPC_SHAPES for B in WIDE_FMPC_BATCHES])
FMPC_WIDE_GROUPS_TIMED = ((MASSES_SOLVE[0], MASSES_SOLVE[1]),
                          (1, MASSES_SOLVE[1]))


def fmpc_wide_profile(key, prof, N, B, lanes, resident, ms, card):
    """One profile launch's summary (``prof`` the cycles of
    ``k8.profile_values``): each part's cycles a stage for the mean lane
    and the slowest (the most cycles over its stages), the ring's wait
    against the stage, and the producer's empty wait and issue a stage
    (mean over the blocks; K9: the horizon's issue); the clock the slowest
    lane implies over the profile kernel's ``ms`` where one block runs (B
    <= its lanes)."""
    parts = len(k8.WIDE_PHASES)
    cyc = prof.double().cpu()
    lane = cyc[:parts * N * B].view(parts, N, B)
    blocks, chunks = -(-B // lanes), 1 if resident else N
    prod = cyc[parts * N * B:][:2 * N * blocks].view(2, N, blocks)
    per = lane.sum(1)                                    # [parts, B]
    slow = int(per.sum(0).argmax())
    for who, c in ((f"slowest lane {slow}", per[:, slow]),
                   ("mean lane", per.mean(1))):
        total = c.sum().item()
        wait, stage = c[0].item(), total - c[0].item()
        print(f"[fmpc-wide-groups] profile {key} {who}: {total / N:.0f} "
              f"cycles a stage: ring wait {wait / N:.0f} "
              f"({100 * wait / total:.1f} %), "
              f"stage {stage / N:.0f}; " + "; ".join(
                  f"{name} {v / N:.0f} ({100 * v / total:.1f} %)"
                  for name, v in zip(k8.WIDE_PHASES, c.tolist())),
              flush=True)
    used = prod[:, :chunks]
    clock = (f"; {per.sum(0)[slow].item() / (ms * 1e6):.3f} GHz (the "
             f"slowest lane's cycles over the kernel's time)"
             if blocks == 1 else "")
    print(f"[fmpc-wide-groups] profile {key}: producer "
          f"{'the horizon at once' if resident else 'a stage at a time'}, "
          f"{blocks} blocks of {lanes} lanes: empty wait "
          f"{used[0].mean().item():.0f}, issue {used[1].mean().item():.0f} "
          f"cycles (mean), the first stage's issue "
          f"{used[1, 0].mean().item():.0f}; the profile kernel {ms:.4f} ms"
          f"{clock} [{card}]", flush=True)


def phase_fmpc_wide_groups(device, card, baseline):
    """K8-wide and K9-wide (``csrc/fmpc_backward_wide.cuh``) at the
    masses' (12, 3, 30), their profile build and, with ``baseline``
    (another checkout's root), that checkout's K8-wide and K9-wide from
    its headers and unit text: built at once, each with its nvcc seconds
    and ptxas' report.  On every case of FMPC_WIDE_GROUPS_CASES (the
    fmpc-wide phase's: the masses at B=1024, 37 and 1, N=30 and 12, (16,
    8, 48) and (16, 16, 64) at B=256 and 37, N=12), fp32 and fp64, both
    break_if_llt_fails: this K8, K9 (where its horizon fits), K10 and the
    profile builds bit for bit with the baseline's K8 (this K8 without a
    baseline), K10 on its N rows, ok and finite masks included.  Then
    timed in turns with the baseline's at FMPC_WIDE_GROUPS_TIMED (K9 at
    its horizon, N=12), fp32 and fp64, K10-wide beside them, the profile's
    cycles a part at B=1 and 4096, N=30 (K8) and 12 (K9), and, with a
    baseline, K8 and K9 at (16, 8, 48) and (16, 16, 64) in turns with the
    baseline's at B=4096 (K8 N=12, K9 N=2 and its longest horizon)."""
    fp32, fp64 = torch.float32, torch.float64
    nx, nu, ng = MASSES
    shapes = (MASSES,) + WIDE_FMPC_SHAPES
    units, index = [], {}

    def unit(key, name, text, flags, csrc=kbuild.CSRC):
        index[key] = len(units)
        units.append((name, text, flags, csrc))

    for dtype in (fp32, fp64):
        for shape in shapes:
            for variant in ("stream", "resident", "packed"):
                unit(("this", variant, shape, dtype),
                     k8.unit_name(*shape, dtype, variant),
                     k8.unit_source(*shape, dtype, variant), k8.FMPC_FLAGS)
        for variant in ("stream", "resident"):
            unit(("profile", variant, MASSES, dtype),
                 k8.unit_name(*MASSES, dtype, variant, profile=True),
                 k8.unit_source(*MASSES, dtype, variant, profile=True),
                 k8.FMPC_FLAGS)
    if baseline:
        pk8 = parent_module(baseline, "fmpc_backward")
        parent_csrc = Path(baseline).resolve() / "nmpc_tpu_torch" / "csrc"
        for dtype in (fp32, fp64):
            for shape in shapes:
                for variant in ("stream", "resident"):
                    unit(("baseline", variant, shape, dtype),
                         k8.unit_name(*shape, dtype, variant) + "_parent",
                         pk8.unit_source(*shape, dtype, variant),
                         pk8.FMPC_FLAGS, parent_csrc)

    def compile_unit(u):
        begin = time.perf_counter()
        lib = kbuild.build_generated(*u)
        return lib, time.perf_counter() - begin

    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(units)) as pool:
        built = list(pool.map(compile_unit, units))
    print(f"[fmpc-wide-groups] {len(built)} units in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    fns = {}
    for key, (name, _, _, csrc), (lib, secs) in zip(index, units, built):
        print(f"[fmpc-wide-groups] {name} (headers "
              f"{os.path.relpath(csrc, ROOT)}): nvcc {secs:.1f} s; "
              f"{ptxas_report(lib)}; spill stores / loads "
              f"{spill_bytes(lib)} bytes", flush=True)
        if key[0] == "this" and key[2] == MASSES:
            check(spill_bytes(lib) in (None, (0, 0)), f"{name}: ptxas spills")
        fns[key] = (pk8.bind(kbuild.load(lib), key[1])
                    if key[0] == "baseline" else
                    k8.bind(kbuild.load(lib), key[1],
                            profile=key[0] == "profile"))

    def outputs(key, case, cfg, prof=None):
        problem, _, co, v, gms, eps, _ = case
        if key[1] == "packed":
            nu_s, tilde = k8.condensation(co, v.ss, v.nus, gms, eps)
            P_in, ld3 = k8.padded_lanes(k8.pack_fmpc_inputs(co, nu_s, tilde))
            s = co.A.shape[1], co.B.shape[2], co.C.shape[1]
            return as_k8_outputs(k8.launch_packed(
                fns[key], problem, cfg, P_in, ld3, -co.Lx_bar_term,
                co.Lxx_term, *s), s[0], s[1], co.A.shape[0])
        return fmpc_kernel_alone(problem, cfg, co, v, gms, eps, key[1],
                                 fn=fns[key], prof=prof)()

    same = 0
    start = time.perf_counter()
    for dtype in (fp32, fp64):
        dname = str(dtype)[6:]
        whole = {shape: wide_fmpc_inputs(
            shape, MASSES_BATCHES[0] if shape == MASSES
            else WIDE_FMPC_BATCHES[0],
            MASSES_SOLVE[1] if shape == MASSES else WIDE_FMPC_N, dtype,
            device) for shape in shapes}
        for shape, B, N, variants in FMPC_WIDE_GROUPS_CASES:
            case = first_of(whole[shape], B, N)
            fits = k8.resident_fits(*shape, N, dtype)
            for brk in (False, True):
                cfg = dataclasses.replace(case[1], break_if_llt_fails=brk)
                ref_key = ("baseline" if baseline else "this", "stream",
                           shape, dtype)
                ref = outputs(ref_key, case, cfg)
                outs = {}
                for variant in variants:
                    if variant == "resident" and not fits:
                        continue
                    outs[f"this {variant}"] = outputs(
                        ("this", variant, shape, dtype), case, cfg)
                    if ("profile", variant, shape, dtype) in fns:
                        prof = torch.zeros(k8.profile_values(N, B),
                                           dtype=torch.int64, device=device)
                        outs[f"profile {variant}"] = outputs(
                            ("profile", variant, shape, dtype), case, cfg,
                            prof)
                    if (variant == "resident" and baseline and
                            pk8.resident_fits(*shape, N, dtype)):
                        outs["baseline resident"] = outputs(
                            ("baseline", "resident", shape, dtype), case,
                            cfg)
                torch.cuda.synchronize()
                # K10 gives the N rows of s and P before the terminal one
                equal = {k: all(same_bits(a[:len(b)], b[:len(a)])
                                for a, b in zip(ref, o))
                         for k, o in outs.items()}
                same += sum(equal.values())
                label = (f"{'x'.join(map(str, shape))} B={B} N={N} {dname} "
                         f"break_if_llt_fails={brk}")
                print(f"[fmpc-wide-groups] {label}: ok {int(ref[4].sum())}"
                      f"/{B}, finite {int(ref[5].sum())}/{B}; bit for bit "
                      f"with the {ref_key[0]} K8-wide {equal}", flush=True)
                check(all(equal.values()), f"{label}: a build differs from "
                      f"the {ref_key[0]} K8-wide")
    print(f"[fmpc-wide-groups] {same} checks bit for bit; the checks "
          f"{time.perf_counter() - start:.1f} s", flush=True)

    for dtype in (fp32, fp64):
        dname = str(dtype)[6:]
        for B, N in FMPC_WIDE_GROUPS_TIMED:
            for variant, n in (("stream", N), ("resident", MASSES_RESIDENT_N)):
                case = wide_fmpc_inputs(MASSES, B, n, dtype, device,
                                        poison=False)
                problem, cfg, co, v, gms, eps, _ = case
                calls = {}
                for who in ("baseline", "this") if baseline else ("this",):
                    calls[f"{who} K{8 if variant == 'stream' else 9}"] = (
                        fmpc_kernel_alone(problem, cfg, co, v, gms, eps,
                                          variant,
                                          fn=fns[who, variant, MASSES,
                                                 dtype]))
                if variant == "stream":
                    nu_s, tilde = k8.condensation(co, v.ss, v.nus, gms, eps)
                    P_in, ld3 = k8.padded_lanes(k8.pack_fmpc_inputs(
                        co, nu_s, tilde))
                    calls["this K10"] = functools.partial(
                        k8.launch_packed, fns["this", "packed", MASSES, dtype],
                        problem, cfg, P_in, ld3, -co.Lx_bar_term, co.Lxx_term,
                        nx, nu, ng)
                timed_in_turns(calls, f"masses B={B} N={n}", card,
                               tag="fmpc-wide-groups", dtype=dname)
                prof = torch.zeros(k8.profile_values(n, B), dtype=torch.int64,
                                   device=device)
                pcall = fmpc_kernel_alone(
                    problem, cfg, co, v, gms, eps, variant,
                    fn=fns["profile", variant, MASSES, dtype], prof=prof)
                ms = cuda_ms(pcall, inner=2, reps=5)
                prof.zero_()
                pcall()
                torch.cuda.synchronize()
                lanes = (k8.wide_rule(*MASSES, dtype).max_lanes
                         if variant == "stream" else
                         k8.wide_rule(*MASSES, dtype, k8.WIDE_GROUP)
                         .resident_lanes(n, B))
                fmpc_wide_profile(
                    f"K{8 if variant == 'stream' else 9}@12x3x30 B={B} N={n} "
                    f"{dname}", prof, n, B, lanes, variant == "resident", ms,
                    card)
    if not baseline:
        return
    # the other wide shapes in turns with the baseline's: K8 at N=12, K9 at
    # N=2 (fp64 (16, 8, 48): 4 lanes a block) and at its longest horizon
    for dtype in (fp32, fp64):
        dname = str(dtype)[6:]
        for shape in WIDE_FMPC_SHAPES:
            n9 = max(n for n in range(1, k8.RESIDENT_MAX_N + 1)
                     if k8.resident_fits(*shape, n, dtype)
                     and pk8.resident_fits(*shape, n, dtype))
            for variant, n in (("stream", WIDE_FMPC_N),
                               *(("resident", n) for n in sorted({2, n9}))):
                problem, cfg, co, v, gms, eps, _ = wide_fmpc_inputs(
                    shape, MASSES_SOLVE[0], n, dtype, device, poison=False)
                lanes = (k8.wide_rule(*shape, dtype, k8.WIDE_GROUP),
                         pk8.wide_rule(*shape, dtype))
                kind = "K8" if variant == "stream" else (
                    "K9 (lanes {}, the baseline's {})".format(*(
                        r.resident_lanes(n, MASSES_SOLVE[0]) for r in lanes)))
                timed_in_turns(
                    {f"{who} {kind}": fmpc_kernel_alone(
                        problem, cfg, co, v, gms, eps, variant,
                        fn=fns[who, variant, shape, dtype])
                     for who in ("baseline", "this")},
                    f"{'x'.join(map(str, shape))} B={MASSES_SOLVE[0]} N={n}",
                    card, tag="fmpc-wide-groups", dtype=dname)


# --------------------------------------------------------------------------
# The centroidal model: K1 at (9, 16), its solves and its driver
# --------------------------------------------------------------------------

def centroidal_problem(boxed=False):
    return make_centroidal_problem(
        CENTROIDAL_DT, force_limits=CENTROIDAL_FORCE if boxed else None)


def centroidal_start(problem, B, N, dtype, device):
    """(x0s, us0, masked [N, 16]) from CENTROIDAL_T0: x0 about the
    standing pose (bench_all.py:111-115), 5 N a ridge where the stage's
    inputs are active and 0 where they are masked (a masked input keeps
    its warm start)."""
    rng = np.random.default_rng(0)
    x0 = np.concatenate([[0.0, 0.0, 1.0], np.zeros(6)])
    x0s = torch.as_tensor(np.tile(x0, (B, 1)) + 0.02 * rng.normal(
        size=(B, 9)), dtype=dtype, device=device)
    t0 = torch.tensor(CENTROIDAL_T0, dtype=dtype, device=device)
    masked = torch.stack([~problem.input_mask(t)
                          for t in _stage_times(problem, t0, N)])
    us0 = torch.where(masked, 0.0, 5.0).to(dtype)[None].expand(
        B, N, problem.input_dim).contiguous()
    return x0s, us0, masked


def centroidal_derivs(B, N, dtype, device, poison=True):
    """K1@9x16's input: the stage derivatives of a centroidal rollout from
    CENTROIDAL_T0 (first-iteration data across the flight phase); with
    ``poison``, lane 1 made non-PD and lane 2 NaN-poisoned as K1's own
    check does."""
    problem = centroidal_problem()
    cfg = DDPConfig(horizon_steps=N)
    x0s, us0, _ = centroidal_start(problem, B, N, dtype, device)
    t0 = torch.tensor(CENTROIDAL_T0, dtype=dtype, device=device)
    us = us0.permute(1, 2, 0).contiguous()
    xs, _ = ddp_mod._rollout_lanes(problem, cfg, t0, x0s.T.contiguous(), us)
    VxT, VxxT = (a.contiguous() for a in ddp_mod._terminal_quad_lanes(
        problem, cfg, t0, xs))
    D = StackedDerivs(*_stage_derivs_sweep(problem, cfg, t0, xs, us)[:7])
    if poison:
        D.Luu[:, :, :, 1] = -10.0
        D.Fx[N // 2, 0, 0, 2] = float("nan")
    return D, VxT, VxxT


def exact_sqrt(a):
    """A correctly rounded sqrt (numpy's), as the card's; torch's
    vectorized CPU sqrt is not."""
    return torch.from_numpy(np.sqrt(a.numpy()))


def plain_on_host(cfg, D, VxT, VxxT, lam):
    """``backward_stacked`` on the card host's CPU with a correctly rounded
    sqrt: there it sums in the kernel's order (lane by lane, left to right)
    where the batch fills its vector loops, as 256 lanes do, so a kernel
    built with -fmad=false gives its bits.  Any other batch is padded to a
    multiple of PLAIN_LANES lanes by repeating its last lane (on fewer
    lanes, or a ragged tail, torch's CPU reductions take another order)
    and cut back."""
    B = lam.shape[0]
    take = torch.arange(-(-B // PLAIN_LANES) * PLAIN_LANES).clamp(max=B - 1)
    pad = lambda a: a.cpu()[..., take].contiguous()
    saved, torch.sqrt = torch.sqrt, exact_sqrt
    try:
        out = backward_stacked(cfg, StackedDerivs(*map(pad, D)), pad(VxT),
                               pad(VxxT), pad(lam))
    finally:
        torch.sqrt = saved
    return tuple(a[..., :B].contiguous() for a in out)


def quu_condition(D, VxxT, lane=0):
    """The condition number of the last stage's Quu = Luu + Fu^T Vxx_T Fu
    of ``lane`` at fp64: the null space of the 16 ridge forces' 6-D
    wrench leaves only the 1e-6 input weight on 10 of its directions."""
    Fu = D.Fu[-1, :, :, lane].double()
    Quu = D.Luu[-1, :, :, lane].double() + Fu.T @ VxxT[:, :, lane].double() @ Fu
    return float(torch.linalg.cond(Quu))


@functools.lru_cache(maxsize=4)
def wide_k1_derivs(dtype, device, poison):
    """centroidal_derivs at the CENTROIDAL shape, made once (no caller
    writes to them)."""
    return centroidal_derivs(*CENTROIDAL, dtype, device, poison)


def wide_k1_case(B, dtype, device, reg_type, poison=True):
    """(cfg, D, VxT, VxxT, lam) of K1@9x16's check at B lanes: the first B
    lanes of centroidal_derivs' CENTROIDAL batch (with ``poison``, B = 37:
    lane 1 non-PD, lane 2 NaN; B = 1: lane 0 alone, clean either way)."""
    cut = lambda a: a[..., :B].contiguous()
    D, VxT, VxxT = wide_k1_derivs(dtype, device, poison)
    cfg = DDPConfig(horizon_steps=CENTROIDAL[1], reg_type=reg_type)
    lam = torch.full((B,), 1e-6 if reg_type == 1 else 0.5, dtype=dtype,
                     device=device)
    return cfg, StackedDerivs(*map(cut, D)), cut(VxT), cut(VxxT), lam


def hold_wide_k1(label, host, out, B, device, others_ok=True):
    """A (9, 16) kernel's ``out`` against the plain version on the card
    host's CPU (``host``): ok masks equal (B > 2: the non-PD and NaN lanes
    fail, and with ``others_ok`` no other; else every lane ok) and every ok
    lane's bytes equal; returns (ok lanes, bytes apart per output, max abs
    error)."""
    ok = host[3]
    check(torch.equal(ok.to(device), out[3]),
          f"{label}: kernel and plain ok masks differ")
    if B > 2:
        check(not bool(ok[1]) and not bool(ok[2])
              and (int(ok.sum()) == B - 2 or not others_ok),
              f"{label}: the non-PD and NaN lanes must fail, no other")
    else:
        check(bool(ok.all()), f"{label}: a clean lane failed")
    apart = [int((a[..., ok].contiguous().view(torch.uint8)
                  != b.cpu()[..., ok].contiguous().view(torch.uint8)).sum())
             for a, b in zip(host[:3], out[:3])]
    err = max(norm_err(a, b.cpu(), ok)[1] for a, b in zip(host[:3], out[:3]))
    check(apart == [0, 0, 0], f"{label}: the kernel parts from its plain "
          f"version ({apart} bytes apart)")
    return int(ok.sum()), apart, err


def wide_k2_k3(cfg, D, VxT, VxxT, lam):
    """K2@9x16 and K3@9x16 on one case, each wrapper's count checked:
    {key: (ks, Ks, dV, ok)}."""
    out = {}
    for key, call in (
            ("K2@9x16", lambda: backward_fused(cfg, D, VxT, VxxT, lam,
                                               dma="chunked")),
            ("K3@9x16", lambda: k1.backward_packed(
                cfg, k1.pack_derivs(D), *WIDE_K1, VxT, VxxT, lam))):
        k = KERNELS[key]
        before = getattr(k.wrapper, k.counter)
        out[key] = call()
        torch.cuda.synchronize()
        check(getattr(k.wrapper, k.counter) == before + 1,
              f"{key}: the wrapper did not count its launch")
    return out


def check_wide_k1(device, card):
    """K1@9x16 on centroidal sweep data (N=100, both reg_types, fp32 and
    fp64) at B=256 (a non-PD and a NaN lane), at its first 37 lanes (a
    ragged block, its fields copied to a lane stride TMA takes) and at
    lane 0 alone (B=1, run_mpc's batch): bit for bit equal to its plain
    version on the card host's CPU on every lane the plain version calls
    ok, the ok masks equal; at B=256 the normalized difference to the
    plain version on the card (whose reductions take another order)
    beside Quu's condition.  K2@9x16 and K3@9x16 on the same inputs: bit
    for bit equal to K1@9x16 on every ok lane with the same ok mask, and
    held to the same plain version (its host call timed once, at B=256
    fp32 reg_type 1: their plain time).  Then the times of the three
    beside their bound on the same data without the non-PD and NaN lanes
    (a NaN sends a division down its slow path) at B=256, fp32 (the
    record, with K1@9x16's plain version on the card) and fp64, and at
    B=1 (one lane on the card: the chain floor), with K3's pack timed
    apart."""
    N = CENTROIDAL[1]
    nx, nu = WIDE_K1
    start = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        for B in WIDE_K1_BATCHES:
            for reg_type in (1, 2):
                cfg, D, VxT, VxxT, lam = wide_k1_case(B, dtype, device,
                                                      reg_type)
                before = backward_fused.wide_launches
                out = backward_fused(cfg, D, VxT, VxxT, lam)
                torch.cuda.synchronize()
                check(backward_fused.wide_launches == before + 1,
                      "K1@9x16: the wrapper did not count its launch")
                host_s = time.perf_counter()
                host = plain_on_host(cfg, D, VxT, VxxT, lam)
                host_s = time.perf_counter() - host_s
                label = (f"K1@9x16 centroidal B={B} N={N} "
                         f"{str(dtype)[6:]} reg_type={reg_type}")
                n_ok, apart, err = hold_wide_k1(label, host, out, B,
                                                device)
                extra = ""
                if B == CENTROIDAL[0]:
                    ok = host[3].to(device)
                    gpu = backward_stacked(cfg, D, VxT, VxxT, lam)
                    errs = " ".join(
                        f"{name} {norm_err(a, b, ok)[0]:.3e}"
                        for name, a, b in zip(("ks", "Ks", "dV"), gpu[:3],
                                              out[:3]))
                    extra = (f"; normalized vs the plain version on the "
                             f"card {errs}; cond(Quu) of lane 0's last stage"
                             f" {quu_condition(D, VxxT):.3e}")
                print(f"[kernel] {label}: ok lanes {n_ok}/{B}, masks equal; "
                      f"bytes apart from the plain version on the host CPU "
                      f"(ks, Ks, dV) {apart}, max abs err {err:.3e}{extra}",
                      flush=True)
                KERNELS["K1@9x16"].max_abs_err = max(
                    KERNELS["K1@9x16"].max_abs_err, err)
                ok = host[3].to(device)
                for key, got in wide_k2_k3(cfg, D, VxT, VxxT, lam).items():
                    klabel = key + label[len("K1@9x16"):]
                    check(torch.equal(got[3], out[3]), f"{klabel}: ok mask "
                          f"differs from K1@9x16's")
                    vs_k1 = [int((a[..., ok].contiguous().view(torch.uint8)
                                  != b[..., ok].contiguous().view(
                                      torch.uint8)).sum())
                             for a, b in zip(out[:3], got[:3])]
                    check(vs_k1 == [0, 0, 0], f"{klabel}: parts from "
                          f"K1@9x16 ({vs_k1} bytes apart on the ok lanes)")
                    _, apart, err = hold_wide_k1(klabel, host, got, B,
                                                 device)
                    norm = max(norm_err(a, b.cpu(), host[3])[0]
                               for a, b in zip(host[:3], got[:3]))
                    print(f"[kernel] {klabel}: bit for bit with K1@9x16 on "
                          f"the ok lanes, masks equal; bytes apart from the "
                          f"plain version on the host CPU {apart}, "
                          f"normalized err {norm:.3e}", flush=True)
                    KERNELS[key].max_abs_err = max(KERNELS[key].max_abs_err,
                                                   norm)
                    if (dtype == torch.float32 and B == CENTROIDAL[0]
                            and reg_type == 1):
                        KERNELS[key].plain_ms = host_s * 1e3
    print(f"[phase] centroidal kernel checks (K1@9x16, K2@9x16, K3@9x16): "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        size = torch.empty((), dtype=dtype).element_size()
        for B in (CENTROIDAL[0], 1):
            cfg, D, VxT, VxxT, lam = wide_k1_case(B, dtype, device, 1,
                                                  poison=False)
            kernel = lambda: backward_fused(cfg, D, VxT, VxxT, lam)
            plain = lambda: backward_stacked(cfg, D, VxT, VxxT, lam)
            nbytes = moved_bytes("K1", B, N, size, nx=nx, nu=nu)
            ops = B * N * riccati_ops(nx, nu, 1, False)
            t_bound, by = bound(nbytes, ops, dtype)
            P = k1.pack_derivs(D)
            wide = {
                "K2@9x16": lambda: backward_fused(cfg, D, VxT, VxxT, lam,
                                                  dma="chunked"),
                "K3@9x16": lambda: k1.backward_packed(cfg, P, nx, nu, VxT,
                                                      VxxT, lam)}
            record = dtype == torch.float32 and B == CENTROIDAL[0]
            for key, call in wide.items():
                t_wide = cuda_ms(call, inner=10)
                print(f"[times] {key} {KERNELS[key].name} centroidal B={B} "
                      f"N={N} {str(dtype)[6:]}: kernel {t_wide:.4f} ms "
                      f"({t_wide * 1e3 / N:.3f} us a stage), bound "
                      f"{t_bound * 1e3:.2f} us ({by}) [{card}]", flush=True)
                if record:
                    k = KERNELS[key]
                    k.ms, k.bound_ms, k.bound_by = t_wide, t_bound, by
            t_pack = cuda_ms(lambda: k1.pack_derivs(D), inner=10)
            print(f"[times] K3@9x16 pack_derivs centroidal B={B} N={N} "
                  f"{str(dtype)[6:]}: {t_pack:.4f} ms [{card}]", flush=True)
            if record:
                record_time("K1@9x16", kernel, plain, nbytes, ops,
                            f"centroidal B={B} N={N}", True, card,
                            plain_reps=1)
                continue
            t_kern = cuda_ms(kernel, inner=10)
            floor = " (one lane: the chain floor)" if B == 1 else ""
            print(f"[times] K1@9x16 {KERNELS['K1@9x16'].name} centroidal "
                  f"B={B} N={N} {str(dtype)[6:]}{floor}: kernel "
                  f"{t_kern:.4f} ms ({t_kern * 1e3 / N:.3f} us a stage), "
                  f"bound {t_bound * 1e3:.2f} us ({by}) [{card}]",
                  flush=True)
    print(f"[phase] centroidal kernel times: "
          f"{time.perf_counter() - start:.1f} s", flush=True)


def centroidal_boxed_derivs(B, N, dtype, device):
    """K4@9x16's input: the boxed stage derivatives and bounds of a
    centroidal rollout with force limits CENTROIDAL_FORCE from
    CENTROIDAL_T0 (first-iteration data across the flight phase): (D,
    bounds, VxT, VxxT), lane 1 made non-PD and lane 2 NaN-poisoned as K4's
    own check does."""
    problem = centroidal_problem(boxed=True)
    cfg = DDPConfig(horizon_steps=N, with_input_constraint=True)
    x0s, us0, _ = centroidal_start(problem, B, N, dtype, device)
    t0 = torch.tensor(CENTROIDAL_T0, dtype=dtype, device=device)
    us = us0.permute(1, 2, 0).contiguous()
    xs, _ = ddp_mod._rollout_lanes(problem, cfg, t0, x0s.T.contiguous(), us)
    VxT, VxxT = (a.contiguous() for a in ddp_mod._terminal_quad_lanes(
        problem, cfg, t0, xs))
    fields = _stage_derivs_sweep(problem, cfg, t0, xs, us)
    D = StackedDerivs(*(a.contiguous() for a in fields[:7]))
    bnd = StackedBounds(*(a.contiguous() for a in fields[7:]))
    D.Luu[:, :, :, 1] = -10.0
    D.Fx[N // 2, 0, 0, 2] = float("nan")
    return D, bnd, VxT, VxxT


@functools.lru_cache(maxsize=2)
def wide_k4_derivs(dtype, device):
    """centroidal_boxed_derivs at the CENTROIDAL shape, made once (no
    caller writes to them)."""
    return centroidal_boxed_derivs(*CENTROIDAL, dtype, device)


def k4_case(fields, B, reg_type):
    """(cfg, D, bounds, VxT, VxxT, lam) of K4@9x16's check at B lanes: the
    first B lanes of ``fields`` (D, bounds, VxT, VxxT at CENTROIDAL[0]
    lanes; lane 1 non-PD and lane 2 NaN where B > 2)."""
    cut = lambda a: a[..., :B].contiguous()
    D, bnd, VxT, VxxT = fields
    cfg = DDPConfig(horizon_steps=D[0].shape[0], reg_type=reg_type,
                    with_input_constraint=True)
    lam = torch.full((B,), 1e-6 if reg_type == 1 else 0.5, dtype=VxT.dtype,
                     device=VxT.device)
    return (cfg, StackedDerivs(*map(cut, D)), StackedBounds(*map(cut, bnd)),
            cut(VxT), cut(VxxT), lam)


def wide_k4_case(B, dtype, device, reg_type):
    """k4_case on wide_k4_derivs' batch."""
    return k4_case(wide_k4_derivs(dtype, device), B, reg_type)


def boxed_plain_on_host(cfg, D, bnd, VxT, VxxT, lam):
    """``backward_stacked_boxed`` on the card host's CPU with a correctly
    rounded sqrt, on a batch of PLAIN_LANES lanes (plain_on_host: there it
    sums in the kernel's order): its (ks, Ks, dV, ok) and the QP's stats,
    each lane's as a narrower batch's first lanes would give them."""
    check(lam.shape[0] == PLAIN_LANES, "boxed_plain_on_host takes "
          f"{PLAIN_LANES} lanes")
    cpu = lambda a: a.cpu().contiguous()
    stats = {}
    saved, torch.sqrt = torch.sqrt, exact_sqrt
    try:
        out = backward_stacked_boxed(
            cfg, StackedDerivs(*map(cpu, D)), StackedBounds(*map(cpu, bnd)),
            cpu(VxT), cpu(VxxT), cpu(lam), stats=stats)
    finally:
        torch.sqrt = saved
    return out, stats


def free_bits(free):
    """The plain version's free sets [N, nu, B] as the kernel's bits [N,
    B] (bit a: input a free)."""
    weights = 2 ** torch.arange(free.shape[1], dtype=torch.int64)
    return (free.to(torch.int64) * weights[None, :, None]).sum(1).int()


class BoxedReferences:
    """K4@9x16's plain version on the card host's CPU (boxed_plain_on_host)
    at the CENTROIDAL shape, for each case of WIDE_K4_CASES, each in a
    process of its own (``--k4-reference DTYPE,REG_TYPE``, one torch
    thread): the plain BoxQP reads the host at every QP and Armijo trip,
    so at N=100 a call takes minutes, and the four run beside the phases
    before the centroidal one.  The ``k4-references`` phase starts them
    (check_wide_k4 does where that phase did not run) on wide_k4_derivs'
    batch, made on the card and written to REF_DIR with the results."""

    def __init__(self):
        self.procs = {}
        self.started = None

    @staticmethod
    def tag(dtype, reg_type):
        return f"{str(dtype)[6:]}_{reg_type}"

    def start(self, device):
        if self.procs:
            return
        REF_DIR.mkdir(parents=True, exist_ok=True)
        for dtype in sorted({d for d, _ in WIDE_K4_CASES}, key=str):
            D, bnd, VxT, VxxT = wide_k4_derivs(dtype, device)
            torch.save([[a.cpu() for a in D], [a.cpu() for a in bnd],
                        VxT.cpu(), VxxT.cpu()],
                       REF_DIR / f"in_{str(dtype)[6:]}.pt")
        self.started = time.perf_counter()
        for dtype, reg_type in WIDE_K4_CASES:
            tag = self.tag(dtype, reg_type)
            with open(REF_DIR / f"{tag}.log", "w") as log:
                self.procs[tag] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--k4-reference", f"{str(dtype)[6:]},{reg_type}"],
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        print(f"[k4-references] {len(self.procs)} processes on the card "
              f"host's CPU: K4@9x16's plain version at B={CENTROIDAL[0]} "
              f"N={CENTROIDAL[1]}, {', '.join(self.procs)}", flush=True)

    def result(self, dtype, reg_type):
        """One case's results once its process has ended: ``out`` (ks, Ks,
        dV, ok), the QP's ``stats``, the call's ``seconds`` and, at
        reg_type 1, ``seconds_b1``: the plain version on lane 0 alone."""
        tag = self.tag(dtype, reg_type)
        proc = self.procs[tag]
        left = REF_DEADLINE_S - (time.perf_counter() - self.started)
        try:
            proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            self.stop()
        log = (REF_DIR / f"{tag}.log").read_text()[-2000:]
        check(proc.returncode == 0, f"K4@9x16's plain reference {tag} "
              f"failed or did not end within {REF_DEADLINE_S:g} s: {log}")
        return torch.load(REF_DIR / f"out_{tag}.pt")

    def stop(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


BOXED_REFS = BoxedReferences()


def k4_reference(spec):
    """The body of a ``--k4-reference DTYPE,REG_TYPE`` process
    (BoxedReferences): boxed_plain_on_host on REF_DIR's input with one
    torch thread, its (ks, Ks, dV, ok), stats and seconds written back; at
    reg_type 1 also the seconds of the plain version on lane 0 alone
    (check_wide_k4's B=1 time)."""
    dname, reg_type = spec.split(",")
    torch.set_num_threads(1)
    fields = torch.load(REF_DIR / f"in_{dname}.pt")
    fields = (StackedDerivs(*fields[0]), StackedBounds(*fields[1]),
              *fields[2:])
    start = time.perf_counter()
    out, stats = boxed_plain_on_host(*k4_case(fields, CENTROIDAL[0],
                                              int(reg_type)))
    res = {"out": list(out), "stats": stats,
           "seconds": time.perf_counter() - start, "seconds_b1": None}
    if reg_type == "1":
        start = time.perf_counter()
        backward_stacked_boxed(*k4_case(fields, 1, 1))
        res["seconds_b1"] = time.perf_counter() - start
    torch.save(res, REF_DIR / f"out_{dname}_{reg_type}.pt")
    print(f"[k4-reference] {dname} reg_type={reg_type}: {res['seconds']:.2f}"
          f" s (B=1: {res['seconds_b1']})", flush=True)
    return 0


def check_wide_k4(device, card):
    """K4@9x16 on boxed centroidal sweep data at the solve's shape (B=256,
    N=100; both reg_types, fp32 and fp64, a non-PD and a NaN lane), held
    bit for bit to its plain version on the card host's CPU
    (BoxedReferences; check_boxed's rules at tolerance 0: ok masks equal,
    the non-PD and NaN lanes failing, every ok lane's bytes equal) at
    B=256, at its first 37 lanes (a ragged block, its fields copied to a
    lane stride TMA takes) and at lane 0 alone (B=1), and the kernel's QP
    iterations, free sets and Armijo candidates equal to that version's
    (the launch with stats, not counted).  Then, on the same data at
    reg_type 1, its time beside its bound (from the plain version's QP
    counts) and its plain version's on the card host's CPU (BoxedReferences'
    seconds) at B=256 (fp32: the record) and B=1 (one lane: the chain
    floor), fp32 and fp64."""
    BOXED_REFS.start(device)
    check_rn_ops(device)
    B, N = CENTROIDAL
    nx, nu = WIDE_K1
    key = "K4@9x16"
    refs = {}
    for dtype, reg_type in WIDE_K4_CASES:
        dname = str(dtype)[6:]
        fn = boxed.launcher(nx, nu, dtype)
        case = wide_k4_case(B, dtype, device, reg_type)
        label = (f"{key} centroidal boxed B={B} N={N} {dname} "
                 f"reg_type={reg_type}")
        before = boxed.backward_fused_boxed.wide_launches
        out = boxed.backward_fused_boxed(*case)
        torch.cuda.synchronize()
        check(boxed.backward_fused_boxed.wide_launches == before + 1,
              f"{key}: the wrapper did not count its launch")
        refs[(dtype, reg_type)] = res = BOXED_REFS.result(dtype, reg_type)
        host, stats, host_s = res["out"], res["stats"], res["seconds"]
        kstats = {}
        boxed.launch(fn, *case, stats=kstats)
        ok = host[3]
        plain_bits = free_bits(stats["free"])
        same_qp = all(torch.equal(kstats[k].cpu()[:, ok], v[:, ok])
                      for k, v in (("qp_iters", stats["qp_iters"]),
                                   ("free", plain_bits),
                                   ("ls_evals", stats["ls_evals"])))
        check(same_qp, f"{label}: the kernel's QP iterations, free sets "
              f"or Armijo candidates part from the plain version's")
        for Bc in WIDE_K1_BATCHES:
            o = out if Bc == B else boxed.backward_fused_boxed(
                *wide_k4_case(Bc, dtype, device, reg_type))
            torch.cuda.synchronize()
            ref = tuple(a[..., :Bc].contiguous() for a in host)
            n_ok, apart, err = hold_wide_k1(
                f"{key} centroidal boxed B={Bc} N={N} {dname} "
                f"reg_type={reg_type}", ref, o, Bc, device, others_ok=False)
            KERNELS[key].max_abs_err = max(KERNELS[key].max_abs_err, err)
            print(f"[kernel] {key} centroidal boxed B={Bc} N={N} {dname} "
                  f"reg_type={reg_type}: ok lanes {n_ok}/{Bc}, masks equal; "
                  f"bytes apart from the plain version on the host CPU (ks, "
                  f"Ks, dV) {apart}, max abs err {err:.3e}", flush=True)
        print(f"[kernel] {label}: QP iterations, free sets and Armijo "
              f"candidates equal to the plain version's on its ok lanes (a "
              f"lane and stage: QP iterations mean "
              f"{stats['qp_iters'].double().mean().item():.3f}, max "
              f"{int(stats['qp_iters'].max())}; Armijo candidates mean "
              f"{stats['ls_evals'].double().mean().item():.3f}, max "
              f"{int(stats['ls_evals'].max())}); the plain version "
              f"{host_s:.2f} s on the card host's CPU (one torch thread, "
              f"in a process of its own beside the earlier phases)",
              flush=True)
    for dtype in (torch.float32, torch.float64):
        size = torch.empty((), dtype=dtype).element_size()
        dname = str(dtype)[6:]
        res = refs[(dtype, 1)]
        stats = res["stats"]
        for Bt in (B, 1):
            floor = " (one lane: the chain floor)" if Bt == 1 else ""
            case = wide_k4_case(Bt, dtype, device, 1)
            t_kern = cuda_ms(lambda: boxed.backward_fused_boxed(*case),
                             reps=10, inner=2)
            lane_stats = {k: v[:, :Bt] for k, v in stats.items()}
            nbytes = moved_bytes("K4", Bt, N, size, nx=nx, nu=nu)
            ops = Bt * N * riccati_ops(nx, nu, 1, True) + qp_ops(nu,
                                                                 lane_stats)
            t_bound, by = bound(nbytes, ops, dtype)
            t_plain = 1e3 * res["seconds" if Bt == B else "seconds_b1"]
            label = f"centroidal boxed B={Bt} N={N}"
            print(f"[times] {key} {KERNELS[key].name} {label} {dname}{floor}"
                  f": kernel {t_kern:.4f} ms ({t_kern * 1e3 / N:.3f} us a "
                  f"stage; {nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M ops), "
                  f"plain {t_plain:.3f} ms (the card host's CPU), bound "
                  f"{t_bound * 1e3:.2f} us ({by}) [{card}]", flush=True)
            if dtype == torch.float32 and Bt == B:
                k = KERNELS[key]
                k.ms, k.plain_ms, k.bound_ms, k.bound_by = (
                    t_kern, t_plain, t_bound, by)
                print(qp_line(key, label, lane_stats), flush=True)


def boxed_centroidal_solves(device, card):
    """The boxed centroidal solve (force limits CENTROIDAL_FORCE): at
    N=CENTROIDAL_BOXED_N through ``auto`` (K4@9x16 and the plain
    rollouts) and an explicit ``backward_impl="pallas"``, each against the
    plain path (fp64: statuses and iterations equal, u within
    E2E_U_NORM_FP64; fp32: u and cost within the DDP limits or twice the
    plain path's own difference between the card and its host's CPU);
    then at the full width (B=256, N=100, 3 iterations,
    bench_all.py:95-121) through ``auto`` alone, fp32 and fp64, with its
    solves/s, host syncs, launches and statuses.  Every solve: masked u
    exactly 0, u[0] inside the box, every value finite, K4@9x16 launched
    and no other backward kernel."""
    problem = centroidal_problem(boxed=True)
    lo, hi = CENTROIDAL_FORCE
    key = "K4@9x16"
    others = REMAT_PATH + ("K1", "K2", "K3", "K4", "K5b", "K1@9x16")

    def hold(res, counts, masked, label):
        inside = bool(torch.all((res.us[:, 0] >= lo) & (res.us[:, 0] <= hi)))
        zero = bool(torch.all(res.us[:, masked] == 0))
        finite = bool(torch.isfinite(res.us).all()
                      and torch.isfinite(res.xs).all()
                      and torch.isfinite(res.costs).all())
        check(inside and zero and finite, f"centroidal boxed {label}: u[0] "
              f"left the box, a masked input moved or a value is not "
              f"finite")
        check(counts[key] > 0 and not any(counts[k] for k in others),
              f"centroidal boxed {label}: {key} did not run alone")
        return inside, zero, finite

    B, N = CENTROIDAL[0], CENTROIDAL_BOXED_N
    cfg = DDPConfig(horizon_steps=N, max_iter=CENTROIDAL_ITERS,
                    initial_lambda=1e-6, with_input_constraint=True)
    check(ddp_mod._resolve_backward_impl(cfg, problem, torch.float32, device,
                                         True, False) == "pallas",
          "centroidal boxed: auto does not take the sweep-fed kernel")
    for dtype in (torch.float64, torch.float32):
        x0s, us0, masked = centroidal_start(problem, B, N, dtype, device)
        start = time.perf_counter()
        auto, counts, syncs = solve_counted(problem, cfg, x0s, us0,
                                            t0=CENTROIDAL_T0)
        auto_s = time.perf_counter() - start
        explicit, ecounts, _ = solve_counted(
            problem, dataclasses.replace(cfg, backward_impl="pallas"), x0s,
            us0, t0=CENTROIDAL_T0)
        start = time.perf_counter()
        plain, plain_counts, plain_syncs = solve_counted(
            problem, dataclasses.replace(cfg, backward_impl="stacked"), x0s,
            us0, t0=CENTROIDAL_T0)
        plain_s = time.perf_counter() - start
        label = f"B={B} N={N} {str(dtype)[6:]}"
        hold(auto, counts, masked, f"auto {label}")
        hold(explicit, ecounts, masked, f"pallas {label}")
        check(not any(plain_counts.values()),
              "centroidal boxed: the plain path launched a kernel")
        check(all(torch.equal(getattr(auto, f), getattr(explicit, f))
                  for f in ("status", "iters", "us", "costs")),
              f"centroidal boxed {label}: auto and an explicit pallas part")
        st, it, du, dc = e2e_compare(plain, auto)
        flips = decision_flips(plain, auto, cfg.cost_update_thre)
        print(f"[centroidal] boxed solve_batch {label} max_iter="
              f"{cfg.max_iter} t0={CENTROIDAL_T0}: auto ({key}) "
              f"{auto_s:.2f} s (launches {counts}, host syncs {syncs}), "
              f"explicit pallas launches {ecounts[key]}, plain BoxQP "
              f"{plain_s:.2f} s ({plain_syncs} host syncs); statuses equal "
              f"{st}, iterations equal {it}, u normalized {du:.3e}, cost rel "
              f"{dc:.3e}; statuses "
              f"{torch.bincount(auto.status, minlength=5).tolist()}; lanes "
              f"apart {len(flips)}{': ' if flips else ''}"
              f"{'; '.join(flips[:4])} [{card}]", flush=True)
        if dtype == torch.float64:
            check(st and it and du <= E2E_U_NORM_FP64, "centroidal boxed "
                  "fp64: auto parts from the plain path")
            continue
        start = time.perf_counter()
        host = DDPSolver(problem, dataclasses.replace(
            cfg, backward_impl="stacked")).solve_batch(
                CENTROIDAL_T0, x0s.cpu(), us0.cpu())
        host_s = time.perf_counter() - start
        host_res = dataclasses.replace(host, **{
            f.name: getattr(host, f.name).to(device)
            for f in dataclasses.fields(host) if f.name != "trace"})
        _, _, fu, fc = e2e_compare(plain, host_res)
        floors = (max(E2E_U_NORM, 2 * fu), max(E2E_COST_REL, 2 * fc))
        print(f"[centroidal] boxed fp32 floor: the plain path on the card vs "
              f"on its host's CPU ({host_s:.2f} s): u normalized {fu:.3e}, "
              f"cost rel {fc:.3e}; auto held to u {floors[0]:.3e}, cost "
              f"{floors[1]:.3e}", flush=True)
        check(du <= floors[0] and dc <= floors[1],
              "centroidal boxed fp32: auto parts from the plain path past the "
              "plain path's own rounding floor")
    B, N = CENTROIDAL
    cfg = dataclasses.replace(cfg, horizon_steps=N)
    wrapper = ddp_mod.backward_fused_boxed

    def timed_wrapper(*args, **kw):   # CUDA events around each call
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        out = wrapper(*args, **kw)
        end.record()
        events.append((begin, end))
        return out

    for dtype in (torch.float32, torch.float64):
        x0s, us0, masked = centroidal_start(problem, B, N, dtype, device)
        events = []
        ddp_mod.backward_fused_boxed = timed_wrapper
        try:
            start = time.perf_counter()
            res, counts, syncs = solve_counted(problem, cfg, x0s, us0,
                                               t0=CENTROIDAL_T0)
            secs = time.perf_counter() - start
        finally:
            ddp_mod.backward_fused_boxed = wrapper
        torch.cuda.synchronize()
        k4_ms = sum(b.elapsed_time(e) for b, e in events)
        label = f"B={B} N={N} {str(dtype)[6:]}"
        inside, zero, finite = hold(res, counts, masked, f"auto {label}")
        print(f"[centroidal] boxed solve_batch {label} max_iter="
              f"{cfg.max_iter} t0={CENTROIDAL_T0} auto ({key}, plain "
              f"rollouts): {B / secs:.1f} solves/s ({secs:.2f} s), host "
              f"syncs {syncs}, launches {counts}; {key} {k4_ms:.2f} ms in "
              f"{len(events)} calls (CUDA events around each), "
              f"{100 * k4_ms / (1e3 * secs):.1f} % of the solve; u[0] "
              f"inside [{lo:g}, {hi:g}] {inside}, masked u exactly 0 {zero}, "
              f"finite {finite}, statuses "
              f"{torch.bincount(res.status, minlength=5).tolist()}, "
              f"iterations {torch.bincount(res.iters).tolist()} [{card}]",
              flush=True)
        if dtype == torch.float32:
            KERNELS[key].launches = counts[key]


def centroidal_dma_solves(problem, cfg, x0s, us0, stage, card):
    """The unboxed centroidal solve through ``backward_dma="chunked"`` and
    ``"packed"`` (K2@9x16, K3@9x16; the launch counters reset just before
    and read just after each): statuses, iterations, u and costs bit for
    bit equal to the "stage" solve ``stage`` (K1@9x16 through ``auto``),
    its kernel launched and K1@9x16 not; at fp32 its launches go to the
    record."""
    for dma in ("chunked", "packed"):
        key = f"{DMA_KERNEL[dma]}@9x16"
        start = time.perf_counter()
        res, counts, syncs = solve_counted(problem, cfg, x0s, us0,
                                           t0=CENTROIDAL_T0,
                                           backward_dma=dma)
        secs = time.perf_counter() - start
        equal = {f: torch.equal(getattr(stage, f), getattr(res, f))
                 for f in ("status", "iters", "us", "costs")}
        print(f"[centroidal] solve_batch backward_dma={dma!r} "
              f"{str(x0s.dtype)[6:]}: {secs:.2f} s (launches {counts}, "
              f"host syncs {syncs}); bit for bit with the stage solve "
              f"{equal} [{card}]", flush=True)
        check(all(equal.values()), f"centroidal {dma}: parts from the "
              f"stage solve ({equal})")
        check(counts[key] > 0 and not any(
            n for other, n in counts.items() if other != key),
            f"centroidal {dma}: did not run {key} alone")
        if x0s.dtype == torch.float32:
            KERNELS[key].launches = counts[key]


def phase_centroidal(device, card):
    """K1, K2 and K3 at (9, 16) against their plain version and timed;
    ``solve_batch`` of the unboxed centroidal model through ``auto``
    (K1@9x16 and the plain rollouts; the launch counters reset just before
    and read just after) and the plain path at fp64 and fp32, and through
    ``backward_dma="chunked"`` and ``"packed"`` (centroidal_dma_solves);
    then K4 at (9, 16) the same way (check_wide_k4) and the boxed solves
    (boxed_centroidal_solves)."""
    check_wide_k1(device, card)
    B, N = CENTROIDAL
    problem = centroidal_problem()
    cfg = DDPConfig(horizon_steps=N, max_iter=CENTROIDAL_ITERS,
                    initial_lambda=1e-6)
    check(ddp_mod._resolve_backward_impl(cfg, problem, torch.float32, device,
                                         False, False) == "pallas",
          "centroidal: auto does not take the sweep-fed kernel")
    for dtype in (torch.float64, torch.float32):
        x0s, us0, masked = centroidal_start(problem, B, N, dtype, device)
        start = time.perf_counter()
        auto, counts, syncs = solve_counted(problem, cfg, x0s, us0,
                                            t0=CENTROIDAL_T0)
        auto_s = time.perf_counter() - start
        start = time.perf_counter()
        plain, plain_counts, _ = solve_counted(
            problem, dataclasses.replace(cfg, backward_impl="stacked"), x0s,
            us0, t0=CENTROIDAL_T0)
        plain_s = time.perf_counter() - start
        st, it, du, dc = e2e_compare(plain, auto)
        zero = all(bool(torch.all(r.us[:, masked] == 0))
                   for r in (auto, plain))
        finite = bool(torch.isfinite(auto.us).all()
                      and torch.isfinite(auto.xs).all())
        flips = decision_flips(plain, auto, cfg.cost_update_thre)
        print(f"[centroidal] solve_batch B={B} N={N} max_iter={cfg.max_iter}"
              f" t0={CENTROIDAL_T0} {str(dtype)[6:]}: auto {auto_s:.2f} s "
              f"(launches {counts}, host syncs {syncs}), plain {plain_s:.2f}"
              f" s; statuses equal {st}, iterations equal {it}, u "
              f"normalized {du:.3e}, cost rel {dc:.3e}, masked u exactly 0 "
              f"{zero}, finite {finite}; "
              f"statuses {torch.bincount(auto.status, minlength=5).tolist()}"
              f"; lanes apart {len(flips)}{': ' if flips else ''}"
              f"{'; '.join(flips[:4])} [{card}]", flush=True)
        check(counts["K1@9x16"] > 0 and not any(
            n for key, n in counts.items() if key != "K1@9x16"),
            "centroidal: auto did not run K1@9x16 alone")
        check(not any(plain_counts.values()),
              "centroidal: the plain path launched a kernel")
        check(zero and finite, "centroidal: a masked input moved or a value "
              "is not finite")
        centroidal_dma_solves(problem, cfg, x0s, us0, auto, card)
        if dtype == torch.float64:
            check(st and it and du <= E2E_U_NORM_FP64, "centroidal fp64: "
                  "auto parts from the plain path")
            continue
        KERNELS["K1@9x16"].launches = counts["K1@9x16"]
        # fp32: Quu's condition (~2e6: 16 ridge forces make a 6-D wrench,
        # the other 10 directions weighted 1e-6) lets any change in the
        # order of a sum move u and the cost past the cart-pole's limits.
        # The plain path is held to itself across such a change (on the
        # card and on its host's CPU), and auto to the plain path within
        # the limits or twice that floor.
        start = time.perf_counter()
        host = DDPSolver(problem, dataclasses.replace(
            cfg, backward_impl="stacked")).solve_batch(
                CENTROIDAL_T0, x0s.cpu(), us0.cpu())
        host_s = time.perf_counter() - start
        host_res = dataclasses.replace(host, **{
            f.name: getattr(host, f.name).to(device)
            for f in dataclasses.fields(host) if f.name != "trace"})
        _, _, fu, fc = e2e_compare(plain, host_res)
        floors = (max(E2E_U_NORM, 2 * fu), max(E2E_COST_REL, 2 * fc))
        print(f"[centroidal] fp32 floor: the plain path on the card vs on "
              f"its host's CPU ({host_s:.2f} s): u normalized {fu:.3e}, "
              f"cost rel {fc:.3e}; auto held to u {floors[0]:.3e}, cost "
              f"{floors[1]:.3e}", flush=True)
        check(du <= floors[0] and dc <= floors[1],
              "centroidal fp32: auto parts from the plain path past the "
              "plain path's own rounding floor")
    check_wide_k4(device, card)
    boxed_centroidal_solves(device, card)


def phase_centroidal_driver(device, card, full):
    """The reference's centroidal driver through ``run_mpc`` (``auto``:
    K1@9x16), to CENTROIDAL_DRIVER_END with ``full``, else its first
    CENTROIDAL_DRIVER_STEPS steps: every step's planned position within
    1.0 of the reference, the forces below 1e-12 through the flight and,
    with ``full``, the final CoM within 1e-2 of the reference and the
    momenta below 1.0."""
    problem, N, dt = centroidal_problem(), 100, CENTROIDAL_DT
    cfg = DDPConfig(horizon_steps=N, max_iter=500)
    ref_pos = example_ref_pos_func()
    end_t = (CENTROIDAL_DRIVER_END if full
             else (CENTROIDAL_DRIVER_STEPS - 0.5) * dt)
    errs = []

    def record(t, x, u, res):
        ref = ref_pos(torch.tensor(t, dtype=torch.float64))
        errs.append(float(torch.linalg.norm(res.xs[0, :3].cpu() - ref)))

    x0 = torch.zeros(9, dtype=torch.float64, device=device)
    x0[2] = 1.0
    reset_counts()
    start = time.perf_counter()
    log = run_mpc(DDPSolver(problem, cfg), x0, t0=0.0, end_t=end_t,
                  callback=record)
    secs = time.perf_counter() - start
    counts = read_counts()
    flight = (log.ts > 1.41) & (log.ts < 1.59)
    f_max = float(np.abs(log.us[flight]).max()) if flight.any() else 0.0
    ref = ref_pos(torch.tensor(log.ts[-1] + dt, dtype=torch.float64)).numpy()
    com_err = float(np.linalg.norm(log.xs[-1][:3] - ref))
    momenta = float(np.linalg.norm(log.xs[-1][3:]))
    wall = log.solve_wall_ms
    print(f"[centroidal-driver] run_mpc centroidal N={N} fp64 auto, t=0.."
          f"{log.ts[-1]:.2f} ({len(log.ts)} solves, {secs:.1f} s): max "
          f"planned |pos - ref| {max(errs):.3e} (tol 1), flight steps "
          f"{int(flight.sum())} with max |u| {f_max:.3e} (tol 1e-12), final "
          f"|CoM - ref| {com_err:.3e}, |momenta| {momenta:.3e}, iterations "
          f"{int(log.solve_iters.min())}..{int(log.solve_iters.max())}, "
          f"statuses {sorted(set(log.solve_status.tolist()))}, solve wall "
          f"p50 {np.percentile(wall, 50):.2f} ms p99 "
          f"{np.percentile(wall, 99):.2f} ms; launches {counts} [{card}]",
          flush=True)
    check(counts["K1@9x16"] > 0, "centroidal driver: K1@9x16 did not run")
    check(max(errs) < 1.0 and f_max < 1e-12, "centroidal driver: a planned "
          "position left the reference or a flight force is not 0")
    if full:
        check(com_err < 1e-2 and momenta < 1.0, "centroidal driver: the "
              "final CoM or momenta miss the reference's assertions")


# --------------------------------------------------------------------------
# Second-order (full) DDP: the plain backward with the D2 term
# --------------------------------------------------------------------------

def phase_second_order(device, card):
    """Cart-pole ``solve_batch`` with ``use_state_eq_second_derivative``
    through ``auto`` (the plain backward; the fused rollouts on the card)
    on the card and on its host's CPU: statuses and iterations equal, u
    within 1e-8; the cost within SECOND_ORDER_COST_REL of the first-order
    solve's per lane where both succeed; an explicit kernel raises."""
    B, N = SECOND_ORDER
    problem = make_cartpole_problem(DT)
    cfg = DDPConfig(horizon_steps=N, max_iter=50,
                    use_state_eq_second_derivative=True)
    check(ddp_mod._resolve_backward_impl(cfg, problem, torch.float64, device,
                                         False, True) == "stacked",
          "second-order: auto does not take the plain backward")
    x0s, us0 = hanging_inputs(B, N, torch.float64, device)
    start = time.perf_counter()
    res, counts, syncs = solve_counted(problem, cfg, x0s, us0)
    card_s = time.perf_counter() - start
    start = time.perf_counter()
    host = DDPSolver(problem, cfg).solve_batch(0.0, x0s.cpu(), us0.cpu())
    host_s = time.perf_counter() - start
    first, _, _ = solve_counted(problem, dataclasses.replace(
        cfg, use_state_eq_second_derivative=False), x0s, us0)
    st = torch.equal(res.status.cpu(), host.status)
    it = torch.equal(res.iters.cpu(), host.iters)
    du = (res.us.cpu() - host.us).abs().max().item()
    both = (res.status == int(DDPStatus.SUCCEEDED)) & (
        first.status == int(DDPStatus.SUCCEEDED))
    c2, c1 = res.costs.sum(1), first.costs.sum(1)
    rel = ((c2 - c1).abs() / c1.abs())[both]
    worst = rel.max().item() if rel.numel() else 0.0
    raised = False
    try:
        DDPSolver(problem, dataclasses.replace(
            cfg, backward_impl="pallas")).solve_batch(0.0, x0s, us0)
    except NotImplementedError:
        raised = True
    print(f"[second-order] cart-pole solve_batch B={B} N={N} max_iter="
          f"{cfg.max_iter} fp64 auto: card {card_s:.2f} s (launches {counts},"
          f" host syncs {syncs}), host CPU {host_s:.2f} s; statuses equal "
          f"{st}, iterations equal {it}, max |du| {du:.3e} (tol 1e-8); "
          f"statuses {torch.bincount(res.status, minlength=5).tolist()}, "
          f"iterations {int(res.iters.min())}..{int(res.iters.max())}; cost "
          f"vs first order on {int(both.sum())} lanes both solved: max rel "
          f"{worst:.3e} (tol {SECOND_ORDER_COST_REL:g}), lanes past it "
          f"{int((rel > SECOND_ORDER_COST_REL).sum())}; backward_impl="
          f"'pallas' raises {raised} [{card}]", flush=True)
    check(not any(counts[key] for key in ("K1", "K1@9x16", "K2", "K3", "K5")),
          "second-order: a first-order backward kernel ran")
    check(st and it and du <= 1e-8, "second-order: the card parts from its "
          "host's CPU")
    check(worst <= SECOND_ORDER_COST_REL, "second-order: the cost parts from "
          "the first-order optimum")
    check(raised, "second-order: backward_impl='pallas' did not raise")


# --------------------------------------------------------------------------
# C/GMRES: the damper's golden steps, the fleets
# --------------------------------------------------------------------------

def damper_fleet(B, dtype, device, seed=0):
    """(x0s, states) of B damper controllers about x_initial (bench_all.py:
    217-223: 0.1 N(0, 1) from a seed), every one from the same setup."""
    solver = CgmresSolver(make_damper_problem(), device=device)
    state = solver.setup()
    rng = np.random.default_rng(seed)
    x0s = torch.as_tensor(np.tile([2.0, 0.0], (B, 1)) + 0.1 * rng.normal(
        size=(B, 2)), dtype=dtype, device=device)
    return x0s, CgmresState(*(a.to(dtype)[None].expand(B, *a.shape)
                              .contiguous() for a in state))


def cgmres_golden(device):
    """The analytic damper's first CGMRES_GOLDEN_STEPS control steps (RK4
    plant, fp64) on the card against tests/golden/cgmres_numpy.py: setup
    within 1e-8, u within 1e-7 at every step."""
    config = CgmresConfig(sim_ode_solver="rk4")
    solver = CgmresSolver(make_damper_problem(analytic=True), config,
                          device=device)
    gp = DamperGolden()
    golden = GoldenCgmres(gp)
    state = solver.setup()
    d_setup = float(np.abs(state.u.cpu().numpy() - golden.setup(
        0.0, gp.x_initial.copy(), gp.u_initial.copy())).max())
    xg, t, d_step = gp.x_initial.copy(), 0.0, 0.0
    f = lambda tt, xx, u: gp.state_eq(tt, xx, u[:2])
    start = time.perf_counter()
    for _ in range(CGMRES_GOLDEN_STEPS):
        next_xg = INTEGRATORS["rk4"](f, t, xg, state.u.cpu().numpy(),
                                     config.dt)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                         device=device)
        state = solver.control_step(t, as_t(xg), as_t(next_xg), state)
        ug, _ = golden.control_step(t, xg, next_xg)
        d_step = max(d_step, float(np.abs(state.u.cpu().numpy() - ug).max()))
        xg, t = next_xg, t + config.dt
    return d_setup, d_step, (time.perf_counter() - start) / CGMRES_GOLDEN_STEPS


def chained_steps(solver, x0s, states, n):
    """``n`` fleet control steps, one ``control_step_batch`` call each,
    with ``simulate_batch``'s RK4 plant between them; returns each step's
    (t, x, next_x, states in, states out, GMRES iterations per lane)."""
    problem, cfg = solver.problem, solver.config
    f = stages_lanes(lambda t, x, u: problem.state_eq(t, x, u[:problem.dim_u]),
                     2)
    out, x, t = [], x0s, 0.0
    for _ in range(n):
        next_x = INTEGRATORS[cfg.sim_ode_solver](
            f, torch.tensor(t, dtype=x.dtype, device=x.device), x.T,
            states.u.T, cfg.dt).T
        new = solver.control_step_batch(t, x, next_x, states)
        out.append((t, x, next_x, states, new, solver.gmres_iters))
        x, t, states = next_x, t + cfg.dt, new
    return out


def phase_cgmres(device, card, layers):
    """C/GMRES on the card: the golden's steps; the damper fleet (fp32,
    ``simulate_batch``) timed with CUDA events, with launches per step and
    the device's busy share under ``layers``; the fp64 fleet on the card
    and on its host's CPU; the bounded cart-pole fleet inside its force
    bound."""
    d_setup, d_step, step_s = cgmres_golden(device)
    print(f"[cgmres] damper (analytic, RK4 plant) fp64 vs the NumPy golden: "
          f"setup max |du| {d_setup:.3e} (tol 1e-8), {CGMRES_GOLDEN_STEPS} "
          f"steps max |du| {d_step:.3e} (tol 1e-7); {step_s * 1e3:.1f} ms a "
          f"control_step (eager) [{card}]", flush=True)
    check(d_setup <= 1e-8 and d_step <= 1e-7, "cgmres: the damper parts "
          "from the golden")

    B, n_steps = CGMRES_FLEET
    solver = CgmresSolver(make_damper_problem(), device=device)
    x0s, states = damper_fleet(B, torch.float32, device)
    sim = lambda n=n_steps: solver.simulate_batch(0.0, x0s, states, n)
    torch.cuda.synchronize()
    begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    begin.record()
    ts, xs, us, errs = sim()
    end.record()
    end.synchronize()
    secs = begin.elapsed_time(end) / 1e3
    # the graph's steps against the same steps run eagerly, one
    # control_step_batch call each
    eager = chained_steps(solver, x0s, states, CGMRES_EAGER_STEPS)
    same = all(torch.equal(us[:, i], step[4].u)
               and torch.equal(errs[:, i], step[4].err)
               for i, step in enumerate(eager))
    lost = ~(torch.isfinite(xs).all(-1) & torch.isfinite(us).all(-1))
    first = int(lost.any(0).nonzero()[0]) if bool(lost.any()) else None
    extra = ""
    if layers:
        from torch.profiler import ProfilerActivity, profile
        n_prof = 2
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim(n_prof)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time_total for e in kernels) / 1e3
        per_step = secs / n_steps * 1e3
        extra = (f"; profiled {n_prof} steps (capture included): "
                 f"{len(kernels) / n_prof:.0f} device kernels a step, busy "
                 f"{busy / n_prof:.2f} ms a step of {per_step:.2f} ms "
                 f"({100 * busy / n_prof / per_step:.1f} %)")
    print(f"[cgmres] damper fleet simulate_batch B={B} {n_steps} steps fp32 "
          f"(one CUDA graph replayed a step): {secs:.2f} s, "
          f"{B * n_steps / secs:.1f} ctrl-steps/s, host syncs "
          f"{solver.host_syncs / n_steps:g} a step; the first "
          f"{CGMRES_EAGER_STEPS} steps equal the eager steps bit for bit "
          f"{same}; lanes leaving the finite range {int(lost.any(1).sum())}"
          f" of {B} (from step {first}; JAX's fp32 fleet on the CPU: 23, "
          f"from step 16){extra} [{card}]", flush=True)
    check(same, "cgmres: the graph's steps part from the eager steps")
    check(solver.host_syncs == 0, "cgmres: a fleet step read the host")

    # fp64: each of the card's chained steps again on its host's CPU from
    # the card's inputs (the chains themselves drift apart: each step's
    # finite-difference quotients scale rounding by 1 / dlt = 500)
    x0s, states = damper_fleet(B, torch.float64, device)
    host_solver = CgmresSolver(make_damper_problem(), device="cpu")
    cpu = lambda st: CgmresState(*(a.cpu() for a in st))
    worst = {name: 0.0 for name in ("u_list", "delta_u_vec", "err")}
    iters_equal = True
    steps = chained_steps(solver, x0s, states, CGMRES_FP64_STEPS)
    for t, x, next_x, st_in, st_out, iters in steps:
        host = host_solver.control_step_batch(t, x.cpu(), next_x.cpu(),
                                              cpu(st_in))
        for name in worst:
            worst[name] = max(worst[name], norm_err(
                getattr(host, name), getattr(st_out, name).cpu())[0])
        iters_equal &= torch.equal(iters.cpu(), host_solver.gmres_iters)
    print(f"[cgmres] damper fleet B={B} {CGMRES_FP64_STEPS} chained steps "
          f"fp64, each step on the card vs on its host's CPU from the same "
          f"inputs: normalized "
          f"{' '.join(f'{k} {v:.3e}' for k, v in worst.items())} (tol "
          f"{CGMRES_TOL:g}), GMRES iterations per lane equal {iters_equal} "
          f"({int(steps[-1][5].min())}..{int(steps[-1][5].max())})",
          flush=True)
    check(max(worst.values()) <= CGMRES_TOL and iters_equal,
          "cgmres: the fp64 fleet on the card parts from its host's CPU")

    problem = make_cartpole_cgmres_problem(with_input_bound=True)
    solver = CgmresSolver(problem, device=device)
    state = solver.setup()
    rng = np.random.default_rng(1)
    x0s = torch.as_tensor(np.tile([0.0, np.pi, 0.0, 0.0], (B, 1))
                          + 0.05 * rng.normal(size=(B, 4)),
                          dtype=torch.float32, device=device)
    states = CgmresState(*(a.float()[None].expand(B, *a.shape).contiguous()
                           for a in state))
    torch.cuda.synchronize()
    start = time.perf_counter()
    ts, xs, us, errs = solver.simulate_batch(0.0, x0s, states, n_steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    finite = bool(torch.isfinite(xs).all() and torch.isfinite(errs).all()
                  and torch.isfinite(us).all())
    f_abs = float(us[..., 0].abs().max())
    print(f"[cgmres] bounded cart-pole fleet simulate_batch B={B} {n_steps} "
          f"steps fp32: {secs:.2f} s, {B * n_steps / secs:.1f} ctrl-steps/s,"
          f" finite {finite}, max |f| {f_abs:.4f} (f_max {F_MAX:g} + 1e-3) "
          f"[{card}]", flush=True)
    check(finite and f_abs <= F_MAX + 1e-3, "cgmres: the bounded cart-pole "
          "fleet left the finite range or its force bound")


# --------------------------------------------------------------------------
# The last modules: parallel-in-time and horizon-sharded Riccati, the
# mesh, the native runtime, ls_mode="serial", the profiled solves and the
# examples
# --------------------------------------------------------------------------

def lqr_stage(dtype, device, N=LQR[0], nx=LQR[1], nu=LQR[2]):
    """bench_all.py:277-301's long-horizon LQR (N=2048, nx=8, nu=2, seed
    0): (stage, S_T)."""
    rng = np.random.default_rng(0)
    A = 0.3 * rng.normal(size=(N, nx, nx)) + np.eye(nx)
    B = 0.3 * rng.normal(size=(N, nx, nu))
    W = 0.3 * rng.normal(size=(N, nx, nx))
    Qxx = W @ W.transpose(0, 2, 1) + 0.5 * np.eye(nx)
    Quu = np.tile(np.eye(nu), (N, 1, 1))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return (LQRStage(t(A), t(B), z(N, nx), t(Qxx), t(Quu), z(N, nu, nx),
                     z(N, nx), z(N, nu)),
            torch.eye(nx, dtype=dtype, device=device))


def gain_err(got, ref):
    """Largest normalized difference of (Ks, ks) against (Ks, ks)."""
    return max(norm_err(r, g)[0] for g, r in zip(got[:2], ref[:2]))


def phase_horizon(device, card):
    """``solve_lqr_parallel`` against ``solve_lqr_sequential`` at N=2048
    (nx=8, nu=2), fp32 and fp64, on the card and on its host's CPU, both
    timed (CUDA events on the card, the host clock on the CPU), and the
    four-block path of the horizon-sharded solve in one process
    (``solve_lqr_horizon_blocks``) against the sequential recursion."""
    for dtype in (torch.float32, torch.float64):
        tol = KERNEL_TOL[dtype]
        stage, S_T = lqr_stage(dtype, device)
        par = solve_lqr_parallel(stage, S_T)
        seq = solve_lqr_sequential(stage, S_T)
        blk = solve_lqr_horizon_blocks(stage, S_T, blocks=4)
        e_par, e_blk = gain_err(par, seq), gain_err(blk, seq)
        par_ms = cuda_ms(lambda: solve_lqr_parallel(stage, S_T), reps=5)
        seq_ms = cuda_ms(lambda: solve_lqr_sequential(stage, S_T), reps=3,
                         warmup=1)
        blk_ms = cuda_ms(lambda: solve_lqr_horizon_blocks(stage, S_T,
                                                          blocks=4), reps=5)
        hstage, hS_T = lqr_stage(dtype, "cpu")
        start = time.perf_counter()
        hpar = solve_lqr_parallel(hstage, hS_T)
        hpar_s = time.perf_counter() - start
        start = time.perf_counter()
        hseq = solve_lqr_sequential(hstage, hS_T)
        hseq_s = time.perf_counter() - start
        e_host = gain_err(hpar, hseq)
        e_card_host = gain_err(tuple(a.cpu() for a in par), hpar)
        finite = all(bool(torch.isfinite(a).all()) for a in par + blk)
        print(f"[horizon] LQR N={LQR[0]} nx={LQR[1]} nu={LQR[2]} "
              f"{str(dtype)[6:]}: card parallel vs sequential {e_par:.3e}, "
              f"four blocks vs sequential {e_blk:.3e}, host CPU parallel vs "
              f"sequential {e_host:.3e}, card vs host CPU parallel "
              f"{e_card_host:.3e} (tol {tol:g}, normalized); card parallel "
              f"{par_ms:.2f} ms, sequential {seq_ms:.2f} ms, four blocks "
              f"{blk_ms:.2f} ms (CUDA events); host CPU parallel "
              f"{hpar_s * 1e3:.2f} ms, sequential {hseq_s * 1e3:.2f} ms "
              f"[{card}]", flush=True)
        check(finite, "horizon: non-finite gains")
        check(max(e_par, e_blk, e_host) <= tol,
              f"horizon {dtype}: a parallel solve parts from the recursion")


def phase_mesh(device, card):
    """A one-rank NCCL group on the card (one process a card, and this
    machine has one card, so the world size is 1): ``make_sharded_solve``
    at the headline shape (fp32, 10 iterations: K5, K6, K7) bit for bit
    against ``solve_batch``; ``convergence_stats`` through NCCL's
    all_reduce against the batch's own counts; ``solve_lqr_horizon_
    sharded`` at sp=1 against ``solve_lqr_parallel``."""
    import torch.distributed as dist
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(device)
    initialize_multihost(f"localhost:{port}", 1, 0, device_type="cuda")
    try:
        mesh = make_mesh(dp=1, sp=1, device_type="cuda")
        check(dist.get_backend() == "nccl", "mesh: the group is not NCCL")
        B, N = HEADLINE
        problem = make_cartpole_problem(DT)
        solver = DDPSolver(problem, DDPConfig(horizon_steps=N, max_iter=10))
        x0s, us0 = hanging_inputs(B, N, torch.float32, device)
        local = solver.solve_batch(0.0, x0s, us0)
        shard = shard_batch(mesh, (x0s, us0))
        reset_counts()
        start = time.perf_counter()
        res = make_sharded_solve(solver, mesh)(0.0, *shard)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        counts = read_counts()
        same = (torch.equal(res.us, local.us)
                and torch.equal(res.status, local.status)
                and torch.equal(res.iters, local.iters))
        stats = convergence_stats(mesh, res)
        want = (B, float((local.status == 1).double().mean()),
                float(local.iters.double().mean()))
        got = tuple(float(stats[k]) for k in ("n", "success_rate",
                                              "mean_iters"))
        stage, S_T = lqr_stage(torch.float64, device)
        hs = solve_lqr_horizon_sharded(stage, S_T, mesh=mesh)
        e_hs = gain_err(hs, solve_lqr_parallel(stage, S_T))
        print(f"[mesh] NCCL world size 1 (one process a card, one card), "
              f"mesh (dp, sp) = (1, 1): sharded solve_batch B={B} N={N} "
              f"max_iter=10 fp32 {secs:.3f} s, launches {counts}, bit for "
              f"bit vs solve_batch {same}; convergence_stats (n, success, "
              f"mean iters) {got} vs local {want}; horizon-sharded LQR "
              f"N={LQR[0]} fp64 at sp=1 vs solve_lqr_parallel {e_hs:.3e} "
              f"(tol {KERNEL_TOL[torch.float64]:g}) [{card}]", flush=True)
        check(same, "mesh: the sharded solve parts from solve_batch")
        check(all(counts[k] > 0 for k in REMAT_PATH),
              "mesh: the sharded solve skipped a kernel of the fused path")
        check(got[0] == want[0] and abs(got[1] - want[1]) < 1e-12
              and abs(got[2] - want[2]) < 1e-12,
              "mesh: convergence_stats parts from the batch's counts")
        check(e_hs <= KERNEL_TOL[torch.float64],
              "mesh: the horizon-sharded LQR parts from the parallel one")
    finally:
        dist.destroy_process_group()


def swingup_executor(realtime, duration, mpc_dt, device):
    """test_runtime.py's executor run: the cart-pole plant at 2 ms, a
    DDP solve (N=100, max_iter=3, fp64) on the card every ``mpc_dt``."""
    solver = DDPSolver(make_cartpole_problem(DT, param=CartPoleParam()),
                       DDPConfig(horizon_steps=100, max_iter=3))
    fn = WarmStartedSolve(solver, device=device)
    if realtime:
        fn(0.0, np.array([0.0, np.pi, 0.0, 0.0]))   # build outside the loop
        fn.reset()
    ex = MpcExecutor(nx=4, nu=1, sim_dt=RUNTIME_SIM_DT, mpc_dt=mpc_dt)
    ex.set_cartpole_plant(x0=[0.0, np.pi, 0.0, 0.0], m1=1.0, m2=0.5, l=2.0)
    if not realtime:
        ex.set_input_limits(-100.0, 100.0)
    reset_counts()
    start = time.perf_counter()
    log, stats = ex.run(fn, duration=duration, realtime=realtime)
    return ex, log, stats, time.perf_counter() - start, read_counts()


def phase_runtime(device, card):
    """The native executor with the solver on the card:
    test_runtime.py:39-54's virtual-time swing-up to RUNTIME_END (a solve
    every 4 ms; the pole upright, p99 > 0), then 1 s of real-time mode
    (solves every 50 ms on the executor's thread): solve p50 / p99 and
    deadline misses."""
    ex, log, stats, secs, counts = swingup_executor(
        False, RUNTIME_END, RUNTIME_MPC_DT, device)
    solves = round(RUNTIME_END / RUNTIME_MPC_DT)
    x = ex.state()
    theta_err = abs(((x[1] + np.pi) % (2 * np.pi)) - np.pi)
    print(f"[runtime] virtual time {RUNTIME_END:g} s, cart-pole N=100 "
          f"max_iter=3 fp64 on the card: {stats.n_solves} solves in "
          f"{secs:.1f} s, final theta error {theta_err:.3e} (tol 0.2), "
          f"omega {x[3]:+.3e} (tol 0.5), log rows {log.ts.shape[0]}; solve "
          f"p50 {stats.p50_ms:.2f} ms, p99 {stats.p99_ms:.2f} ms, max "
          f"{stats.max_ms:.2f} ms, deadline misses {stats.deadline_misses}; "
          f"launches {counts} [{card}]", flush=True)
    check(abs(stats.n_solves - solves) <= solves // 100 and theta_err < 0.2
          and abs(x[3]) < 0.5
          and log.ts.shape[0] == round(RUNTIME_END / RUNTIME_SIM_DT)
          and np.all(np.isfinite(log.xs)) and stats.p99_ms > 0,
          "runtime: the virtual-time swing-up misses test_runtime.py's "
          "assertions")
    check(all(counts[k] > 0 for k in ("K5", "K6")),
          "runtime: the solves did not run K5 and K6")
    ex, log, stats, secs, counts = swingup_executor(True, 1.0, 0.05, device)
    print(f"[runtime] real time 1 s, mpc_dt 50 ms: {stats.n_solves} solves, "
          f"solve p50 {stats.p50_ms:.2f} ms, p99 {stats.p99_ms:.2f} ms, max "
          f"{stats.max_ms:.2f} ms, deadline misses {stats.deadline_misses}, "
          f"log rows {log.ts.shape[0]}; launches {counts} [{card}]",
          flush=True)
    check(stats.n_solves >= 3 and log.ts.shape[0] > 100
          and np.all(np.isfinite(log.xs)), "runtime: the real-time run "
          "misses test_runtime.py's assertions")


def phase_serial(device, card):
    """``ls_mode="serial"`` at the headline shape (fp32, fp64) against
    ``sweep``: statuses, iterations and u, whether bit for bit; the
    alpha trips and host syncs of a solve, K6's launches, each mode's
    time after an untimed warm-up solve.  Serial decides on K6's cost
    sums, sweep on K7's."""
    B, N = HEADLINE
    problem = make_cartpole_problem(DT)
    for dtype in (torch.float32, torch.float64):
        x0s, us0 = hanging_inputs(B, N, dtype, device)
        out = {}
        for mode in ("sweep", "serial"):
            cfg = DDPConfig(horizon_steps=N, max_iter=10, ls_mode=mode)
            solver = DDPSolver(problem, cfg)
            solver.solve_batch(0.0, x0s, us0)     # warm-up, untimed
            torch.cuda.synchronize()
            reset_counts()
            start = time.perf_counter()
            res = solver.solve_batch(0.0, x0s, us0)
            torch.cuda.synchronize()
            out[mode] = (res, time.perf_counter() - start, read_counts(),
                         solver.host_syncs, solver.ls_trips)
        (sw, sw_s, sw_c, sw_h, _), (se, se_s, se_c, se_h, trips) = (
            out["sweep"], out["serial"])
        st, it, du, dc = e2e_compare(se, sw)
        bits = torch.equal(se.us, sw.us) and st and it
        flips = decision_flips(se, sw, cfg.cost_update_thre)
        print(f"[serial] solve_batch B={B} N={N} max_iter=10 "
              f"{str(dtype)[6:]}: serial vs sweep status equal {st}, iters "
              f"equal {it}, u bit for bit {bits}, u norm diff {du:.3e}, cost "
              f"rel diff {dc:.3e}; lanes that differ: "
              f"{'; '.join(flips) or 'none'}; serial {se_s:.3f} s, alpha "
              f"trips a iteration {trips} ({sum(trips)} a solve), host syncs "
              f"{se_h} (sweep {sw_h}), launches {se_c}; sweep {sw_s:.3f} s, "
              f"launches {sw_c} [{card}]", flush=True)
        check(se_c["K6"] == sum(trips) and se_c["K7"] == 0,
              "serial: K6 did not launch once a trip, or K7 ran")
        check(se_h - sw_h == sum(t + 1 for t in trips),
              "serial: host syncs are not one a trip and one to end a loop")
        check(du <= E2E_U_NORM and dc <= E2E_COST_REL,
              "serial: u or cost out of the contract vs sweep")
        if dtype == torch.float64:
            check(st and it, "serial fp64: status or iterations part")


def phase_profiled(device, card):
    """``profiled_solve_ddp`` (cart-pole N=100, fp64, 20 iterations at
    most) and ``profiled_solve_fmpc`` (oscillator N=50, 5 iterations,
    fp64): results bit for bit equal to the untimed solves, the per-phase
    CUDA-event ms, and ``estimate_backward_split``."""
    N = 100
    solver = DDPSolver(make_cartpole_problem(DT),
                       DDPConfig(horizon_steps=N, max_iter=20))
    x0 = torch.tensor([0.0, math.pi, 0.0, 0.0], dtype=torch.float64,
                      device=device)
    us0 = torch.zeros((N, 1), dtype=torch.float64, device=device)
    plain = solver.solve(0.0, x0, us0)
    prof, dur, cd = profiled_solve_ddp(solver, 0.0, x0, us0)
    split = estimate_backward_split(solver, 0.0, x0, us0)
    same = all(torch.equal(getattr(plain, f), getattr(prof, f))
               for f in ("status", "iters", "xs", "us", "Ks", "lam"))
    n = int(prof.iters)
    rows = {k: [round(float(v), 3) for v in dur[k][1:n + 1]] for k in dur}
    print(f"[profiled] DDP cart-pole N={N} fp64: {n} iterations, equal to "
          f"the untimed solve {same}; phase ms a iteration (CUDA events) "
          f"{rows}; solve {cd.solve:.2f} ms, setup {cd.setup:.2f} ms, opt "
          f"{cd.opt:.2f} ms; backward split Q / reg / gain "
          f"{split['Q']:.4f} / {split['reg']:.4f} / {split['gain']:.4f} ms "
          f"[{card}]", flush=True)
    check(same, "profiled DDP parts from the untimed solve")
    check(all(min(dur[k][1:n]) > 0 for k in dur) and cd.opt <= cd.solve,
          "profiled DDP: a phase column is not above 0")
    fsolver = FmpcSolver(make_oscillator_problem(DT),
                         FmpcConfig(horizon_steps=50, max_iter=5))
    var = fmpc_variable_reset(50, 2, 1, 3, dtype=torch.float64,
                              device=device)
    x0 = torch.tensor([0.0, 1.0], dtype=torch.float64, device=device)
    reset_counts()
    fplain = fsolver.solve(0.0, x0, var)
    counts = read_counts()
    fprof, fdur = profiled_solve_fmpc(fsolver, 0.0, x0, var)
    fsame = (torch.equal(fplain.status, fprof.status)
             and torch.equal(fplain.iters, fprof.iters)
             and all(torch.equal(getattr(fplain.variable, f),
                                 getattr(fprof.variable, f))
                     for f in VARIABLE))
    n = int(fprof.iters)
    rows = {k: [round(float(v), 3) for v in fdur[k][1:n + 1]] for k in fdur}
    print(f"[profiled] FMPC oscillator N=50 fp64: {n} iterations, equal to "
          f"the untimed solve {fsame}; phase ms a iteration (CUDA events) "
          f"{rows}; launches of the untimed solve {counts} [{card}]",
          flush=True)
    check(fsame, "profiled FMPC parts from the untimed solve")
    check(all(counts[k] > 0 for k in FMPC_PATH),
          "profiled FMPC: the solve did not run K8 and K11")
    check(fdur["coeff"][1] > 0 and min(fdur["backward"][1:n]) > 0,
          "profiled FMPC: a phase column is not above 0")


def phase_swingup_example(device, card, out_dir):
    """The swingup example through its entry point on the card at its
    defaults: the single solve and the closed loop's final pole angle."""
    os.makedirs(out_dir, exist_ok=True)
    start = time.perf_counter()
    res, log = ex_swingup.main(device=device, trace_path=os.path.join(
        out_dir, "swingup_trace.txt"))
    secs = time.perf_counter() - start
    theta = abs(((log.xs[-1][1] + np.pi) % (2 * np.pi)) - np.pi)
    over = np.abs(log.us[:, 0]) > 15.0
    # A solve that accepts no full step returns an input whose first stage
    # is its warm start's, which the forward pass's unclipped feedback may
    # have left outside the box (the JAX example's loop does so too).
    print(f"[examples] swingup: {secs:.1f} s; single solve "
          f"{DDPStatus(int(res.status)).name}, closed loop's final |theta| "
          f"{theta:.3e} (tol 0.2); applied |u| above the 15 N limit at "
          f"{int(over.sum())} of {len(over)} steps, at most "
          f"{float(np.abs(log.us).max())!r} N, iterations there "
          f"{log.solve_iters[over].tolist()}, statuses "
          f"{log.solve_status[over].tolist()} [{card}]", flush=True)
    check(bool(torch.isfinite(res.us).all()) and np.all(np.isfinite(log.xs))
          and theta < 0.2,
          "examples: the swing-up went non-finite or did not end upright")


def phase_examples(device, card, out_dir):
    """The other three examples through their entry points on the card:
    constrained and fleet at their defaults (what each prints: the
    constraint's worst value, the fleet's upright share), centroidal_jump's
    first CENTROIDAL_JUMP_STEPS steps with --profile (each step's planned
    position within 1.0 of the reference, TestDDPCentroidalMotion.cpp:
    318)."""
    os.makedirs(out_dir, exist_ok=True)
    start = time.perf_counter()
    xf, worst_g = ex_constrained.main(device=device)
    secs = time.perf_counter() - start
    print(f"[examples] constrained: {secs:.1f} s; final x {xf.tolist()}, "
          f"worst g {worst_g!r} (tol 0) [{card}]", flush=True)
    check(worst_g <= 0 and np.all(np.isfinite(xf)),
          "examples: the constrained loop left the feasible set")
    start = time.perf_counter()
    flog, wall = ex_fleet.main(device=device)
    secs = time.perf_counter() - start
    print(f"[examples] fleet: {secs:.1f} s ({wall:.2f} s timed) [{card}]",
          flush=True)
    check(bool(torch.isfinite(flog.xs).all()), "examples: the fleet went "
          "non-finite")
    start = time.perf_counter()
    rows, errs, _ = ex_centroidal.run(
        device=device, profile=True, max_steps=CENTROIDAL_JUMP_STEPS,
        out_path=os.path.join(out_dir, "centroidal_result.txt"),
        trace_path=os.path.join(out_dir, "centroidal_trace.txt"))
    secs = time.perf_counter() - start
    print(f"[examples] centroidal_jump --profile, first {len(rows)} steps: "
          f"max planned |pos - ref| {max(errs):.3e} (tol 1), iterations "
          f"{[r[16] for r in rows]}, {secs:.1f} s [{card}]", flush=True)
    check(len(rows) == CENTROIDAL_JUMP_STEPS and max(errs) < 1.0,
          "examples: the centroidal jump's planned position left the "
          "reference")


class PhaseChildren:
    """Phases run in processes of their own (``--phases NAME``), each a
    host-bound loop of small solves that takes minutes (B = 1): the
    swingup example, started right after the build (``examples-start``:
    beside the phases that hold the kernels and the solves, on the card
    it hardly uses), and the runtime phase, started beside the examples
    phase.  Each child's output goes to a file under the build directory;
    phase_runtime_and_examples waits for both and prints their lines."""

    def __init__(self):
        self.procs = {}

    def start(self, name):
        if name in self.procs:
            return
        log = kbuild.BUILD_DIR / f"phase_{name}.log"
        log.parent.mkdir(parents=True, exist_ok=True)
        with open(log, "w") as out:
            self.procs[name] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--phases", name],
                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT), log)
        print(f"[{name}] started in a process of its own", flush=True)

    def finish(self, name, timeout=900.0):
        """(return code, output) of a started child once it ends."""
        proc, log = self.procs[name]
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.stop()
        return proc.returncode, log.read_text()

    def stop(self):
        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


CHILDREN = PhaseChildren()


def phase_runtime_and_examples(device, card, out_dir):
    """The runtime phase and the swingup example, each in a process of
    its own (``--phases runtime``, ``--phases swingup-example``; the
    example's started right after the build where that phase ran), beside
    the examples phase in this one: all are host-bound loops of small
    solves (B = 1, the controllers of the examples), and each takes
    minutes.  The children's lines are printed when they end; a child's
    failure fails this phase."""
    for name in ("runtime", "swingup-example"):
        CHILDREN.start(name)
    phase_examples(device, card, out_dir)
    for name in ("runtime", "swingup-example"):
        code, out = CHILDREN.finish(name)
        print("\n".join(ln for ln in out.splitlines()
                        if ln.startswith(("[runtime]", "[examples]",
                                          "[phase]", "chip_smoke"))),
              flush=True)
        check(code == 0, f"the {name} phase failed (its own process)")


def main() -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="phases: build, k4-references (K4@9x16's plain version on "
               "the host CPU, in processes of their own until the centroidal "
               "phase reads them), examples-start (the swingup example in a "
               "process of its own until runtime+examples reads it), "
               "kernels, kernels-variants, e2e, "
               "e2e-variants, serving, driver, times, times-variants, "
               "fmpc-wide (K8-K11 past (8, 4, 16), the masses' solves), "
               "centroidal (K1@9x16, K4@9x16 and the centroidal solves), "
               "centroidal-driver, second-order, "
               "cgmres, horizon, mesh, serial, profiled, runtime+examples "
               "(runtime and swingup-example each in a process of its own "
               "beside examples); "
               "with --qp-groups: qp-groups, row-groups, wide-groups "
               "(K1@9x16 at each G of WIDE_GROUPS), k4-wide (K4@9x16, its "
               "profile build and the baseline's), fmpc-groups, "
               "fwd-groups, fmpc-wide-groups (K8-wide and K9-wide at "
               "(12, 3, 30), their profile build and the baseline's); "
               "with --layers: layers")
    parser.add_argument("--layers", action="store_true",
                        help="also print where one solve's time goes, per "
                             "layer, with the profiler's device busy time")
    parser.add_argument("--qp-groups", action="store_true",
                        help="also time the boxed kernels (K4, K5 boxed) at "
                             "each group size of QP_GROUPS, the unboxed "
                             "group kernels (K1, K2, K3, K5) at each of "
                             "ROW_GROUPS, the FMPC ones (K8, K10) at each "
                             "of FMPC_GROUPS and the forward recursions "
                             "(K6, K11) at each chunk of FWD_CHUNKS and "
                             "(K11) group of FWD_GROUPS")
    parser.add_argument("--centroidal-driver", action="store_true",
                        help="run the centroidal driver to 3.0 s with the "
                             "reference's final assertions (default: its "
                             f"first {CENTROIDAL_DRIVER_STEPS} steps)")
    parser.add_argument("--baseline", metavar="DIR",
                        help="with --qp-groups, also build K1-K6, K8, K10 and "
                             "K11 (and K8-wide, K9-wide) from the checkout at "
                             "DIR, hold this one's K1-K3 to its K1, K8, K10 "
                             "to its K8 and K6, K11 to its K6, K11, and time "
                             "them in turns with this one's")
    parser.add_argument("--phases", metavar="NAME,...",
                        help="run only these phases (a development run: no "
                             "kernel record and no result line)")
    parser.add_argument("--k4-reference", metavar="DTYPE,REG_TYPE",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    if args.k4_reference:
        return k4_reference(args.k4_reference)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    examples_dir = os.path.join(kbuild.BUILD_DIR, "examples")
    print(f"[device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)
    phases = [("build", phase_build),
              ("k4-references", lambda: BOXED_REFS.start(device)),
              ("examples-start", lambda: CHILDREN.start("swingup-example")),
              ("kernels", lambda: phase_kernels(device)),
              ("kernels-variants", lambda: phase_kernels_variants(device)),
              ("e2e", lambda: phase_e2e(device)),
              ("e2e-variants", lambda: phase_e2e_variants(device)),
              ("serving", lambda: phase_serving(device, card)),
              ("driver", lambda: phase_driver(device, card)),
              ("times", lambda: phase_times(device, card)),
              ("times-variants", lambda: phase_times_variants(device, card)),
              ("fmpc-wide", lambda: phase_fmpc_wide(device, card)),
              ("centroidal", lambda: phase_centroidal(device, card)),
              ("centroidal-driver", lambda: phase_centroidal_driver(
                  device, card, args.centroidal_driver)),
              ("second-order", lambda: phase_second_order(device, card)),
              ("cgmres", lambda: phase_cgmres(device, card, args.layers)),
              ("horizon", lambda: phase_horizon(device, card)),
              ("mesh", lambda: phase_mesh(device, card)),
              ("serial", lambda: phase_serial(device, card)),
              ("profiled", lambda: phase_profiled(device, card)),
              ("runtime+examples", lambda: phase_runtime_and_examples(
                  device, card, examples_dir))]
    if args.qp_groups:
        phases.append(("qp-groups", lambda: phase_qp_groups(
            device, card, args.baseline)))
        phases.append(("row-groups", lambda: phase_row_groups(
            device, card, args.baseline)))
        phases.append(("wide-groups", lambda: phase_wide_groups(
            device, card, args.baseline)))
        phases.append(("k4-wide", lambda: phase_k4_wide(
            device, card, args.baseline)))
        phases.append(("fmpc-groups", lambda: phase_fmpc_groups(
            device, card, args.baseline)))
        phases.append(("fmpc-wide-groups", lambda: phase_fmpc_wide_groups(
            device, card, args.baseline)))
        phases.append(("fwd-groups", lambda: phase_fwd_groups(
            device, card, args.baseline)))
    if args.layers:
        phases.append(("layers", lambda: phase_layers(device, card)))
    if args.phases:
        chosen = args.phases.split(",")
        phases = [(name, fn) for name, fn in phases + [
            ("runtime", lambda: phase_runtime(device, card)),
            ("swingup-example", lambda: phase_swingup_example(
                device, card, examples_dir)),
            ("examples", lambda: phase_examples(device, card,
                                                examples_dir))]
                  if name in chosen]
    try:
        for name, phase in phases:
            start = time.perf_counter()
            phase()
            print(f"[phase] {name}: {time.perf_counter() - start:.1f} s",
                  flush=True)
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        BOXED_REFS.stop()
        CHILDREN.stop()
    if args.phases:
        print(f"chip_smoke: ran {[name for name, _ in phases]} only",
              flush=True)
        return 0
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
