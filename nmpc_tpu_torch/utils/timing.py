"""Computation-duration instrumentation.

Port of ``nmpc_tpu/utils/timing.py``.  The reference times every phase
with ``std::chrono`` inside the solver (``DDPSolver::ComputationDuration``,
``DDPSolver.h:219-247``; ``FmpcSolver.h:254-288``).  Here:

* :class:`ComputationDuration` keeps the reference's schema;
* :class:`Stopwatch` and :func:`timed_solve` time on the host clock and
  synchronize the device before reading it;
* :class:`PhaseTimer` is the solvers' optional per-iteration phase timer
  (CUDA events on the card, ``perf_counter`` on the CPU), which
  ``utils/profiled.py`` passes in;
* :func:`profile_solve` writes a ``torch.profiler`` trace of one solve.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from pathlib import Path

import numpy as np
import torch


@dataclasses.dataclass
class ComputationDuration:
    """Schema of ``DDPSolver::ComputationDuration`` (``DDPSolver.h:
    219-247``); all in milliseconds."""

    solve: float = 0.0
    setup: float = 0.0
    opt: float = 0.0
    derivative: float = 0.0
    backward: float = 0.0
    forward: float = 0.0
    Q: float = 0.0
    reg: float = 0.0
    gain: float = 0.0


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Stopwatch:
    """Host-clock phase timer, ``with sw.phase('solve'): ...``; the
    device (if a CUDA device is given) is synchronized at both ends of a
    phase, so a phase includes the device work it queued."""

    def __init__(self, device=None):
        self.device = device
        self.durations_ms = {}

    @contextlib.contextmanager
    def phase(self, name):
        _sync(self.device)
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            _sync(self.device)
            dt = 1e3 * (time.perf_counter() - t0)
            self.durations_ms[name] = self.durations_ms.get(name, 0.0) + dt

    def as_computation_duration(self) -> ComputationDuration:
        d = ComputationDuration()
        for k, v in self.durations_ms.items():
            if hasattr(d, k):
                setattr(d, k, v)
        return d


class PhaseTimer:
    """Per-iteration phase times of one solve: ``with timer.phase(name,
    row): ...`` adds the phase's milliseconds to row ``row`` of column
    ``name``.  On a CUDA device each phase is bracketed by two CUDA
    events on the current stream (the device time between them, its idle
    gaps included), read when :meth:`durations` is called; on the CPU by
    ``perf_counter``.  A solver given no timer records nothing and adds no
    event and no synchronization."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._spans = collections.defaultdict(list)   # name -> [(row, ...)]

    @contextlib.contextmanager
    def phase(self, name, row):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._spans[name].append((row, start, end))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._spans[name].append(
                    (row, 1e3 * (time.perf_counter() - t0)))

    def durations(self, n_rows: int, names=()) -> dict:
        """{name: float64 array [n_rows] of milliseconds}, every recorded
        phase and each of ``names`` (zeros where nothing ran).  A span
        whose row lies past the table is left out: the FMPC check after
        the last iteration, whose result no lane takes."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {name: np.zeros(n_rows) for name in names}
        for name, spans in self._spans.items():
            col = out.setdefault(name, np.zeros(n_rows))
            for row, *span in spans:
                if row >= n_rows:
                    continue
                col[row] += (span[0].elapsed_time(span[1]) if self.cuda
                             else span[0])
        return out


def phase(timer, name, row):
    """``timer.phase(name, row)``, or a no-op context without a timer."""
    return contextlib.nullcontext() if timer is None else timer.phase(name,
                                                                      row)


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def timed_solve(solver, *args, **kwargs):
    """Run ``solver.solve`` with host timing; returns (result, duration).

    ``duration.solve`` includes the device's work (synchronized), like
    the reference's end-to-end ``solve`` timer."""
    sw = Stopwatch(_device_of(args))
    with sw.phase("solve"):
        res = solver.solve(*args, **kwargs)
    return res, sw.as_computation_duration()


def profile_solve(solver, *args, log_dir=None, **kwargs):
    """One solve under ``torch.profiler`` (CPU and, on the card, CUDA
    activity), its Chrome trace written to ``log_dir`` (default
    ``build/nmpc_tpu_torch/profile`` at the root of the checkout).
    Returns (result, path of the trace)."""
    from nmpc_tpu_torch.kernels.build import BUILD_DIR

    log_dir = Path(log_dir) if log_dir else BUILD_DIR / "profile"
    log_dir.mkdir(parents=True, exist_ok=True)
    device = _device_of(args)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        res = solver.solve(*args, **kwargs)
        _sync(device)
    path = log_dir / f"solve-{os.getpid()}-{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    return res, str(path)
