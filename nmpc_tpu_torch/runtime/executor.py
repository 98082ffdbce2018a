"""ctypes binding for the native real-time MPC executor
(``src/nmpc_runtime.cpp``).

Port of ``nmpc_tpu/runtime/executor.py``, with the port's own copy of the
C++ runtime.  Usage::

    ex = MpcExecutor(sim_dt=0.002, mpc_dt=0.004)
    ex.set_cartpole_plant(x0=[0, pi, 0, 0])
    def solve(t, x):
        res = solver.solve(t, torch.as_tensor(x, device="cuda"), warm_start)
        return res.us[0], res.Ks[0], res.xs[0]   # u_ff, K, x_pred
    log, stats = ex.run(solve, duration=2.0, realtime=False)

The callback may return numpy arrays or tensors on any device.  In
real-time mode it runs on a thread the C++ runtime created, where no
current CUDA device has been chosen: give its tensors an explicit
device.  The library is compiled by g++ at first use into
``build/nmpc_tpu_torch/`` at the root of the checkout, under a name that
carries a hash of the source and flags; a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from nmpc_tpu_torch.kernels.build import BUILD_DIR
from nmpc_tpu_torch.mpc.driver import shift_warm_start

SRC = Path(__file__).resolve().parent / "src" / "nmpc_runtime.cpp"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path() -> Path:
    """Where the runtime library is built: the name carries a hash of the
    source and the flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libnmpc_runtime-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the runtime library unless an up-to-date one exists.
    Raises ``RuntimeError`` with g++'s output on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


_SOLVE_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_double))


@functools.cache
def _load():
    lib = ctypes.CDLL(str(build()))
    P = ctypes.POINTER(ctypes.c_double)
    lib.nmpc_executor_create.restype = ctypes.c_void_p
    lib.nmpc_executor_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_double, ctypes.c_double]
    lib.nmpc_executor_destroy.argtypes = [ctypes.c_void_p]
    lib.nmpc_executor_set_cartpole_plant.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        P]
    lib.nmpc_executor_set_input_limits.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double]
    lib.nmpc_executor_set_feedback.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nmpc_executor_run.restype = ctypes.c_int
    lib.nmpc_executor_run.argtypes = [ctypes.c_void_p, _SOLVE_CB,
                                      ctypes.c_double, ctypes.c_int]
    lib.nmpc_executor_log_size.restype = ctypes.c_long
    lib.nmpc_executor_log_size.argtypes = [ctypes.c_void_p]
    lib.nmpc_executor_get_log.argtypes = [ctypes.c_void_p, P, P, P]
    lib.nmpc_executor_get_state.argtypes = [ctypes.c_void_p, P]
    lib.nmpc_executor_stats.argtypes = [
        ctypes.c_void_p, P, P, P, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long)]
    return lib


class ExecutorStats(NamedTuple):
    p50_ms: float
    p99_ms: float
    max_ms: float
    n_solves: int
    deadline_misses: int


class ExecutorLog(NamedTuple):
    ts: np.ndarray
    xs: np.ndarray
    us: np.ndarray


def _host(a, shape):
    """``a`` (a tensor on any device, or array-like) as a float64 numpy
    array of ``shape``."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, float).reshape(shape)


class WarmStartedSolve:
    """The executor's solve callback for a DDP solver: ``solver.solve``
    from the state the executor passes, on ``device`` (the card unless
    the caller asks for the CPU) at ``dtype``, warm-started by the last
    solution shifted one stage (``shift_warm_start``); returns the first
    stage's (u_ff, K, x_pred).  Every tensor it makes names its device, so
    it runs on the executor's own thread in real-time mode too."""

    def __init__(self, solver, device="cuda", dtype=torch.float64):
        self.solver, self.problem = solver, solver.problem
        self.device, self.dtype = torch.device(device), dtype
        self.reset()

    def reset(self):
        """Start the next solve from zero inputs."""
        self.us = torch.zeros((self.solver.config.horizon_steps,
                               self.problem.input_dim), dtype=self.dtype,
                              device=self.device)

    def __call__(self, t, x):
        x = torch.as_tensor(np.asarray(x), dtype=self.dtype,
                            device=self.device)
        res = self.solver.solve(t, x, self.us)
        self.us = shift_warm_start(self.problem, t + self.problem.dt, res.us)
        return res.us[0], res.Ks[0], res.xs[0]


class MpcExecutor:
    """Native asynchronous MPC executor (see the module docstring)."""

    def __init__(self, nx: int = 4, nu: int = 1, sim_dt: float = 0.002,
                 mpc_dt: float = 0.004):
        self._lib = _load()
        self._h = self._lib.nmpc_executor_create(nx, nu, sim_dt, mpc_dt)
        if not self._h:
            raise RuntimeError("failed to create executor")
        self.nx, self.nu = nx, nu

    def set_cartpole_plant(self, x0, m1=1.0, m2=0.5, l=2.0):
        x0 = np.ascontiguousarray(np.asarray(x0, float))
        self._lib.nmpc_executor_set_cartpole_plant(
            self._h, m1, m2, l,
            x0.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))

    def set_input_limits(self, lo: float, hi: float):
        self._lib.nmpc_executor_set_input_limits(self._h, lo, hi)

    def set_feedback(self, enabled: bool):
        self._lib.nmpc_executor_set_feedback(self._h, int(enabled))

    def run(self, solve: Callable, duration: float, realtime: bool = False):
        """solve(t, x[nx]) -> (u_ff[nu], K[nu,nx], x_pred[nx]).

        realtime=False: deterministic virtual-time interleaving (the
        reference's mpc_dt/sim_dt ratio).  realtime=True: two threads with
        wall-clock pacing and the seqlock packet buffer.  An exception in
        ``solve`` ends the run with ``RuntimeError``."""
        nx, nu = self.nx, self.nu

        @_SOLVE_CB
        def cb(t, x_ptr, uff_ptr, K_ptr, xpred_ptr):
            try:
                x = np.ctypeslib.as_array(x_ptr, shape=(nx,)).copy()
                u_ff, K, x_pred = solve(float(t), x)
                out = ((uff_ptr, _host(u_ff, nu)),
                       (K_ptr, _host(K, nu * nx)),
                       (xpred_ptr, _host(x_pred, nx)))
                for ptr, vals in out:
                    for i, v in enumerate(vals):
                        ptr[i] = v
                return 0
            except Exception:
                import traceback
                traceback.print_exc()
                return -1

        rc = self._lib.nmpc_executor_run(self._h, cb, duration, int(realtime))
        if rc < 0:
            raise RuntimeError(f"solve callback failed (rc={rc})")
        return self.log(), self.stats()

    def log(self) -> ExecutorLog:
        n = self._lib.nmpc_executor_log_size(self._h)
        ts, xs, us = np.zeros(n), np.zeros(n * self.nx), np.zeros(n)
        P = ctypes.POINTER(ctypes.c_double)
        self._lib.nmpc_executor_get_log(self._h, ts.ctypes.data_as(P),
                                        xs.ctypes.data_as(P),
                                        us.ctypes.data_as(P))
        return ExecutorLog(ts, xs.reshape(n, self.nx), us)

    def state(self) -> np.ndarray:
        x = np.zeros(self.nx)
        self._lib.nmpc_executor_get_state(
            self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return x

    def stats(self) -> ExecutorStats:
        p50, p99, mx = ctypes.c_double(), ctypes.c_double(), ctypes.c_double()
        n, miss = ctypes.c_long(), ctypes.c_long()
        self._lib.nmpc_executor_stats(self._h, ctypes.byref(p50),
                                      ctypes.byref(p99), ctypes.byref(mx),
                                      ctypes.byref(n), ctypes.byref(miss))
        return ExecutorStats(p50.value, p99.value, mx.value, n.value,
                             miss.value)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.nmpc_executor_destroy(self._h)
                self._h = None
        except Exception:
            pass
