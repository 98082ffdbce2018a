"""Trace-data dumps in the reference's whitespace-table format.

The port's own copy of ``nmpc_tpu/utils/trace.py`` (numpy only), taking
the port's result types (tensors on any device).  Column schemas match
``DDPSolver::dumpTraceDataList`` (``nmpc_ddp/include/nmpc_ddp/
DDPSolver.hpp:563-598``) and ``FmpcSolver::dumpTraceDataList``
(``FmpcSolver.hpp:260-283``), so that the reference's plotting scripts
(``nmpc_ddp/scripts/plotDDPTraceData.py``) apply unchanged.  Per-phase
durations are measured on the host by the caller; without them they are
written as 0.
"""

from __future__ import annotations

import numpy as np


def _np(a):
    """``a`` as a numpy array (a tensor is first brought to the host)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def dump_ddp_trace(result, file_path: str, durations=None):
    """Write a DDP trace table for one (unbatched) ``DDPResult``."""
    tr = result.trace
    n = int(result.iters) + 1
    cols = [
        ("iter", _np(tr.iter)[:n]),
        ("cost", _np(tr.cost)[:n]),
        ("lambda", _np(tr.lam)[:n]),
        ("dlambda", _np(tr.dlam)[:n]),
        ("alpha", _np(tr.alpha)[:n]),
        ("k_rel_norm", _np(tr.k_rel_norm)[:n]),
        ("cost_update_actual", _np(tr.cost_update_actual)[:n]),
        ("cost_update_expected", _np(tr.cost_update_expected)[:n]),
        ("cost_update_ratio", _np(tr.cost_update_ratio)[:n]),
        ("duration_derivative", np.zeros(n)),
        ("duration_backward", np.zeros(n)),
        ("duration_forward", np.zeros(n)),
    ]
    _fill_durations(cols, durations, slice(0, n))
    _write_table(file_path, cols)


def dump_fmpc_trace(result, file_path: str, durations=None):
    """Write an FMPC trace table for one (unbatched) ``FmpcResult``;
    ``durations`` fills the per-iteration coeff / backward / forward /
    update millisecond columns (reference ``FmpcSolver.h:254-288``)."""
    tr = result.trace
    n = int(result.iters) + 1
    cols = [
        ("iter", _np(tr.iter)[1:n]),
        ("kkt_error", _np(tr.kkt_error)[1:n]),
        ("duration_coeff", np.zeros(max(n - 1, 0))),
        ("duration_backward", np.zeros(max(n - 1, 0))),
        ("duration_forward", np.zeros(max(n - 1, 0))),
        ("duration_update", np.zeros(max(n - 1, 0))),
    ]
    _fill_durations(cols, durations, slice(1, n))
    _write_table(file_path, cols)


def _fill_durations(cols, durations, rows):
    for name, arr in (durations or {}).items():
        for i, (cn, _) in enumerate(cols):
            if cn == f"duration_{name}":
                cols[i] = (cn, _np(arr)[rows])


def _write_table(file_path, cols):
    header = " ".join(name for name, _ in cols)
    data = (np.column_stack([arr for _, arr in cols]) if cols[0][1].size
            else np.zeros((0, len(cols))))
    with open(file_path, "w") as f:
        f.write(header + "\n")
        for row in data:
            f.write(" ".join(_fmt(v) for v in row) + "\n")


def _fmt(v):
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def dump_cgmres_data(ts, xs, us, errs, prefix: str,
                     dump_step: int = 1, log_dt: float = None,
                     param: dict = None):
    """Write a C/GMRES closed-loop history to ``{prefix}_{x,u,err}.dat``
    (rows ``t, v1, v2, ...``) and a JSON ``{prefix}_param.dat``: the
    reference's layout (``CgmresSolver::run``, ``CgmresSolver.cpp:68-103``)
    that its ``plotCgmresData.py`` reads."""
    import json

    step = max(dump_step, 1)
    ts = _np(ts)[::step]
    rows = {
        "x": _np(xs)[::step],
        "u": _np(us)[::step],
        "err": _np(errs)[::step].reshape(len(ts), -1),
    }
    for name, vals in rows.items():
        with open(f"{prefix}_{name}.dat", "w") as f:
            for t, v in zip(ts, vals):
                f.write(", ".join([repr(float(t))]
                                  + [repr(float(x)) for x in np.ravel(v)])
                        + "\n")
    p = dict(param or {})
    if log_dt is not None:
        p.setdefault("log_dt", log_dt)
    with open(f"{prefix}_param.dat", "w") as f:
        json.dump(p, f, indent=1)
        f.write("\n")


def load_cgmres_data(prefix: str):
    """``{prefix}_{x,u,err}.dat`` back as (ts, xs, us, errs)."""
    out = [np.loadtxt(f"{prefix}_{name}.dat", delimiter=",", ndmin=2)
           for name in ("x", "u", "err")]
    return out[0][:, 0], out[0][:, 1:], out[1][:, 1:], out[2][:, 1:].squeeze(-1)


def load_trace(file_path: str) -> dict:
    """A dumped trace table back as {column: np.ndarray}."""
    with open(file_path) as f:
        header = f.readline().split()
    data = np.loadtxt(file_path, skiprows=1, ndmin=2)
    return {name: data[:, i] if data.size else np.zeros(0)
            for i, name in enumerate(header)}
