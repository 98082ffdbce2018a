"""Trace plotting, the counterpart of the reference's plot scripts
(``nmpc_ddp/scripts/plotDDPTraceData.py``,
``nmpc_cgmres/scripts/plotCgmresData.py``): one subplot per trace column
against the iteration, from a dumped trace table.

Port of ``nmpc_tpu/utils/plotting.py``; matplotlib is imported when a
plot is made, not with the module."""

from __future__ import annotations

from nmpc_tpu_torch.utils.trace import load_trace


def plot_trace_file(file_path: str, out_path: str = None, show: bool = False):
    """Plot every column of a dumped trace table against 'iter'."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = load_trace(file_path)
    keys = [k for k in data if k != "iter"]
    fig, axes = plt.subplots(len(keys), 1, figsize=(8, 2.2 * len(keys)),
                             sharex=True)
    if len(keys) == 1:
        axes = [axes]
    for ax, k in zip(axes, keys):
        ax.plot(data["iter"], data[k], marker="o", markersize=3)
        ax.set_ylabel(k)
        ax.grid(True, alpha=0.3)
    axes[-1].set_xlabel("iter")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=100)
    if show:
        plt.show()
    return fig
