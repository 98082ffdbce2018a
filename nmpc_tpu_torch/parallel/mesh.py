"""Device mesh construction and sharded batch solving on
``torch.distributed``.

Port of ``nmpc_tpu/parallel/mesh.py``.  The reference has no parallelism:
every solver is a single-threaded loop (``DDPSolver.hpp:367``).  Here a
``DeviceMesh`` spans the processes of a ``torch.distributed`` group, one a
card (NCCL) or one a CPU worker (gloo); the batch of independent solves
is split over ``dp`` and cross-batch statistics are one ``all_reduce``.

Axes
----
``dp``  data/scenario parallelism: the batch of independent solves split
        across ranks (the dominant axis for MPC workloads).
``sp``  sequence/horizon axis for the horizon-sharded Riccati
        (``parallel/horizon.py``); size 1 for the batch solve.

The JAX module's ``batch_sharding`` and ``replicated`` name XLA array
placements; torch tensors live on one device each, so they have no
counterpart: :func:`shard_batch` hands each rank its own slice instead.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, device_type: str = "cuda"):
    """Join this process to the job's ``torch.distributed`` group (NCCL
    for ``device_type="cuda"``, gloo for ``"cpu"``) so that meshes span
    every process.

    With ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` the group is formed over TCP at that address; without
    them from the ``env://`` variables (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) when ``WORLD_SIZE`` > 1.  A no-op when a
    group exists already or the environment names no job of more than one
    process.  A failed initialization raises.
    """
    if dist.is_initialized():
        return
    backend = BACKENDS[device_type]
    if coordinator_address is not None:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
        return
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend, init_method="env://")


def make_mesh(dp=None, sp: int = 1, device_type: str = "cuda"):
    """A (dp, sp) ``DeviceMesh`` over the processes of the default group
    (``dp`` defaults to world size / sp); NCCL on ``"cuda"``, gloo on
    ``"cpu"``.  The group must exist (:func:`initialize_multihost`, or
    ``init_process_group``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed group: "
                           "call initialize_multihost() or "
                           "init_process_group() first")
    n = dist.get_world_size()
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp={dp * sp} must equal the world size {n}")
    return init_device_mesh(device_type, (dp, sp),
                            mesh_dim_names=("dp", "sp"))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(mesh, tensors):
    """This rank's ``dp`` slice of each batch-leading tensor of the
    sequence ``tensors``, on this rank's device (B divisible by dp)."""
    dp = mesh.size(0)
    p = mesh.get_local_rank("dp")
    device = _mesh_device(mesh)
    out = []
    for a in tensors:
        B = a.shape[0]
        if B % dp:
            raise ValueError(f"batch {B} must be divisible by dp={dp}")
        n = B // dp
        out.append(a[p * n:(p + 1) * n].to(device).contiguous())
    return tuple(out)


def make_sharded_solve(solver, mesh):
    """``solve(t0, x0s, us0s)`` on this rank's shard (from
    :func:`shard_batch`): the solver's ``solve_batch`` on the local lanes.
    The lanes are independent, so the solve needs no collective; the
    cross-batch statistics do (:func:`convergence_stats`)."""

    def solve(t0, x0s, us0s):
        if x0s.device != _mesh_device(mesh):
            raise ValueError(f"the shard is on {x0s.device}; this rank "
                             f"solves on {_mesh_device(mesh)}")
        return solver.solve_batch(t0, x0s, us0s)

    return solve


def convergence_stats(mesh, result):
    """Global success rate and mean iterations: one ``all_reduce(SUM)`` of
    [n, succeeded, Σ iters] over the ``dp`` group (the JAX module's
    ``psum`` over ``dp``).  Returns {"n", "success_rate", "mean_iters"} as
    float64 scalars on this rank's device."""
    status, iters = result.status, result.iters
    stats = torch.stack([
        torch.tensor(float(status.shape[0]), dtype=torch.float64,
                     device=status.device),
        torch.sum(status == 1).to(torch.float64),
        torch.sum(iters).to(torch.float64)])
    dist.all_reduce(stats, op=dist.ReduceOp.SUM, group=mesh.get_group("dp"))
    total, succ, it_sum = stats
    return {"n": total, "success_rate": succ / total,
            "mean_iters": it_sum / total}
