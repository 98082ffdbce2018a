"""Horizon-sharded (sequence-parallel) Riccati over the ``sp`` mesh axis.

Port of ``nmpc_tpu/parallel/horizon.py``.  The reference processes the
horizon strictly sequentially on one thread (``DDPSolver.hpp:367``,
``FmpcSolver.hpp:551``); here the horizon is split into P blocks, one a
rank of the ``sp`` axis, and the backward value recursion is a
*distributed* suffix scan of Riccati flows:

  1. each rank scans its own block (:func:`block_suffix`, O(log L)
     depth, no communication);
  2. one ``all_gather`` over ``sp`` exchanges the P block-total flows
     (one [3, nz, nz] tensor a rank);
  3. each rank composes the suffix of the *later* blocks
     (:func:`later_flow`, O(log P) small combines, replicated);
  4. value matrices and gains follow stagewise (:func:`block_gains`).

Communication is one nz²-sized all-gather a solve, whatever N.  The flow
algebra (extended state, square completion, composition law) lives in
``solvers/parallel_riccati.py``; this module adds the distribution.

Unlike the JAX ``shard_map`` version, which takes and returns global
arrays, :func:`solve_lqr_horizon_sharded` takes this rank's block of
stages and returns this rank's block of results.  Steps 1, 3 and 4 are
functions of one block, so :func:`solve_lqr_horizon_blocks` runs all the
blocks in one process with the gathered totals stacked in place of the
collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nmpc_tpu_torch.solvers.parallel_riccati import (LQRStage, _combine,
                                                     _extend, _gains,
                                                     _terminal,
                                                     associative_scan)


def _identity_flow(nz, like):
    """The flow phi(S) = S: F = I, C = 0, J = 0."""
    return (torch.eye(nz, dtype=like.dtype, device=like.device),
            like.new_zeros((nz, nz)), like.new_zeros((nz, nz)))


def _apply_flow(F, C, J, S):
    """phi(S) = J + Fᵀ S (I + C S)⁻¹ F, batched over leading axes."""
    eye = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
    W = torch.linalg.solve(eye + C @ S, F)             # (I + C S)⁻¹ F
    out = J + F.transpose(-1, -2) @ S @ W
    return 0.5 * (out + out.transpose(-1, -2))


def block_suffix(stage: LQRStage):
    """Step 1: the extended flows of a block of stages and their suffix
    compositions within the block.  Returns ((Fs, Cs, Js) [L, nz, nz],
    (Az, Bz, Mz)); element 0 of the suffixes is the block's total."""
    flows, ext = _extend(stage)
    # the reverse scan passes (later-combined, earlier): flip for _combine
    suffix = associative_scan(lambda a, b: _combine(b, a), flows,
                              reverse=True)
    return suffix, ext


def later_flow(totals, p: int):
    """Step 3: the composition of the block totals after block ``p``
    (``totals`` the P gathered (F, C, J) [P, nz, nz]); the identity flow
    for the last block."""
    suf = associative_scan(lambda a, b: _combine(b, a), totals, reverse=True)
    if p + 1 < totals[0].shape[0]:
        return tuple(s[p + 1] for s in suf)
    return _identity_flow(totals[0].shape[-1], totals[0])


def block_gains(stage: LQRStage, suffix, ext, R, Sz_T):
    """Step 4: the block's value matrices and gains from its local
    suffixes and the flow ``R`` of everything after the block: (Ks
    [L, nu, nx], ks [L, nu], Ss [L, nz, nz], S_i for the block's stages)."""
    nx = stage.A.shape[-1]
    Az, Bz, Mz = ext
    # global suffix flows: local block suffix o everything after the block
    Fg, Cg, Jg = _combine(suffix, tuple(x[None] for x in R))
    Ss = _apply_flow(Fg, Cg, Jg, Sz_T)                    # [L, nz, nz]
    S_bound = _apply_flow(*R, Sz_T)                       # S at block end
    S_next = torch.cat([Ss[1:], S_bound[None]])
    Ks, ks = _gains(stage.Quu, Az, Bz, Mz, S_next, nx)
    return Ks, ks, Ss


def solve_lqr_horizon_sharded(stage: LQRStage, S_T, v_T=None, *, mesh,
                              axis_name: str = "sp"):
    """LQR gains with the horizon split over the ``axis_name`` ranks of
    ``mesh`` (a ``torch.distributed`` ``DeviceMesh``).

    ``stage`` is this rank's block of L = N / sp consecutive stages (rank
    p of the axis holds stages p L .. (p + 1) L - 1); S_T [nx, nx] and v_T
    [nx] are the terminal cost, the same on every rank.  Returns this
    rank's block: ``Ks [L, nu, nx]``, ``ks [L, nu]`` and the extended value
    matrices ``Ss [L, nz, nz]``.  One ``all_gather`` over the axis's group
    (gloo on CPU tensors, NCCL on CUDA tensors).
    """
    Sz_T = _terminal(S_T, v_T, stage.A)
    suffix, ext = block_suffix(stage)
    group = mesh.get_group(axis_name)
    P = mesh.size(mesh.mesh_dim_names.index(axis_name))
    mine = torch.stack([s[0] for s in suffix]).contiguous()   # [3, nz, nz]
    gathered = [torch.empty_like(mine) for _ in range(P)]
    dist.all_gather(gathered, mine, group=group)
    totals = tuple(torch.stack(gathered, dim=1))              # 3 x [P, ...]
    R = later_flow(totals, mesh.get_local_rank(axis_name))
    return block_gains(stage, suffix, ext, R, Sz_T)


def solve_lqr_horizon_blocks(stage: LQRStage, S_T, v_T=None, *,
                             blocks: int):
    """The sharded algorithm in one process: the N stages split into
    ``blocks`` blocks, each run through the functions of the sharded
    solve, the block totals stacked where the ranks would gather them.
    Returns the global (Ks [N, nu, nx], ks [N, nu], Ss [N, nz, nz])."""
    N = stage.A.shape[0]
    if N % blocks:
        raise ValueError(f"horizon {N} must be divisible by blocks={blocks}")
    L = N // blocks
    Sz_T = _terminal(S_T, v_T, stage.A)
    parts = [LQRStage(*(f[p * L:(p + 1) * L] for f in stage))
             for p in range(blocks)]
    local = [block_suffix(part) for part in parts]
    totals = tuple(torch.stack([suffix[i][0] for suffix, _ in local])
                   for i in range(3))
    outs = [block_gains(part, suffix, ext, later_flow(totals, p), Sz_T)
            for p, (part, (suffix, ext)) in enumerate(zip(parts, local))]
    return tuple(torch.cat(o) for o in zip(*outs))
