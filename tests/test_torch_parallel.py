"""The port's multi-process paths on the CPU: ``parallel/mesh.py`` and
``parallel/horizon.py`` on one group of 4 gloo ranks (formed through a
file:// rendezvous under tmp_path, no fixed TCP port), run once for every
check; ``initialize_multihost`` without and with the env:// variables.

The ranks run ``RANK_CODE`` (``python -c``), which imports the port only;
the JAX numbers are computed here first and handed in."""

import ast
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from nmpc_tpu import DDPConfig as JaxConfig
from nmpc_tpu import DDPSolver as JaxSolver
from nmpc_tpu.models.cartpole import make_cartpole_problem as jax_cartpole
from nmpc_tpu.solvers import parallel_riccati as jax_pr
from nmpc_tpu_torch import DDPConfig, DDPSolver
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
from nmpc_tpu_torch.solvers.parallel_riccati import (LQRStage,
                                                     solve_lqr_parallel)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4

# One rank's program: "group RANK WORLD INIT_FILE IN.npz OUT_PREFIX" runs a
# group of WORLD ranks formed through file://INIT_FILE (the dp=WORLD
# sharded solve and its convergence_stats, then the (dp=1, sp=WORLD)
# horizon-sharded LQR on this rank's block; results to
# OUT_PREFIX<RANK>.npz); "env" initializes from the env:// variables,
# builds a dp=WORLD_SIZE mesh, shards a batch and reduces it.
RANK_CODE = r'''
import sys

import numpy as np
import torch
import torch.distributed as dist

from nmpc_tpu_torch import DDPConfig, DDPSolver
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem
from nmpc_tpu_torch.parallel.horizon import (
    solve_lqr_horizon_sharded)
from nmpc_tpu_torch.parallel.mesh import (
    convergence_stats, initialize_multihost, make_mesh, make_sharded_solve,
    shard_batch)
from nmpc_tpu_torch.solvers.parallel_riccati import LQRStage

torch.set_num_threads(1)


def group(rank, world, init_file, inp, out):
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    data = np.load(inp)
    mesh = make_mesh(dp=world, sp=1, device_type="cpu")
    solver = DDPSolver(make_cartpole_problem(0.01),
                       DDPConfig(horizon_steps=int(data["N"]), max_iter=10))
    shard = shard_batch(mesh, (torch.as_tensor(data["x0s"]),
                               torch.as_tensor(data["us0"])))
    res = make_sharded_solve(solver, mesh)(0.0, *shard)
    stats = convergence_stats(mesh, res)

    hmesh = make_mesh(dp=1, sp=world, device_type="cpu")
    stage = LQRStage(*(torch.as_tensor(data[f"stage_{f}"])
                       for f in LQRStage._fields))
    L = stage.A.shape[0] // world
    p = hmesh.get_local_rank("sp")
    block = LQRStage(*(f[p * L:(p + 1) * L] for f in stage))
    Ks, ks, Ss = solve_lqr_horizon_sharded(
        block, torch.as_tensor(data["S_T"]), torch.as_tensor(data["v_T"]),
        mesh=hmesh)
    np.savez(f"{out}{rank}.npz", us=res.us.numpy(),
             status=res.status.numpy(), iters=res.iters.numpy(),
             stats=np.array([float(stats[k]) for k in
                             ("n", "success_rate", "mean_iters")]),
             dp_rank=mesh.get_local_rank("dp"), sp_rank=p,
             mesh_shape=np.array(tuple(mesh.shape)),
             Ks=Ks.numpy(), ks=ks.numpy(), Ss=Ss.numpy(),
             jax_free="nmpc_tpu" not in sys.modules)
    dist.destroy_process_group()


def env():
    initialize_multihost(device_type="cpu")
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    world = dist.get_world_size()
    mesh = make_mesh(device_type="cpu")
    assert tuple(mesh.shape) == (world, 1), mesh.shape
    (xs,) = shard_batch(mesh, (torch.arange(8.0).reshape(8, 1),))
    total = xs.sum()
    dist.all_reduce(total, group=mesh.get_group("dp"))
    assert float(total) == 28.0, float(total)
    initialize_multihost(device_type="cpu")    # initialized: a no-op
    dist.destroy_process_group()
    print("LAUNCHER-OK", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "group":
        group(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    else:
        env()
'''

B, N = 16, 30            # test_parallel.py:24-46
HN, NX, NU = 64, 4, 2    # test_parallel.py:48-83


def _lqr_inputs():
    """test_parallel.py:48-83's stage (seed 7) as numpy arrays."""
    rng = np.random.default_rng(7)
    A = rng.normal(size=(HN, NX, NX)) * 0.3 + np.eye(NX)[None]
    Bm = rng.normal(size=(HN, NX, NU)) * 0.3
    c = rng.normal(size=(HN, NX)) * 0.1
    W = rng.normal(size=(HN, NX, NX)) * 0.3
    Qxx = W @ W.transpose(0, 2, 1) + 0.5 * np.eye(NX)[None]
    Wu = rng.normal(size=(HN, NU, NU)) * 0.3
    Quu = Wu @ Wu.transpose(0, 2, 1) + np.eye(NU)[None]
    Qux = rng.normal(size=(HN, NU, NX)) * 0.2
    q = rng.normal(size=(HN, NX)) * 0.2
    r = rng.normal(size=(HN, NU)) * 0.2
    Wt = rng.normal(size=(NX, NX))
    return (A, Bm, c, Qxx, Quu, Qux, q, r), Wt @ Wt.T + np.eye(NX), \
        rng.normal(size=NX)


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    """The JAX and the single-process port numbers, then one group of 4
    ranks; returns (reference numbers, per-rank results)."""
    tmp = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(0)
    x0s = (np.stack([[0.0, np.pi, 0.0, 0.0]] * B)
           + 0.1 * rng.normal(size=(B, 4)))
    us0 = np.zeros((B, N, 1))
    jres = JaxSolver(jax_cartpole(0.01), JaxConfig(
        horizon_steps=N, max_iter=10)).solve_batch(
            0.0, jnp.asarray(x0s), jnp.asarray(us0))
    local = DDPSolver(make_cartpole_problem(0.01), DDPConfig(
        horizon_steps=N, max_iter=10)).solve_batch(
            0.0, torch.as_tensor(x0s), torch.as_tensor(us0))
    stage, S_T, v_T = _lqr_inputs()
    jseq = jax_pr.solve_lqr_sequential(
        jax_pr.LQRStage(*map(jnp.asarray, stage)), jnp.asarray(S_T),
        jnp.asarray(v_T))
    tpar = solve_lqr_parallel(LQRStage(*map(torch.as_tensor, stage)),
                              torch.as_tensor(S_T), torch.as_tensor(v_T))
    ref = {"jax_us": np.asarray(jres.us), "jax_status": np.asarray(jres.status),
           "local_us": local.us.numpy(), "local_status": local.status.numpy(),
           "local_iters": local.iters.numpy(),
           "jax_Ks": np.asarray(jseq[0]), "jax_ks": np.asarray(jseq[1]),
           "par_Ks": tpar[0].numpy(), "par_ks": tpar[1].numpy(),
           "par_Ss": tpar[2].numpy()}

    inp = tmp / "in.npz"
    np.savez(inp, N=N, x0s=x0s, us0=us0, S_T=S_T, v_T=v_T,
             **{f"stage_{f}": a for f, a in zip(LQRStage._fields, stage)})
    init, out = tmp / "rendezvous", tmp / "out"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE, "group", str(r), str(RANKS),
         str(init), str(inp), str(out)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(RANKS)]
    logs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, (o, e[-3000:])
    ranks = [dict(np.load(f"{out}{r}.npz")) for r in range(RANKS)]
    return ref, ranks


def test_ranks_import_no_jax_package(group_run):
    """The ranks' program imports neither jax nor the JAX package (by its
    source), and no rank had the JAX package loaded."""
    _, ranks = group_run
    assert all(bool(r["jax_free"]) for r in ranks)
    for node in ast.walk(ast.parse(RANK_CODE)):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom)
                 else [])
        assert not any(n.split(".")[0] in ("jax", "jaxlib", "nmpc_tpu")
                       for n in names), names


def test_mesh_shapes(group_run):
    """dp=4: a (4, 1) mesh, rank r holding dp coordinate r."""
    _, ranks = group_run
    for r, res in enumerate(ranks):
        assert tuple(res["mesh_shape"]) == (RANKS, 1)
        assert int(res["dp_rank"]) == r and int(res["sp_rank"]) == r


def test_sharded_solve_matches_local_and_jax(group_run):
    """test_parallel.py:24-46: cart-pole B=16, N=30, 10 iterations on a
    dp=4 mesh; the gathered shards equal the port's ``solve_batch`` on the
    whole batch (us within 1e-10, statuses equal) and JAX's."""
    ref, ranks = group_run
    us = np.concatenate([r["us"] for r in ranks])
    status = np.concatenate([r["status"] for r in ranks])
    assert all(r["us"].shape == (B // RANKS, N, 1) for r in ranks)
    np.testing.assert_allclose(us, ref["local_us"], atol=1e-10, rtol=0)
    np.testing.assert_array_equal(status, ref["local_status"])
    np.testing.assert_allclose(us, ref["jax_us"], atol=1e-10, rtol=0)
    np.testing.assert_array_equal(status, ref["jax_status"])


def test_convergence_stats_all_reduce(group_run):
    """One all_reduce over dp: every rank holds n = B and the batch's own
    success rate and mean iterations."""
    ref, ranks = group_run
    want = [B, float(np.mean(ref["local_status"] == 1)),
            float(np.mean(ref["local_iters"]))]
    for r in ranks:
        np.testing.assert_allclose(r["stats"], want, rtol=1e-15, atol=0)


def test_horizon_sharded_matches_sequential(group_run):
    """test_parallel.py:48-83 on a (dp=1, sp=4) mesh: each rank returns
    its block of N/4 stages; together within 1e-8 of JAX's
    ``solve_lqr_sequential`` and 1e-10 of the port's
    ``solve_lqr_parallel``."""
    ref, ranks = group_run
    for r in ranks:
        assert r["Ss"].shape == (HN // RANKS, NX + 1, NX + 1)
        assert r["Ks"].shape == (HN // RANKS, NU, NX)
    Ks = np.concatenate([r["Ks"] for r in ranks])
    ks = np.concatenate([r["ks"] for r in ranks])
    Ss = np.concatenate([r["Ss"] for r in ranks])
    np.testing.assert_allclose(Ks, ref["jax_Ks"], atol=1e-8, rtol=1e-8)
    np.testing.assert_allclose(ks, ref["jax_ks"], atol=1e-8, rtol=1e-8)
    np.testing.assert_allclose(Ks, ref["par_Ks"], atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(ks, ref["par_ks"], atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(Ss, ref["par_Ss"][:-1], atol=1e-10,
                               rtol=1e-10)


def test_initialize_multihost_without_environment(monkeypatch):
    """No WORLD_SIZE and no address: a no-op, and make_mesh then names
    the missing group."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize_multihost(device_type="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torch.distributed group"):
        make_mesh(device_type="cpu")


def test_initialize_multihost_from_env_two_ranks():
    """test_parallel.py:98-130's launcher check: two processes join from
    the env:// variables, build a mesh, shard a batch and reduce it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_CODE, "env"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0 and "LAUNCHER-OK" in out, (out, err[-3000:])
