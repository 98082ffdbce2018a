"""The port's boxed centroidal solve (``force_limits = (0, 1000)``: 16
ridge forces; on CPU tensors the plain BoxQP per stage, on the card K4's
wide unit, ``tests/test_torch_k4_wide.py``) against the JAX package's
``solve_batch``, fp64 on the CPU, from t0 = 0 and from t0 = 1.3
(the horizon crosses the flight phase): B = 3, N = 20, 10 iterations
(JAX's compile of its nu = 16 stacked BoxQP takes over a minute of this
file's time, so the horizon and iterations are cut from the unboxed
case's N = 40, 20); statuses and iterations equal, u within 1e-8, every
masked u exactly 0, every first-stage u inside the box.
"""

import pytest
import torch

from test_torch_centroidal import hold_solve_batch, jax_solver

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def boxed_solver():
    return jax_solver(True, 20, 10)


@pytest.mark.parametrize("t0", [0.0, 1.3])
def test_boxed_solve_batch_matches_jax(boxed_solver, t0):
    hold_solve_batch(boxed_solver, t0, boxed=True)
