"""Cart-pole problem of the PyTorch port vs the JAX package and the NumPy
golden: dynamics, costs and every torch.func derivative, at fp64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden.cartpole_numpy import CartPoleGolden
from nmpc_tpu.models.cartpole import make_cartpole_problem as jax_cartpole
from nmpc_tpu_torch.models.cartpole import make_cartpole_problem

torch.set_num_threads(1)

DT = 0.01


def _points(seed):
    """(t, x, u) as numpy, made from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=4) * np.array([1.0, 3.0, 2.0, 4.0])
    u = rng.normal(size=1) * 10.0
    return 0.05 * seed, x, u


def _port_values(t, x, u):
    p = make_cartpole_problem(DT)
    tt = torch.tensor(t, dtype=torch.float64)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    vals = {"f": p.dynamics(tt, xt, ut), "l": p.running_cost(tt, xt, ut),
            "phi": p.terminal_cost(tt, xt)}
    vals.update(zip(("Fx", "Fu"), p.linearize_dynamics(tt, xt, ut)))
    vals.update(zip(("Lx", "Lu", "Lxx", "Luu", "Lxu"),
                    p.quadraticize_running_cost(tt, xt, ut)))
    vals.update(zip(("Vx", "Vxx"), p.quadraticize_terminal_cost(tt, xt)))
    return {k: v.detach().numpy() for k, v in vals.items()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_derivatives_match_jax(seed):
    """torch.func (jacfwd / grad / hessian / jacfwd(grad)) vs JAX autodiff
    on the same points: atol 1e-12."""
    t, x, u = _points(seed)
    got = _port_values(t, x, u)
    p = jax_cartpole(DT)
    tj, xj, uj = jnp.float64(t), jnp.asarray(x), jnp.asarray(u)
    ref = {"f": p.dynamics(tj, xj, uj), "l": p.running_cost(tj, xj, uj),
           "phi": p.terminal_cost(tj, xj)}
    ref.update(zip(("Fx", "Fu"), p.linearize_dynamics(tj, xj, uj)))
    ref.update(zip(("Lx", "Lu", "Lxx", "Luu", "Lxu"),
                   p.quadraticize_running_cost(tj, xj, uj)))
    ref.update(zip(("Vx", "Vxx"), p.quadraticize_terminal_cost(tj, xj)))
    for name, val in ref.items():
        val = np.asarray(jax.device_get(val))
        assert got[name].shape == val.shape, name
        assert got[name].dtype == np.float64, name
        np.testing.assert_allclose(got[name], val, atol=1e-12, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_derivatives_match_golden(seed):
    """torch.func derivatives vs the hand-derived analytic NumPy ones:
    atol 1e-10 (as tests/test_ddp_cartpole.py:31-45)."""
    t, x, u = _points(seed)
    got = _port_values(t, x, u)
    g = CartPoleGolden(DT)
    ref = {"f": g.dynamics(t, x, u), "l": g.running_cost(t, x, u),
           "phi": g.terminal_cost(t, x)}
    ref.update(zip(("Fx", "Fu"), g.fx_fu(t, x, u)))
    ref.update(zip(("Lx", "Lu", "Lxx", "Luu", "Lxu"), g.lderivs(t, x, u)))
    ref.update(zip(("Vx", "Vxx"), g.vderivs(t, x)))
    for name, val in ref.items():
        np.testing.assert_allclose(got[name], val, atol=1e-10, rtol=0,
                                   err_msg=name)


def test_fp32_state_keeps_fp32():
    """fp64 model constants do not promote an fp32 evaluation (the weights
    are cast to x.dtype at use, as nmpc_tpu/models/cartpole.py:84-89)."""
    p = make_cartpole_problem(DT)
    x = torch.tensor([0.1, 3.0, 0.0, 0.2])
    u = torch.tensor([1.0])
    t = torch.tensor(0.0)
    assert p.dynamics(t, x, u).dtype == torch.float32
    assert p.running_cost(t, x, u).dtype == torch.float32
    assert all(a.dtype == torch.float32
               for a in p.quadraticize_running_cost(t, x, u))
