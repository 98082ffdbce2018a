"""Carry configs, model parameters and solver state across from the JAX
package.

Nothing here imports ``jax`` or ``nmpc_tpu``: configs are read from any
dataclass with the same fields, arrays as numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nmpc_tpu_torch.core.types import BoxQPConfig, DDPConfig, DDPResult
from nmpc_tpu_torch.models.cartpole import (CartPoleCostWeight, CartPoleParam,
                                            make_cartpole_problem)
from nmpc_tpu_torch.models.vertical import (VerticalCostWeight,
                                            make_vertical_problem)


def ddp_config_from_reference(cfg) -> DDPConfig:
    """A ``DDPConfig`` equal field for field (nested ``boxqp`` included) to
    ``cfg``, any dataclass with ``DDPConfig``'s fields."""
    fields = dataclasses.asdict(cfg)
    boxqp = BoxQPConfig(**fields.pop("boxqp"))
    return DDPConfig(**fields, boxqp=boxqp)


def cartpole_problem_from_reference(dt: float, param, cost_weight):
    """The cart-pole problem built from the reference's parameter
    dataclasses (``CartPoleParam``, ``CartPoleCostWeight``)."""
    return make_cartpole_problem(
        dt, param=CartPoleParam(**dataclasses.asdict(param)),
        cost_weight=CartPoleCostWeight(**dataclasses.asdict(cost_weight)))


def vertical_problem_from_reference(dt: float, cost_weight,
                                    force_limits: tuple = (0.0, 30.0),
                                    with_limits: bool = True):
    """The vertical-motion problem built from the reference's
    ``VerticalCostWeight`` dataclass and the same force limits."""
    return make_vertical_problem(
        dt, cost_weight=VerticalCostWeight(**dataclasses.asdict(cost_weight)),
        force_limits=tuple(force_limits), with_limits=with_limits)


def tensors_from_numpy(device, dtype, x0s, us, ks=None, Ks=None):
    """Warm-start state as tensors on ``device``: (x0s, us), plus (ks, Ks)
    when given (e.g. the gains of a JAX ``DDPResult`` as numpy)."""
    conv = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                     device=device)
    out = (conv(x0s), conv(us))
    if ks is not None:
        out += (conv(ks), conv(Ks))
    return out


def result_to_numpy(res: DDPResult) -> dict:
    """A port result as a dict of numpy arrays (``trace`` a nested dict),
    field names as in ``DDPResult``."""
    out = {f.name: getattr(res, f.name).cpu().numpy()
           for f in dataclasses.fields(res) if f.name != "trace"}
    out["trace"] = {f.name: getattr(res.trace, f.name).cpu().numpy()
                    for f in dataclasses.fields(res.trace)}
    return out
