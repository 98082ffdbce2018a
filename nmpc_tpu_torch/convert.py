"""Carry configs, model parameters and solver state across from the JAX
package.

Nothing here imports ``jax`` or ``nmpc_tpu``: configs are read from any
dataclass with the same fields, arrays as numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nmpc_tpu_torch.core.types import (BoxQPConfig, DDPConfig, DDPResult,
                                        FmpcConfig, FmpcResult, FmpcVariable)
from nmpc_tpu_torch.models.bipedal import (BipedalCostWeight,
                                           example_omega2_func,
                                           example_ref_zmp_func,
                                           make_bipedal_problem)
from nmpc_tpu_torch.models.cartpole import (CartPoleCostWeight, CartPoleParam,
                                            make_cartpole_fmpc_problem,
                                            make_cartpole_problem)
from nmpc_tpu_torch.models.cartpole_cgmres import (
    make_cartpole_cgmres_problem)
from nmpc_tpu_torch.models.centroidal import (CentroidalCostWeight,
                                              make_centroidal_problem)
from nmpc_tpu_torch.models.damper import make_damper_problem
from nmpc_tpu_torch.models.oscillator import make_oscillator_problem
from nmpc_tpu_torch.models.vertical import (VerticalCostWeight,
                                            make_vertical_problem)
from nmpc_tpu_torch.solvers.cgmres import CgmresConfig, CgmresState


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


def bipedal_problem_from_reference(dt: float, end_t: float, cost_weight):
    """The bipedal CoM-ZMP problem of the reference's example: the
    footstep ZMP reference of a walk ending at ``end_t``, the squat
    omega^2 profile, and the weights of the reference's
    ``BipedalCostWeight`` dataclass."""
    return make_bipedal_problem(
        dt, example_ref_zmp_func(end_t), example_omega2_func(),
        BipedalCostWeight(**dataclasses.asdict(cost_weight)))


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


def fmpc_config_from_reference(cfg) -> FmpcConfig:
    """An ``FmpcConfig`` equal field for field to ``cfg``, any dataclass
    with ``FmpcConfig``'s fields."""
    return FmpcConfig(**dataclasses.asdict(cfg))


def oscillator_problem_from_reference(dt: float):
    """The Van der Pol FMPC problem (it has no parameters besides dt)."""
    return make_oscillator_problem(dt)


def cartpole_fmpc_problem_from_reference(dt: float, param, cost_weight,
                                         u_max: float = 15.0,
                                         x_max: float = 20.0):
    """The constrained cart-pole FMPC problem built from the reference's
    parameter dataclasses and the same bounds."""
    return make_cartpole_fmpc_problem(
        dt, param=CartPoleParam(**dataclasses.asdict(param)),
        cost_weight=CartPoleCostWeight(**dataclasses.asdict(cost_weight)),
        u_max=u_max, x_max=x_max)


def fmpc_variable_from_numpy(device, dtype, xs, us, lambdas, ss,
                             nus) -> FmpcVariable:
    """A primal-dual iterate (e.g. a JAX ``FmpcVariable``'s fields as
    numpy, batched or not) as tensors on ``device``."""
    conv = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                     device=device).contiguous()
    return FmpcVariable(xs=conv(xs), us=conv(us), lambdas=conv(lambdas),
                        ss=conv(ss), nus=conv(nus))


def fmpc_result_to_numpy(res: FmpcResult) -> dict:
    """An FMPC result as a dict of numpy arrays (``variable`` and
    ``trace`` nested dicts), field names as in ``FmpcResult``."""
    nested = ("variable", "trace")
    out = {f.name: getattr(res, f.name).cpu().numpy()
           for f in dataclasses.fields(res) if f.name not in nested}
    for name in nested:
        sub = getattr(res, name)
        out[name] = {f.name: getattr(sub, f.name).cpu().numpy()
                     for f in dataclasses.fields(sub)}
    return out


def centroidal_problem_from_reference(dt: float, cost_weight,
                                      force_limits=None):
    """The centroidal problem of the reference's example stance and CoM
    reference, with the weights of the reference's
    ``CentroidalCostWeight`` dataclass and the same force limits."""
    return make_centroidal_problem(
        dt, cost_weight=CentroidalCostWeight(**dataclasses.asdict(
            cost_weight)),
        force_limits=None if force_limits is None else tuple(force_limits))


def cgmres_config_from_reference(cfg) -> CgmresConfig:
    """A ``CgmresConfig`` equal field for field to ``cfg``, any dataclass
    with ``CgmresConfig``'s fields."""
    return CgmresConfig(**dataclasses.asdict(cfg))


def damper_problem_from_reference(analytic: bool = False):
    """The semiactive damper (it has no parameters), with the analytic
    costate and dH/du or autodiff ones as the reference's was built."""
    return make_damper_problem(analytic=analytic)


def cartpole_cgmres_problem_from_reference(with_input_bound: bool = False):
    """The C/GMRES cart-pole, with or without the dummy-input force
    bound (its parameters are the reference's constants)."""
    return make_cartpole_cgmres_problem(with_input_bound=with_input_bound)


def cgmres_state_from_numpy(device, dtype, u_list, delta_u_vec, u,
                            err) -> CgmresState:
    """A C/GMRES state (e.g. a JAX ``CgmresState``'s fields as numpy,
    batched or not) as tensors on ``device``; ``delta_u_vec`` keeps its
    row-major (N, dim_uc) layout."""
    conv = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                     device=device).contiguous()
    return CgmresState(u_list=conv(u_list), delta_u_vec=conv(delta_u_vec),
                       u=conv(u), err=conv(err))


def cgmres_state_to_numpy(state: CgmresState) -> dict:
    """A C/GMRES state as a dict of numpy arrays, field names as in
    ``CgmresState``."""
    return {name: getattr(state, name).cpu().numpy()
            for name in CgmresState._fields}
