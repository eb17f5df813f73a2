"""Reaction-model registry (counterpart of crdmodel_tpu/models/base.py).

A model is data: pure functions (kinetics, steady_state, and the
port-only closed-form jacobian) registered by name. Kinetics take no time argument (the JAX package's
AUTONOMY CONTRACT, crdmodel_tpu/models/base.py:17-27): the fused step
kernel evaluates them without stage times.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

# kinetics(state, b) -> dstate, state/dstate (nvars, ...) tensors, b the
# scalar or field bifurcation parameter
KineticsFn = Callable[..., object]
# steady_state(beta) -> tuple of nvars floats
SteadyStateFn = Callable[[float], Tuple[float, ...]]


@dataclasses.dataclass(frozen=True)
class ReactionModel:
    name: str
    nvars: int
    var_names: Tuple[str, ...]
    kinetics: KineticsFn
    steady_state: SteadyStateFn
    # which variables diffuse, and their diffusion coefficient as a multiple
    # of cfg.diffusion
    diffusive_vars: Tuple[int, ...] = (0,)
    diffusion_ratios: Tuple[float, ...] = (1.0,)
    # jac_bound(state, b) -> pointwise Gershgorin bound on the kinetics
    # Jacobian's spectral radius (RKC2's rho, core/problem.py::make_rho_bound)
    jac_bound: Callable = None
    # jacobian(state, b) -> (nvars, nvars, ...) the kinetics Jacobian in
    # closed form at every point. Port-only: the JAX package differentiates
    # the kinetics (integrate/imex.py::pointwise_jacobian), and CUDA has no
    # autodiff, so the fused IMEX kernel (csrc/fused_imex.cu) evaluates
    # these expressions and its plain version (ops/fused_imex.py) calls this
    jacobian: Callable = None


_REGISTRY: Dict[str, ReactionModel] = {}


def register_model(model: ReactionModel) -> ReactionModel:
    _REGISTRY[model.name] = model
    return model


def get_model(name: str) -> ReactionModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
