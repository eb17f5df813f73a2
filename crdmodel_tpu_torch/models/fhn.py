"""FitzHugh–Nagumo kinetics (counterpart of crdmodel_tpu/models/fhn.py).

    u' = 3u - u^3 - v
    v' = eps (u + b),   eps = 0.36

The fused kernels carry the same expressions in the same association order
(csrc/rhs_common.cuh, crd::kinetics and crd::jacobian).
"""

from __future__ import annotations

import torch

from crdmodel_tpu_torch.models.base import ReactionModel, register_model

EPSILON = 0.36


def kinetics(state, b):
    """state: (2, ...) tensor [u, v]; b: scalar or field broadcastable to u."""
    u, v = state[0], state[1]
    du = 3.0 * u - u * u * u - v
    dv = EPSILON * (u + b)
    return torch.stack([du, dv])


def steady_state(beta: float):
    """Analytic fixed point: Us = -beta, Vs = beta^3 - 3 beta
    (reference src/FHNmodel_torus.cpp:242-244)."""
    return (-beta, beta ** 3 - 3.0 * beta)


def jac_bound(state, b):
    """Gershgorin bound on the kinetics Jacobian
    J = [[3-3u^2, -1], [eps, 0]] over the grid."""
    u = state[0]
    row1 = torch.abs(3.0 - 3.0 * u * u) + 1.0
    return torch.clamp_min(row1, EPSILON)


def jacobian(state, b):
    """The kinetics Jacobian J = [[3 - 3u^2, -1], [eps, 0]] at every
    point, (2, 2, ...); b does not enter. 3 - 3(u u) rounds as forward-mode
    AD of the kinetics does (the tangent of (u u) u is 2(u u) + u u), so the
    fused IMEX kernel's Newton iterates follow the JAX package's."""
    u = state[0]
    return torch.stack([
        torch.stack([3.0 - 3.0 * (u * u), torch.full_like(u, -1.0)]),
        torch.stack([torch.full_like(u, EPSILON), torch.zeros_like(u)])])


MODEL = register_model(
    ReactionModel(
        name="fhn",
        nvars=2,
        var_names=("u", "v"),
        kinetics=kinetics,
        steady_state=steady_state,
        jac_bound=jac_bound,
        jacobian=jacobian,
    )
)
