"""Brusselator, the Turing-pattern benchmark, both species diffusing
(counterpart of crdmodel_tpu/models/brusselator.py).

    u' = A - (b + 1) u + u^2 v
    v' = b u - u^2 v

with A = 1 and D_v = 8 D_u; b is the control parameter B. The fused
kernels carry the same expressions in the same order (csrc/
rhs_common.cuh, crd::kinetics_n and crd::jacobian_n) and multiply v's
operator by D_RATIO_V after the stencil, as the plain versions do.
"""

from __future__ import annotations

import torch

from crdmodel_tpu_torch.models.base import ReactionModel, register_model

A_FEED = 1.0
D_RATIO_V = 8.0   # D_v / D_u


def kinetics(state, b):
    """state: (2, ...) tensor [u, v]; b: scalar or field broadcastable to u."""
    u, v = state[0], state[1]
    uuv = u * u * v
    du = A_FEED - (b + 1.0) * u + uuv
    dv = b * u - uuv
    return torch.stack([du, dv])


def steady_state(beta: float):
    """The homogeneous fixed point (A, b/A)."""
    return (A_FEED, float(beta) / A_FEED)


def jac_bound(state, b):
    """Gershgorin bound on J = [[2uv - (b+1), u^2], [b - 2uv, -u^2]]
    (crdmodel_tpu/models/brusselator.py:47, copied)."""
    u, v = state[0], state[1]
    uv2 = 2.0 * torch.abs(u * v)
    uu = u * u
    row1 = torch.abs(uv2 - (b + 1.0)) + uu
    row2 = torch.abs(b - uv2) + uu
    return torch.maximum(row1, row2)


def jacobian(state, b):
    """The kinetics Jacobian at every point, (2, 2, ...):
    J = [[2uv - (b + 1), u^2], [b - 2uv, -u^2]]."""
    u, v = state[0], state[1]
    uv2 = 2.0 * (u * v)
    uu = u * u
    return torch.stack([torch.stack([uv2 - (b + 1.0), uu]),
                        torch.stack([b - uv2, -uu])])


MODEL = register_model(
    ReactionModel(
        name="brusselator",
        nvars=2,
        var_names=("u", "v"),
        kinetics=kinetics,
        steady_state=steady_state,
        diffusive_vars=(0, 1),
        diffusion_ratios=(1.0, D_RATIO_V),
        jac_bound=jac_bound,
        jacobian=jacobian,
    )
)
