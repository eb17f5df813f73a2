"""Gray–Scott kinetics, both species diffusing (counterpart of
crdmodel_tpu/models/grayscott.py).

    u' = -u v^2 + F (1 - u)          D_u = cfg.diffusion
    v' =  u v^2 - (F + k) v          D_v = D_u / 2

with k = 0.062 (Pearson, Science 1993); b is the feed rate F. The fused
kernels carry the same expressions in the same order (csrc/
rhs_common.cuh, crd::kinetics_n and crd::jacobian_n) and multiply v's
operator by its ratio after the stencil, as the plain versions do.
"""

from __future__ import annotations

import torch

from crdmodel_tpu_torch.models.base import ReactionModel, register_model

K_REMOVAL = 0.062


def kinetics(state, b):
    """state: (2, ...) tensor [u, v]; b: scalar or field broadcastable to u."""
    u, v = state[0], state[1]
    uvv = u * v * v
    du = -uvv + b * (1.0 - u)
    dv = uvv - (b + K_REMOVAL) * v
    return torch.stack([du, dv])


def steady_state(beta: float):
    """The trivial state (1, 0); patterns grow from seeded spots."""
    return (1.0, 0.0)


def jac_bound(state, b):
    """Gershgorin bound on J = [[-v^2 - F, -2uv], [v^2, 2uv - (F+k)]]
    (crdmodel_tpu/models/grayscott.py:37, copied)."""
    u, v = state[0], state[1]
    v2 = v * v
    uv2 = 2.0 * torch.abs(u * v)
    row1 = v2 + b + uv2
    row2 = v2 + uv2 + b + K_REMOVAL
    return torch.maximum(row1, row2)


def jacobian(state, b):
    """The kinetics Jacobian at every point, (2, 2, ...):
    J = [[-v^2 - F, -2uv], [v^2, 2uv - (F + k)]]."""
    u, v = state[0], state[1]
    vv = v * v
    uv2 = 2.0 * (u * v)
    return torch.stack([torch.stack([-vv - b, -uv2]),
                        torch.stack([vv, uv2 - (b + K_REMOVAL)])])


MODEL = register_model(
    ReactionModel(
        name="grayscott",
        nvars=2,
        var_names=("u", "v"),
        kinetics=kinetics,
        steady_state=steady_state,
        diffusive_vars=(0, 1),
        diffusion_ratios=(1.0, 0.5),
        jac_bound=jac_bound,
        jacobian=jacobian,
    )
)
