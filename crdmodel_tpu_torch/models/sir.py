"""Spatial SIR epidemic, three variables of which the second diffuses
(counterpart of crdmodel_tpu/models/sir.py).

    S' = -b S I
    I' =  b S I - g I  + D lap(I)
    R' =  g I

with g = 0.5 (Noble, Nature 1974); b is the transmission rate. The fused
kernels carry the same expressions in the same order (csrc/
rhs_common.cuh, crd::kinetics_n and crd::jacobian_n) and take the
operator on variable 1.
"""

from __future__ import annotations

import torch

from crdmodel_tpu_torch.models.base import ReactionModel, register_model

G_RECOVERY = 0.5


def kinetics(state, b):
    """state: (3, ...) tensor [S, I, R]; b: scalar or field broadcastable
    to S."""
    s, i = state[0], state[1]
    inf = b * s * i
    rec = G_RECOVERY * i
    return torch.stack([-inf, inf - rec, rec])


def steady_state(beta: float):
    """The disease-free equilibrium (1, 0, 0)."""
    return (1.0, 0.0, 0.0)


def jac_bound(state, b):
    """Gershgorin bound on J = [[-bI, -bS, 0], [bI, bS - g, 0], [0, g, 0]]
    (crdmodel_tpu/models/sir.py:49, copied)."""
    s, i = state[0], state[1]
    bi = torch.abs(b * i)
    bs = torch.abs(b * s)
    row1 = bi + bs
    row2 = bi + torch.abs(bs - G_RECOVERY) + G_RECOVERY
    return torch.maximum(row1, row2)


def jacobian(state, b):
    """The kinetics Jacobian at every point, (3, 3, ...):
    J = [[-bI, -bS, 0], [bI, bS - g, 0], [0, g, 0]]."""
    s, i = state[0], state[1]
    bi = b * i
    bs = b * s
    zero = torch.zeros_like(s)
    return torch.stack([torch.stack([-bi, -bs, zero]),
                        torch.stack([bi, bs - G_RECOVERY, zero]),
                        torch.stack([zero, torch.full_like(s, G_RECOVERY),
                                     zero])])


MODEL = register_model(
    ReactionModel(
        name="sir",
        nvars=3,
        var_names=("S", "I", "R"),
        kinetics=kinetics,
        steady_state=steady_state,
        diffusive_vars=(1,),
        diffusion_ratios=(1.0,),
        jac_bound=jac_bound,
        jacobian=jacobian,
    )
)
