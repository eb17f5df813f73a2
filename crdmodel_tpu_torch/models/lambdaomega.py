"""Lambda–omega (real Ginzburg–Landau) kinetics, both species diffusing
at the same coefficient (counterpart of crdmodel_tpu/models/
lambdaomega.py).

    u' = (1 - r^2) u + b r^2 v        r^2 = u^2 + v^2
    v' = -b r^2 u + (1 - r^2) v

b is the frequency twist. The fused kernels carry the same expressions in
the same order (csrc/rhs_common.cuh, crd::kinetics_n and
crd::jacobian_n).
"""

from __future__ import annotations

import torch

from crdmodel_tpu_torch.models.base import ReactionModel, register_model


def kinetics(state, b):
    """state: (2, ...) tensor [u, v]; b: scalar or field broadcastable to u."""
    u, v = state[0], state[1]
    r2 = u * u + v * v
    du = (1.0 - r2) * u + b * r2 * v
    dv = -b * r2 * u + (1.0 - r2) * v
    return torch.stack([du, dv])


def steady_state(beta: float):
    """(1, 0), a point on the homogeneous limit cycle r = 1."""
    return (1.0, 0.0)


def jac_bound(state, b):
    """Gershgorin row bound 1 + (2(1 + |b|) + sqrt(2 + 2 b^2)) r^2
    (crdmodel_tpu/models/lambdaomega.py:46, copied)."""
    u, v = state[0], state[1]
    r2 = u * u + v * v
    b = torch.as_tensor(b, dtype=u.dtype, device=u.device)
    coef = 2.0 * (1.0 + torch.abs(b)) + torch.sqrt(2.0 + 2.0 * b * b)
    return 1.0 + coef * r2


def jacobian(state, b):
    """The kinetics Jacobian at every point, (2, 2, ...), with
    m = 1 - r^2, tu = 2u, tv = 2v:

      J = [[m - tu u + b tu v,       -(tv u) + b (r^2 + tv v)],
           [-b (r^2 + tu u) - tu v,  -b tv u + m - tv v]]"""
    u, v = state[0], state[1]
    r2 = u * u + v * v
    m = 1.0 - r2
    tu = 2.0 * u
    tv = 2.0 * v
    return torch.stack([
        torch.stack([m - tu * u + b * tu * v, -(tv * u) + b * (r2 + tv * v)]),
        torch.stack([-b * (r2 + tu * u) - tu * v, -b * tv * u + m - tv * v])])


MODEL = register_model(
    ReactionModel(
        name="lambdaomega",
        nvars=2,
        var_names=("u", "v"),
        kinetics=kinetics,
        steady_state=steady_state,
        diffusive_vars=(0, 1),
        diffusion_ratios=(1.0, 1.0),
        jac_bound=jac_bound,
        jacobian=jacobian,
    )
)
