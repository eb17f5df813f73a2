"""Barkley excitable-media kinetics (counterpart of
crdmodel_tpu/models/barkley.py).

    u' = (1/eps) u (1 - u) (u - (v + b)/a)
    v' = u - v

with a = 0.75, eps = 0.02 (Barkley, Physica D 1991); b is the
excitability threshold, and only u diffuses. The kinetics divide (v + b)
by a as a product with 1/a folded in double: PyTorch's CUDA division by
a scalar multiplies by a reciprocal of its own, so the quotient would
round apart on the card and on the CPU, while the product rounds alike on
both and in the fused kernels (csrc/rhs_common.cuh, crd::kinetics_n and
crd::jacobian_n), which carry the same expressions in the same order.
"""

from __future__ import annotations

import torch

from crdmodel_tpu_torch.models.base import ReactionModel, register_model

A = 0.75
EPS = 0.02
INV_EPS = 1.0 / EPS
INV_A = 1.0 / A


def kinetics(state, b):
    """state: (2, ...) tensor [u, v]; b: scalar or field broadcastable to u."""
    u, v = state[0], state[1]
    du = INV_EPS * u * (1.0 - u) * (u - (v + b) * INV_A)
    dv = u - v
    return torch.stack([du, dv])


def steady_state(beta: float):
    """The rest state (0, 0), globally attracting for b > 0."""
    return (0.0, 0.0)


def jac_bound(state, b):
    """Gershgorin bound on J = [[g_u, g_v], [1, -1]]
    (crdmodel_tpu/models/barkley.py:43, copied)."""
    u, v = state[0], state[1]
    thr = (v + b) / A
    g_u = (1.0 / EPS) * ((1.0 - 2.0 * u) * (u - thr) + u * (1.0 - u))
    g_v = (1.0 / EPS) * u * (1.0 - u) / A
    row1 = torch.abs(g_u) + torch.abs(g_v)
    return torch.clamp_min(row1, 2.0)


def jacobian(state, b):
    """The kinetics Jacobian at every point, (2, 2, ...), thr = (v + b)/a:

      g_u = (1/eps) [ (1 - 2u)(u - thr) + u (1 - u) ]
      g_v = -(1/eps) u (1 - u) / a
      J = [[g_u, g_v], [1, -1]]"""
    u, v = state[0], state[1]
    thr = (v + b) * INV_A
    g_u = INV_EPS * ((1.0 - 2.0 * u) * (u - thr) + u * (1.0 - u))
    g_v = -(INV_EPS * u * (1.0 - u) * INV_A)
    return torch.stack([
        torch.stack([g_u, g_v]),
        torch.stack([torch.ones_like(u), torch.full_like(u, -1.0)])])


MODEL = register_model(
    ReactionModel(
        name="barkley",
        nvars=2,
        var_names=("u", "v"),
        kinetics=kinetics,
        steady_state=steady_state,
        jac_bound=jac_bound,
        jacobian=jacobian,
    )
)
