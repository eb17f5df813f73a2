"""Oregonator, the Tyson–Fife reduction of the Belousov–Zhabotinsky
reaction (counterpart of crdmodel_tpu/models/oregonator.py).

    u' = (1/eps) ( u (1 - u) - f v (u - q)/(u + q) )
    v' = u - v

with eps = 0.04, q = 0.002; b is the stoichiometric factor f, and only u
diffuses. The expressions keep the JAX package's association order; the
fused kernels carry the same expressions in the same order
(csrc/rhs_common.cuh, crd::kinetics_n and crd::jacobian_n).
"""

from __future__ import annotations

import math

import torch

from crdmodel_tpu_torch.models.base import ReactionModel, register_model

EPS = 0.04
Q = 0.002
INV_EPS = 1.0 / EPS


def kinetics(state, b):
    """state: (2, ...) tensor [u, v]; b: scalar or field broadcastable to u."""
    u, v = state[0], state[1]
    du = INV_EPS * (u * (1.0 - u) - b * v * (u - Q) / (u + Q))
    dv = u - v
    return torch.stack([du, dv])


def steady_state(beta: float):
    """The excitable rest state (us, us), us the positive root of
    u^2 + (f + q - 1) u - q (1 + f) = 0
    (crdmodel_tpu/models/oregonator.py:44, copied)."""
    f = float(beta)
    bcoef = f + Q - 1.0
    us = 0.5 * (-bcoef + math.sqrt(bcoef * bcoef + 4.0 * Q * (1.0 + f)))
    return (us, us)


def jac_bound(state, b):
    """Gershgorin bound on the kinetics Jacobian
    (crdmodel_tpu/models/oregonator.py:55, copied)."""
    u, v = state[0], state[1]
    upq = u + Q
    j11 = (1.0 / EPS) * (1.0 - 2.0 * u - b * v * 2.0 * Q / (upq * upq))
    j12 = (1.0 / EPS) * b * torch.abs(u - Q) / torch.abs(upq)
    row1 = torch.abs(j11) + j12
    return torch.clamp_min(row1, 2.0)


def jacobian(state, b):
    """The kinetics Jacobian at every point, (2, 2, ...):

      J11 = (1/eps) (1 - 2u - f v 2q / (u + q)^2)
      J12 = -(1/eps) f (u - q) / (u + q)
      J = [[J11, J12], [1, -1]]"""
    u, v = state[0], state[1]
    upq = u + Q
    j11 = INV_EPS * (1.0 - 2.0 * u - b * v * 2.0 * Q / (upq * upq))
    j12 = -(INV_EPS * (b * (u - Q) / upq))
    return torch.stack([
        torch.stack([j11, j12]),
        torch.stack([torch.ones_like(u), torch.full_like(u, -1.0)])])


MODEL = register_model(
    ReactionModel(
        name="oregonator",
        nvars=2,
        var_names=("u", "v"),
        kinetics=kinetics,
        steady_state=steady_state,
        jac_bound=jac_bound,
        jacobian=jacobian,
    )
)
