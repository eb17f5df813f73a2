"""Aliev–Panfilov cardiac action-potential kinetics (counterpart of
crdmodel_tpu/models/aliev_panfilov.py).

    u' = k u (1 - u) (u - a) - u v
    v' = eps(u, v) * ( -v - k u (u - a - 1) )
    eps(u, v) = eps0 + mu1 v / (u + mu2)

with k=8, eps0=0.002, mu1=0.2, mu2=0.3 (Aliev & Panfilov 1996). The
bifurcation parameter b is the excitation threshold a; only u diffuses.
The expressions keep the JAX package's association order, and the fused
kernels carry the same expressions in the same order (csrc/rhs_common.cuh,
crd::kinetics and crd::jacobian).
"""

from __future__ import annotations

import torch

from crdmodel_tpu_torch.models.base import ReactionModel, register_model

K = 8.0
EPS0 = 0.002
MU1 = 0.2
MU2 = 0.3


def kinetics(state, b):
    """state: (2, ...) tensor [u, v]; b: scalar or field broadcastable to u."""
    u, v = state[0], state[1]
    eps = EPS0 + MU1 * v / (u + MU2)
    du = K * u * (1.0 - u) * (u - b) - u * v
    dv = eps * (-v - K * u * (u - b - 1.0))
    return torch.stack([du, dv])


def steady_state(beta: float):
    """The rest state (0, 0), the attracting background for 0 < a < 1."""
    return (0.0, 0.0)


def jac_bound(state, b):
    """Pointwise Gershgorin bound on the kinetics Jacobian, with u + mu2
    floored away from 0 (crdmodel_tpu/models/aliev_panfilov.py:53)."""
    u, v = state[0], state[1]
    d = torch.clamp_min(torch.abs(u + MU2), 0.05)
    eps = EPS0 + MU1 * v / d
    w = -v - K * u * (u - b - 1.0)
    f_u = K * ((1.0 - u) * (u - b) + u * ((1.0 - u) - (u - b))) - v
    f_v = u
    g_u = eps * (-K) * (2.0 * u - b - 1.0) - (MU1 * v / (d * d)) * w
    g_v = -eps + (MU1 / d) * w
    row1 = torch.abs(f_u) + torch.abs(f_v)
    row2 = torch.abs(g_u) + torch.abs(g_v)
    return torch.maximum(row1, row2)


def jacobian(state, b):
    """The kinetics Jacobian at every point, (2, 2, ...), with
    w = -v - k u (u - a - 1) and d = u + mu2 (not floored):

      f_u = k [ (1-u)(u-a) + u((1-u) - (u-a)) ] - v
      f_v = -u
      g_u = eps (-k (2u - a - 1)) - (mu1 v / d^2) w
      g_v = -eps + mu1 w / d

    Unlike FitzHugh–Nagumo's and Goldbeter's, it depends on b (= a)."""
    u, v = state[0], state[1]
    d = u + MU2
    eps = EPS0 + MU1 * v / d
    w = -v - K * u * (u - b - 1.0)
    f_u = K * ((1.0 - u) * (u - b) + u * ((1.0 - u) - (u - b))) - v
    f_v = -u
    g_u = eps * (-K) * (2.0 * u - b - 1.0) - (MU1 * v / (d * d)) * w
    # MU1 * w / d, not (MU1 / d) * w: torch computes a scalar over a tensor
    # as reciprocal times scalar, two roundings the device function avoids
    g_v = -eps + MU1 * w / d
    return torch.stack([torch.stack([f_u, f_v]), torch.stack([g_u, g_v])])


MODEL = register_model(
    ReactionModel(
        name="aliev_panfilov",
        nvars=2,
        var_names=("u", "v"),
        kinetics=kinetics,
        steady_state=steady_state,
        jac_bound=jac_bound,
        jacobian=jacobian,
    )
)
