"""Goldbeter minimal Ca2+ oscillation model, cytosolic Z and store Y
(counterpart of crdmodel_tpu/models/goldbeter.py).

    v2 = VM2 Z^2 / (K2^2 + Z^2)
    v3 = VM3 Y^2 Z^4 / ((KR^2 + Y^2)(KA^4 + Z^4))
    Z' = v0 + v1 b - v2 + v3 + kf Y - k Z
    Y' = v2 - v3 - kf Y

The expressions keep the JAX package's association order, and its
constants fold in Python double before they meet a tensor (KA**4 is
Python's pow(0.9, 4), the double nearest 0.6561, one ulp below
0.9*0.9*0.9*0.9), so both packages round alike. The fused kernels
carry the same expressions in the same order (csrc/rhs_common.cuh,
crd::kinetics and crd::jacobian).
"""

from __future__ import annotations

import numpy as np
import torch

from crdmodel_tpu_torch.models.base import ReactionModel, register_model

V0 = 1.0
K = 10.0
KF = 1.0
V1 = 7.3
VM2 = 65.0
VM3 = 500.0
K2 = 1.0
KR = 2.0
KA = 0.9
M = 2.0
N = 2.0
P = 4.0

# Oscillatory window noted in the reference config
# (crdmodel_tpu/models/goldbeter.py:113-117)
OSC_BETA_MIN = 0.289
OSC_BETA_MAX = 0.774


def _v2(Z):
    Zn = Z * Z
    return VM2 * Zn / (K2 * K2 + Zn)


def _v3(Z, Y):
    Ym = Y * Y
    Z2 = Z * Z
    Zp = Z2 * Z2
    return VM3 * Ym * Zp / ((KR * KR + Ym) * (KA ** 4 + Zp))


def kinetics(state, b):
    """state: (2, ...) tensor [Z, Y]; b: scalar or field broadcastable to Z."""
    Z, Y = state[0], state[1]
    v2 = _v2(Z)
    v3 = _v3(Z, Y)
    dZ = V0 + V1 * b - v2 + v3 + KF * Y - K * Z
    dY = v2 - v3 - KF * Y
    return torch.stack([dZ, dY])


def steady_state(beta: float):
    """Exact fixed point: Zs = (v0 + v1*beta)/k and the root in Y of
    g(Y) = v2(Zs) - v3(Zs, Y) - kf*Y by bisection, in float64 numpy
    (crdmodel_tpu/models/goldbeter.py:77, copied)."""
    Zs = (V0 + V1 * float(beta)) / K
    v2s = float(_np_v2(Zs))

    def g(Y):
        return v2s - _np_v3(Zs, Y) - KF * Y

    lo, hi = 0.0, max(v2s / KF, 1e-12)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if g(mid) > 0.0:
            lo = mid
        else:
            hi = mid
    Ys = 0.5 * (lo + hi)
    return (Zs, Ys)


def _np_v2(Z):
    Zn = np.float64(Z) ** N
    return VM2 * Zn / (K2 ** N + Zn)


def _np_v3(Z, Y):
    Ym = np.float64(Y) ** M
    Zp = np.float64(Z) ** P
    return VM3 * Ym * Zp / ((KR ** M + Ym) * (KA ** P + Zp))


def jac_bound(state, b):
    """Gershgorin bound on the kinetics Jacobian over the grid
    (crdmodel_tpu/models/goldbeter.py:120)."""
    Z, Y = state[0], state[1]
    Z2 = Z * Z
    Z4 = Z2 * Z2
    Y2 = Y * Y
    dv2 = 2.0 * VM2 * (K2 * K2) * Z / (K2 * K2 + Z2) ** 2
    gY = Y2 / (KR * KR + Y2)
    gZ = Z4 / (KA ** 4 + Z4)
    dv3_dZ = 4.0 * VM3 * gY * (KA ** 4) * Z * Z2 / (KA ** 4 + Z4) ** 2
    dv3_dY = 2.0 * VM3 * gZ * (KR * KR) * Y / (KR * KR + Y2) ** 2
    row1 = torch.abs(-dv2 + dv3_dZ - K) + torch.abs(dv3_dY + KF)
    row2 = torch.abs(dv2 - dv3_dZ) + torch.abs(dv3_dY + KF)
    return torch.maximum(row1, row2)


def jacobian(state, b):
    """The kinetics Jacobian at every point, (2, 2, ...):

      dv2/dZ = 2 VM2 K2^2 Z / (K2^2+Z^2)^2
      dv3/dZ = 4 VM3 gY KA^4 Z^3 / (KA^4+Z^4)^2,  gY = Y^2/(KR^2+Y^2)
      dv3/dY = 2 VM3 gZ KR^2 Y / (KR^2+Y^2)^2,    gZ = Z^4/(KA^4+Z^4)
      J = [[-dv2/dZ + dv3/dZ - k,  dv3/dY + kf],
           [ dv2/dZ - dv3/dZ,     -dv3/dY - kf]]

    b does not enter. The squares are products, so the fused kernels'
    device function rounds alike."""
    Z, Y = state[0], state[1]
    Z2 = Z * Z
    Z4 = Z2 * Z2
    Y2 = Y * Y
    dz = K2 * K2 + Z2
    dv2 = 2.0 * VM2 * (K2 * K2) * Z / (dz * dz)
    gY = Y2 / (KR * KR + Y2)
    gZ = Z4 / (KA ** 4 + Z4)
    ez = KA ** 4 + Z4
    dv3_dZ = 4.0 * VM3 * gY * (KA ** 4) * Z * Z2 / (ez * ez)
    ey = KR * KR + Y2
    dv3_dY = 2.0 * VM3 * gZ * (KR * KR) * Y / (ey * ey)
    return torch.stack([
        torch.stack([-dv2 + dv3_dZ - K, dv3_dY + KF]),
        torch.stack([dv2 - dv3_dZ, -dv3_dY - KF])])


MODEL = register_model(
    ReactionModel(
        name="goldbeter",
        nvars=2,
        var_names=("Z", "Y"),
        kinetics=kinetics,
        steady_state=steady_state,
        jac_bound=jac_bound,
        jacobian=jacobian,
    )
)
