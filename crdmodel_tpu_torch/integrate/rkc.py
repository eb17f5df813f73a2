"""RKC2: stabilized explicit Runge–Kutta–Chebyshev integration
(counterpart of crdmodel_tpu/integrate/rkc.py).

RKC2 (Sommeijer–Shampine–Verwer 1997) extends the real-axis stability
interval to ~0.65·s² with s first-order-cost stages, so a diffusion-CFL
limited grid steps at its accuracy-limited h with s ≈ sqrt(h·rho/0.65)
stages. The stage count is chosen per step from a spectral-radius bound
rho(t, y, params) (core/problem.py::make_rho_bound).

Fits the stepper protocol of integrate/erk.py:
  step_err(t, y, h, params, carry) -> (y_new, err_ss, carry)
with carry = f(t, y): the previous step's end derivative is the next
step's start derivative, like FSAL.

Damped recurrence (eps = 2/13):
  w0 = 1 + eps/s²,  w1 = T'_s(w0)/T''_s(w0)
  b_j = T''_j(w0)/T'_j(w0)²  (j>=2), b_0 = b_1 = b_2
  Y_0 = y,  Y_1 = Y_0 + h·mu1·F_0,  mu1 = b_1·w1
  Y_j = (1-mu_j-nu_j)·Y_0 + mu_j·Y_{j-1} + nu_j·Y_{j-2}
        + h·mut_j·F(Y_{j-1}) + h·gt_j·F_0
    mu_j = 2 b_j w0/b_{j-1}, nu_j = -b_j/b_{j-2},
    mut_j = 2 b_j w1/b_{j-1}, gt_j = -(1 - b_{j-1} T_{j-1}(w0))·mut_j
  error estimate: est = 0.8 (y - y_new) + 0.4 h (F_0 + F(y_new))   (order 2)

The JAX package loops over the stages with lax.fori_loop on a traced s.
Torch has no loop over a trip count that lives on the device, so this
torch-path stepper reads s on the host once per step: one host sync a
step that the JAX loop does not have. The recurrence scalars stay 0-d
tensors in the state's dtype, as in the JAX package. The fused kernel
(ops/fused_rkc.py) keeps s on the device and needs no such read.

Not ported yet: stage_sync, the cross-member stage-count max of the
ensemble mesh (ROADMAP queue 1, items 14-15).
"""

from __future__ import annotations

from typing import Callable

import torch

EPS_DAMP = 2.0 / 13.0
STAB_FACTOR = 0.65          # stable real interval ~ 0.653 s^2 with damping
S_MAX = 256
ERR_ORDER = 3               # est ~ O(h^3): controller exponent 1/3 (RKC code)


def _cheb_scalars(s: int, w0):
    """T_s(w0), T'_s(w0), T''_s(w0) for an integer s >= 2 and a 0-d w0."""
    tm2, tm1 = torch.ones_like(w0), w0
    dm2, dm1 = torch.zeros_like(w0), torch.ones_like(w0)
    d2m2, d2m1 = torch.zeros_like(w0), torch.zeros_like(w0)
    for _ in range(2, s + 1):
        t = 2 * w0 * tm1 - tm2
        d = 2 * w0 * dm1 - dm2 + 2 * tm1
        d2 = 2 * w0 * d2m1 - d2m2 + 4 * dm1
        tm2, tm1, dm2, dm1, d2m2, d2m1 = tm1, t, dm1, d, d2m1, d2
    return tm1, dm1, d2m1


def choose_stages(h, rho):
    """Smallest s with stability interval covering h*rho, as int32."""
    s = torch.ceil(torch.sqrt(torch.clamp_min(h * rho, 0.0) / STAB_FACTOR
                              + 1.0))
    return torch.clamp(s.to(torch.int32) + 1, 2, S_MAX)


def h_max_for(rho):
    """Largest step coverable with S_MAX stages."""
    return STAB_FACTOR * (S_MAX - 1) ** 2 / torch.clamp_min(rho, 1e-30)


def make_rkc2_step_err(rhs: Callable, rho_fn: Callable, rtol, atol,
                       stage_sync=None):
    """Returns (step_err, init_carry) with the erk stepper protocol."""
    if stage_sync is not None:
        raise NotImplementedError("stage_sync is not ported yet (ROADMAP "
                                  "queue 1, items 14-15: ensembles)")

    def init_carry(t, y, params):
        return rhs(t, y, params)

    def step_err(t, y, h, params, f0):
        dtype = y.dtype
        one = torch.ones((), dtype=dtype, device=y.device)
        rho = rho_fn(t, y, params).to(dtype)
        s_dev = choose_stages(h, rho)
        s = int(s_dev)                      # the one host read of a step
        sf = s_dev.to(dtype)
        w0 = one + EPS_DAMP / (sf * sf)
        _, dts, d2ts = _cheb_scalars(s, w0)
        w1 = dts / d2ts

        # b_0 = b_1 = b_2 = T2''/(T2')^2 with T2 = 2 w0^2 - 1 (RKC convention)
        dt2 = 4 * w0
        b2 = 4.0 / (dt2 * dt2)
        mu1 = b2 * w1
        yjm1, yjm2 = y + (h * mu1) * f0, y

        # Chebyshev and b histories at j-1, j-2: T_1, T_0, T'_1, T'_0, ...
        tjm1, tjm2 = w0, one
        djm1, djm2 = one, torch.zeros_like(w0)
        d2jm1, d2jm2 = torch.zeros_like(w0), torch.zeros_like(w0)
        bjm1, bjm2 = b2, b2
        for j in range(2, s + 1):
            tj = 2 * w0 * tjm1 - tjm2
            dj = 2 * w0 * djm1 - djm2 + 2 * tjm1
            d2j = 2 * w0 * d2jm1 - d2jm2 + 4 * djm1
            bj = d2j / (dj * dj)
            mu = 2 * bj * w0 / bjm1
            nu = -bj / bjm2
            mut = 2 * bj * w1 / bjm1
            gt = -(one - bjm1 * tjm1) * mut
            # stage time c_{j-1}: w1 T''_{j-1}/T'_{j-1} (c_1 = c_2/4, paper)
            cjm1 = (0.25 * w1 / w0 if j == 2
                    else w1 * d2jm1 / torch.clamp_min(djm1, 1e-300))
            fy = rhs(t + cjm1 * h, yjm1, params)
            yj = ((one - mu - nu) * y + mu * yjm1 + nu * yjm2
                  + (h * mut) * fy + (h * gt) * f0)
            yjm1, yjm2 = yj, yjm1
            tjm1, tjm2 = tj, tjm1
            djm1, djm2 = dj, djm1
            d2jm1, d2jm2 = d2j, d2jm1
            bjm1, bjm2 = bj, bjm1
        y_new = yjm1

        f1 = rhs(t + h, y_new, params)
        est = 0.8 * (y - y_new) + (0.4 * h) * (f0 + f1)
        scaled = est * (1.0 / (rtol * torch.abs(y) + atol))
        return y_new, torch.sum(scaled * scaled), f1

    return step_err, init_carry
