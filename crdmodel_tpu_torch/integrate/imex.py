"""IMEX additive Runge–Kutta, implicit pointwise reaction and explicit
diffusion (counterpart of crdmodel_tpu/integrate/imex.py).

  y' = f_E(y) + f_I(y),   f_E = diffusion, treated explicitly
                          f_I = reaction (pointwise, stiff), treated
                                implicitly

f_I is pointwise, so each implicit stage is nx*ny independent nvars x nvars
nonlinear systems, solved by full Newton with a closed-form per-point
linear solve (Cramer for nvars <= 3).

Scheme: ARK3(2)4L[2]SA (Kennedy & Carpenter 2003), ARKode's default
3rd-order IMEX pair: 4 stages, ESDIRK implicit part, L-stable, embedded
2nd-order weights shared by both tables.

Stepper protocol (shared with erk and rkc): step_err(t, y, h, params,
carry) -> (y_new, err_ss, carry). err_ss adds the last Newton update's
scaled square sum weighted by (1/NEWTON_TOL)^2, so a step whose Newton
iteration has not converged fails the accept test and is retried with a
smaller h.

On this torch path the per-point Jacobian comes from forward-mode AD
(torch.func.jvp), as the JAX package's XLA path takes it from jax.jvp. The
fused kernel K3 (ops/fused_imex.py) evaluates the models' closed-form
Jacobians instead (models/base.py, ReactionModel.jacobian).
"""

from __future__ import annotations

from fractions import Fraction as _F
from typing import Callable

import numpy as np
import torch

from crdmodel_tpu_torch.parallel.shards import Shards

ERR_ORDER = 3          # local error estimate ~ O(h^3): controller exponent 1/3
NEWTON_ITERS = 3       # Newton iterations per implicit stage
NEWTON_TOL = 0.1       # required WRMS size of the last Newton update

# --- ARK3(2)4L[2]SA coefficients (exact rationals -> float64) ---------------
_G = _F(1767732205903, 4055673282236)          # gamma (diagonal of the DIRK)

_C = [_F(0), 2 * _G, _F(3, 5), _F(1)]

_AE = [
    [_F(0)] * 4,
    [2 * _G, _F(0), _F(0), _F(0)],
    [_F(5535828885825, 10492691773637), _F(788022342437, 10882634858940),
     _F(0), _F(0)],
    [_F(6485989280629, 16251701735622), _F(-4246266847089, 9704473918619),
     _F(10755448449292, 10357097424841), _F(0)],
]

_AI = [
    [_F(0)] * 4,
    [_G, _G, _F(0), _F(0)],
    [_F(2746238789719, 10658868560708), _F(-640167445237, 6845629431997),
     _G, _F(0)],
    [_F(1471266399579, 7840856788654), _F(-4482444167858, 7529755066697),
     _F(11266239266428, 11593286722821), _G],
]

# shared propagating weights (= last DIRK row: stiffly accurate) and the
# embedded 2nd-order weights, shared by both tables
_B = [_F(1471266399579, 7840856788654), _F(-4482444167858, 7529755066697),
      _F(11266239266428, 11593286722821), _G]
_BHAT = [_F(2756255671327, 12835298489170),
         _F(-10771552573575, 22201958757719),
         _F(9247589265047, 10645013368117),
         _F(2193209047091, 5459859503100)]

STAGES = 4
GAMMA = float(_G)
C = [float(x) for x in _C]
AE = [[float(x) for x in row] for row in _AE]
AI = [[float(x) for x in row] for row in _AI]
B = [float(x) for x in _B]
D = [float(b - bh) for b, bh in zip(_B, _BHAT)]   # error weights b - bhat


def tableau_arrays():
    """float64 (AE, AI, b, bhat, c)."""
    return (np.array(AE), np.array(AI), np.array(B),
            np.array([float(x) for x in _BHAT]), np.array(C))


def _one_hots(y):
    """(nvars, *y.shape): tangent b is 1 on variable b, 0 elsewhere."""
    nvars = y.shape[0]
    tangents = torch.zeros((nvars,) + tuple(y.shape), dtype=y.dtype,
                           device=y.device)
    for b in range(nvars):
        tangents[b, b] = 1.0
    return tangents


def pointwise_jacobian(f, t, y, params):
    """Jacobian of a POINTWISE vector field f(t, y, params) with respect to
    the leading (variable) axis of y, shape (nvars_out, nvars_in, *space):
    one forward-mode product (torch.func.jvp) per variable, with a one-hot
    tangent along axis 0, so column b of every per-point Jacobian comes out
    as a field. The products run as one torch.func.vmap over the tangents,
    which halves the per-op overhead of forward-mode AD and rounds as the
    products one by one do. A sharded state (parallel/shards.py::Shards, a
    pytree of its blocks) gives a Shards of its blocks' Jacobians."""
    tangents = (y.map(_one_hots) if isinstance(y, Shards)
                else _one_hots(y))

    def column(e):
        return torch.func.jvp(lambda s: f(t, s, params), (y,), (e,))[1]

    return torch.transpose(torch.func.vmap(column)(tangents), 0, 1)


def solve_pointwise(m, r):
    """Solve m @ x = r at every spatial point: m (n, n, *space),
    r (n, *space). Cramer for n <= 3; torch.linalg.solve above."""
    n = r.shape[0]
    if n == 1:
        return r / m[0, 0]
    if n == 2:
        det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
        x0 = (m[1, 1] * r[0] - m[0, 1] * r[1]) / det
        x1 = (m[0, 0] * r[1] - m[1, 0] * r[0]) / det
        return torch.stack([x0, x1])
    if n == 3:
        c00 = m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]
        c01 = m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]
        c02 = m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]
        det = m[0, 0] * c00 + m[0, 1] * c01 + m[0, 2] * c02
        c10 = m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]
        c11 = m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]
        c12 = m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]
        c20 = m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]
        c21 = m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]
        c22 = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
        x0 = (c00 * r[0] + c10 * r[1] + c20 * r[2]) / det
        x1 = (c01 * r[0] + c11 * r[1] + c21 * r[2]) / det
        x2 = (c02 * r[0] + c12 * r[1] + c22 * r[2]) / det
        return torch.stack([x0, x1, x2])
    mb = torch.movedim(m, (0, 1), (-2, -1))
    rb = torch.movedim(r, 0, -1)[..., None]
    xb = torch.linalg.solve(mb, rb)[..., 0]
    return torch.movedim(xb, -1, 0)


def _per_block(fn, x, *others):
    """fn(x, *others) on a tensor; on a Shards, fn on each block (with each
    other Shards' block i): the sharded state's Newton stays shard-local."""
    return x.map(fn, *others) if isinstance(x, Shards) else fn(x, *others)


def _eye(y):
    """The (nvars, nvars, 1, ...) identity broadcasting over y's points."""
    nvars = y.shape[0]
    return torch.eye(nvars, dtype=y.dtype, device=y.device).reshape(
        (nvars, nvars) + (1,) * (y.dim() - 1))


def _zero(y):
    """A 0-d zero in y's dtype on its device."""
    return torch.zeros((), dtype=y.dtype, device=y.device)


def make_imex_step_err(f_ex: Callable, f_im: Callable, rtol, atol):
    """(step_err, init_carry) with the framework stepper protocol
    (crdmodel_tpu/integrate/imex.py:157, with its defaults: full Newton,
    NEWTON_ITERS iterations; no caller sets either).

    f_ex(t, y, params): the explicit part (diffusion). f_im(t, y, params):
    the implicit part, POINTWISE in space (the reaction). Each implicit
    stage solves Y = rhs_known + h*gamma*f_im(t_i, Y) by NEWTON_ITERS
    Newton iterations, with the per-point Jacobian re-evaluated every
    iteration. The stage slope is recovered as
    k_I = (Y - rhs_known)/(h*gamma).

    y may be a sharded state (parallel/shards.py::Shards): the Newton
    solve, being pointwise, runs block by block with no exchange, and
    err_ss, Newton term included, stays a Shards of per-shard sums for the
    adaptive loop's reduce_fn (crdmodel_tpu/ops/pallas_shard_imex.py's
    shard-local Newton on the XLA path).
    """

    def init_carry(t, y, params):
        return ()

    def step_err(t, y, h, params, carry):
        w = 1.0 / (rtol * torch.abs(y) + atol)
        hg = h * GAMMA
        eye = _per_block(_eye, y)

        kE = [f_ex(t, y, params)]
        kI = [f_im(t, y, params)]
        delta_ss = _per_block(_zero, y)

        for i in range(1, STAGES):
            rhs_known = y
            for j in range(i):
                if AE[i][j] != 0.0:
                    rhs_known = rhs_known + (h * AE[i][j]) * kE[j]
                if AI[i][j] != 0.0:
                    rhs_known = rhs_known + (h * AI[i][j]) * kI[j]
            ti = t + C[i] * h

            yi = rhs_known + hg * kI[i - 1]        # stage predictor
            dy = torch.zeros_like(y)
            for _ in range(NEWTON_ITERS):
                m = eye - hg * pointwise_jacobian(f_im, ti, yi, params)
                resid = yi - hg * f_im(ti, yi, params) - rhs_known
                dy = _per_block(solve_pointwise, m, -resid)
                yi = yi + dy
            # convergence contribution: last update in the error-test metric
            scaled_dy = dy * w
            delta_ss = delta_ss + torch.sum(scaled_dy * scaled_dy)

            kE.append(f_ex(ti, yi, params))
            kI.append((yi - rhs_known) / hg)

        y_new = y
        err = torch.zeros_like(y)
        for j in range(STAGES):
            k_sum = kE[j] + kI[j]
            if B[j] != 0.0:
                y_new = y_new + (h * B[j]) * k_sum
            if D[j] != 0.0:
                err = err + (h * D[j]) * k_sum
        scaled = err * w
        err_ss = (torch.sum(scaled * scaled)
                  + (1.0 / NEWTON_TOL) ** 2 * delta_ss)
        return y_new, err_ss, ()

    return step_err, init_carry
