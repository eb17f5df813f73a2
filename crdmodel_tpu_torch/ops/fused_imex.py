"""Fused IMEX ARK3(2)4L[2]SA step, kernel K3 (counterpart of
crdmodel_tpu/ops/pallas_imex.py).

One launch performs a whole additive Runge–Kutta step of integrate/imex.py
on the (2, ny, nx) state: the 4 explicit profile-stencil evaluations, the 3
implicit stages solved at every point by 3 full Newton iterations, the
solution and error assembly, and per-block partial sums of the squared
WRMS-scaled error plus (1/NEWTON_TOL)^2 times the squared scaled last
Newton updates (csrc/fused_imex.cu). It takes every attempted step of an
ark324 run on the fused path (sim.py).

  fused_imex_step            the wrapper: launches the CUDA kernel for a
                             CUDA tensor, runs fused_imex_step_reference
                             for a CPU tensor
  fused_imex_step_reference  the same step in plain torch, the kernel's
                             oracle
  build_fused_imex_step      a problem's step_err(t, y, h, params) on top
                             of it

Semantics kept from the TPU kernel (pallas_imex.py:89-152, which mirrors
imex.make_imex_step_err line by line): the stage predictor
Y = rhs_known + (h gamma) kI_{i-1}; full Newton with the Jacobian
re-evaluated every iteration; kI_i = (Y_i - rhs_known_i)/(h gamma); the
update and error weights (h B_j) and (h D_j) on kE_j + kI_j in j order; the
row freeze multiplies every part by live = 1 - fz*(1 - m); no stage times
(the kinetics are autonomous); the error weights come from the step's
start. One port-only difference: the Jacobian is the model's closed form
(ReactionModel.jacobian), where the JAX kernel differentiates the kinetics
with jax.jvp inside the kernel, so the two agree to rounding, not bitwise.
The TPU's lane padding and 8-row halo are gone: the state is (nvars, ny,
nx), contiguous, and a tile carries the 4 rings its 4 stencils consume.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from crdmodel_tpu_torch.integrate import imex
from crdmodel_tpu_torch.ops.kernel_common import (SMEM_BYTES,
                                                  KernelConstants,
                                                  check_constants,
                                                  check_tensor,
                                                  freeze_scalar,
                                                  fused_forcing,
                                                  kernel_ready_kinetics,
                                                  make_split_block,
                                                  needs_divform,
                                                  prepare_constants)

HALO = 4                       # one ring per explicit stencil evaluation
N_ARRAYS = 14                  # the kernel's shared arrays (fused_imex.cu)
TILE = 32                      # square tiles: f32 and f64 both fit at 32x32


def is_imex_supported(problem, dtype) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_imex.py:60) without the
    TPU strip-divisor rule, plus the port-only kinetics rule
    (kernel_common.kernel_ready_kinetics). Any forcing declines: the port
    has none yet (ROADMAP queue 1, item 9). Divergence-form problems
    decline, as in the JAX package, and take the torch path, as do
    problems with a diffusion tensor (crdmodel_tpu/sim.py:240-251)."""
    if needs_divform(problem) or problem.diffusion_tensor is not None:
        return False
    if fused_forcing(problem) is not None:
        return False
    if dtype != torch.float32:
        return False
    return kernel_ready_kinetics(problem)


def tile_plan(itemsize: int):
    """(tile_x, tile_y, shared bytes) of the kernel's TILE x TILE tiles:
    N_ARRAYS region arrays with a HALO-ring border (179,200 B in f64)."""
    smem = N_ARRAYS * (TILE + 2 * HALO) ** 2 * itemsize
    if smem > SMEM_BYTES - 1024:            # room for the static reduction
        raise ValueError("the IMEX tile does not fit in shared memory")
    return TILE, TILE, smem


@functools.cache
def _table():
    """ctypes copies of AE and AI (row-major), B, D = b - bhat."""
    rows = ([x for row in imex.AE for x in row],
            [x for row in imex.AI for x in row], imex.B, imex.D)
    return tuple((ctypes.c_double * len(x))(*x) for x in rows)


def imex_stages_reference(y, h, fz, kc: KernelConstants):
    """(y_new, err, dys) of one step in plain torch, in the kernel's order:
    dys holds each implicit stage's last Newton update."""
    ex_block, im_block, jac_block = make_split_block(kc, fz)
    AE, AI, B, D = imex.AE, imex.AI, imex.B, imex.D
    hg = h * imex.GAMMA
    nvars = y.shape[0]
    eye = torch.eye(nvars, dtype=y.dtype, device=y.device).reshape(
        nvars, nvars, 1, 1)

    kE = [ex_block(y)]
    kI = [im_block(y)]
    dys = []
    for s in range(1, imex.STAGES):
        rhs_known = y
        for j in range(s):
            if AE[s][j] != 0.0:
                rhs_known = rhs_known + (h * AE[s][j]) * kE[j]
            if AI[s][j] != 0.0:
                rhs_known = rhs_known + (h * AI[s][j]) * kI[j]
        yi = rhs_known + hg * kI[s - 1]
        dy = torch.zeros_like(y)
        for _ in range(imex.NEWTON_ITERS):
            m = eye - hg * jac_block(yi)
            resid = yi - hg * im_block(yi) - rhs_known
            dy = imex.solve_pointwise(m, -resid)
            yi = yi + dy
        dys.append(dy)
        kE.append(ex_block(yi))
        kI.append((yi - rhs_known) / hg)

    y_new = y
    err = torch.zeros_like(y)
    for j in range(imex.STAGES):
        k_sum = kE[j] + kI[j]
        if B[j] != 0.0:
            y_new = y_new + (h * B[j]) * k_sum
        if D[j] != 0.0:
            err = err + (h * D[j]) * k_sum
    return y_new, err, dys


def imex_error_sum(err, dys, y, rtol: float, atol: float):
    """(1,) sum of squared WRMS-scaled errors plus (1/NEWTON_TOL)^2 times
    the sum of the squared scaled last Newton updates, weights from y."""
    w = 1.0 / (rtol * torch.abs(y) + atol)
    delta_ss = torch.zeros((), dtype=y.dtype, device=y.device)
    for dy in dys:
        sdy = dy * w
        delta_ss = delta_ss + torch.sum(sdy * sdy)
    scaled = err * w
    pen = (1.0 / imex.NEWTON_TOL) ** 2
    return (torch.sum(scaled * scaled) + pen * delta_ss).reshape(1)


def fused_imex_step_reference(y, h, fz, kc: KernelConstants, rtol: float,
                              atol: float):
    """One step in plain torch: (y_new, ss) with ss a (1,) tensor holding
    the sum of squared WRMS-scaled errors plus (1/NEWTON_TOL)^2 times the
    sum of the squared scaled last Newton updates of the three stages."""
    y_new, err, dys = imex_stages_reference(y, h, fz, kc)
    return y_new, imex_error_sum(err, dys, y, rtol, atol)


def fused_imex_step(y, h, fz, kc: KernelConstants, rtol: float, atol: float):
    """One fused IMEX step: (y_new (2, ny, nx), ss partials (n_blocks,)).

    h and fz are 0-d tensors in y's dtype on y's device: the kernel reads
    them there, so a step needs no host sync. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.
    `fused_imex_step.launches` counts kernel launches.
    """
    if y.device.type == "cpu":
        return fused_imex_step_reference(y, h, fz, kc, rtol, atol)
    if y.device.type != "cuda":
        raise ValueError(f"no fused IMEX step kernel for device {y.device}")
    dtype, device = y.dtype, y.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {dtype}")
    if y.dim() != 3 or y.shape[0] != 2:
        raise ValueError(f"y must be (2, ny, nx), got {tuple(y.shape)}")
    _, ny, nx = y.shape
    check_tensor("y", y, y.shape, dtype, device)
    check_tensor("h", h, (), dtype, device)
    check_tensor("fz", fz, (), dtype, device)
    check_constants(kc, ny, nx, dtype, device)

    from crdmodel_tpu_torch.ops._build import load_library
    lib = load_library()
    tile_x, tile_y, _ = tile_plan(y.element_size())
    n_blocks = -(-nx // tile_x) * -(-ny // tile_y)
    y_new = torch.empty_like(y)
    ss = torch.empty(n_blocks, dtype=dtype, device=device)
    ae, ai, b, d = _table()
    launch = (lib.crd_fused_imex_step_f32 if dtype == torch.float32
              else lib.crd_fused_imex_step_f64)
    # the CUDA runtime launches on the current device: make it y's
    with torch.cuda.device(device):
        rc = launch(y.data_ptr(), y_new.data_ptr(), ss.data_ptr(),
                    h.data_ptr(), fz.data_ptr(),
                    *(c.data_ptr() for c in kc.coeffs),
                    int(kc.kind == "torus"), kc.b.data_ptr(),
                    int(kc.b_is_field), kc.mask.data_ptr(), int(kc.has_freeze),
                    kc.kinetics_id, ny, nx, tile_x, tile_y, ae, ai, b, d,
                    imex.GAMMA, float(rtol), float(atol),
                    torch.cuda.current_stream(device).cuda_stream)
    fused_imex_step.launches += 1
    if rc != 0:
        raise RuntimeError(f"fused IMEX step kernel launch failed: CUDA "
                           f"error {rc}")
    return y_new, ss


fused_imex_step.launches = 0


def build_fused_imex_step(problem):
    """step_err(t, y, h, params) -> (y_new, err_ss) of `problem` through the
    fused IMEX step, in the problem's dtype on its device
    (crdmodel_tpu/ops/pallas_imex.py:155). The freeze comes from
    params["_seg_end"]; t is unused (the kinetics are autonomous)."""
    cfg = problem.cfg
    dtype = problem.y0.dtype
    kc = prepare_constants(problem, dtype, problem.device)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    t_boundary = float(cfg.t_boundary)

    def step_err(t, y, h, params):
        fz = freeze_scalar(params, kc.has_freeze, t_boundary, dtype)
        y_new, ss = fused_imex_step(y, h.to(dtype), fz, kc, rtol, atol)
        return y_new, torch.sum(ss)

    return step_err
