"""Fused embedded-ERK step of the anisotropic tensor operator, kernel K5
(counterpart of crdmodel_tpu/ops/pallas_aniso.py).

One launch performs a whole embedded Runge–Kutta step of the conservative
anisotropic operator div(D grad u), D = [[Dxx, Dxy], [Dxy, Dyy]] a field
(cardiac fibre anisotropy), on variable 0 with the kinetics of any family
with a device function and the row freeze (csrc/fused_aniso.cu):

    L u = aE (uE - u) + aW (uW - u) + aN (uN - u) + aS (uS - u)
          + (t1 + t2),   t1 = fx(i+1) - fx(i-1),  fx = dxyw (uN - uS),
                         t2 = fy(j+1) - fy(j-1),  fy = dxyw (uE - uW)

a 9-point stencil with dxyw = Dxy/(4 dx dy). It takes every attempted step
of an ERK run on a problem built with a diffusion tensor on the flat
surface; the other kernels' gates decline tensors.

  fused_aniso_step            the wrapper: launches the CUDA kernel for a
                              CUDA tensor, runs the plain version for a CPU
                              tensor
  fused_aniso_step_reference  the same step in plain torch, the kernel's
                              oracle
  fused_aniso_tile_sums       the plain version of the kernel's partial
                              sums, one a tile in its order
  build_fused_aniso_step      a problem's step_err(t, y, h, params)

bs32 runs the register-resident scheme (csrc/erk_slots.cuh, through
rhs_common.cuh::AnisoRhs's read-once entry), zonneveld43 and dopri54
erk_tile.cuh's: the launcher's dispatch on the stage count
(erk_slots.kernel_name). Both keep the association below and add each
tile's errors in erk_tile.cuh's order.

Semantics kept from the TPU kernel (pallas_aniso.py:149-229): the stage
inputs, update and error of K1 (ops/fused_step.py); the three fields aE, aN
and dxyw cast once from float64 (aW and aS recovered as aE at (j, i-1) and
aN at (j-1, i), wrapped); the JAX kernel's association axis + (t1 + t2)
(kernel_common.aniso_kernel_laplacian); ydot times live = 1 - fz*(1 - m)
with a freeze. Gone with the TPU layout: the lane padding, the per-strip
coefficient windows and the strip-divisor rule. The sweep overrides
(params["_fused_b"], "dscale") are not ported yet (ROADMAP queue 1,
item 14). A forcing is declined, as the TPU kernel's gate declines it
(pallas_aniso.py:64-65).
"""

from __future__ import annotations

import torch

from crdmodel_tpu_torch.integrate.erk import Tableau
from crdmodel_tpu_torch.ops.fused_kstep import tile_error_sums
from crdmodel_tpu_torch.ops.fused_step import (MAX_STAGES,
                                               erk_stages_reference,
                                               erk_step_reference,
                                               launch_erk_tile, tile_plan)
from crdmodel_tpu_torch.ops.kernel_common import (AnisoConstants,
                                                  freeze_scalar,
                                                  fused_forcing,
                                                  kernel_ready_kinetics,
                                                  make_aniso_rhs_block,
                                                  prepare_aniso_constants)


def is_aniso_supported(problem, tableau: Tableau, dtype) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_aniso.py:63) without the
    TPU strip rule: a diffusion tensor on the flat surface, f32, at most
    MAX_STAGES stages, no forcing, plus the port-only kinetics rule
    (kernel_common.kernel_ready_kinetics)."""
    if problem.diffusion_tensor is None:
        return False
    if fused_forcing(problem) is not None:
        return False
    if problem.geometry.kind != "flat":
        return False
    if dtype != torch.float32:
        return False
    if tableau.stages > MAX_STAGES:
        return False
    return kernel_ready_kinetics(problem)


def fused_aniso_step_reference(y, h, fz, ac: AnisoConstants,
                               tableau: Tableau, rtol: float, atol: float):
    """One step in plain torch: (y_new, ss) with ss a (1,) tensor holding
    the sum of squared WRMS-scaled errors."""
    return erk_step_reference(y, h, make_aniso_rhs_block(ac, fz), tableau,
                              rtol, atol)


def fused_aniso_tile_sums(y, h, fz, ac: AnisoConstants, tableau: Tableau,
                          rtol: float, atol: float):
    """The kernel's partial sums in plain torch: (n_tiles,) sums of
    squared WRMS-scaled errors, one a tile of tile_plan, each in the ERK
    tile kernels' order (fused_kstep.tile_error_sums), as both of the
    kernel's schemes write them (csrc/erk_slots.cuh, erk_tile.cuh)."""
    _, err = erk_stages_reference(y, h, make_aniso_rhs_block(ac, fz),
                                  tableau)
    tile_y = tile_plan(tableau.stages, y.element_size())[1]
    return tile_error_sums(err, y, rtol, atol, tile_y)


def fused_aniso_step(y, h, fz, ac: AnisoConstants, tableau: Tableau,
                     rtol: float, atol: float):
    """One fused step: (y_new (2, ny, nx), ss partials (n_blocks,)).

    h and fz are 0-d tensors in y's dtype on y's device: the kernel reads
    them there, so a step needs no host sync. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (float32, or float64 as a
    parity tool) or raises: bs32 the register-resident scheme, the other
    tableaus erk_tile.cuh's (erk_slots.kernel_name).
    `fused_aniso_step.launches` counts kernel launches.
    """
    if y.device.type == "cpu":
        return fused_aniso_step_reference(y, h, fz, ac, tableau, rtol, atol)
    if y.device.type != "cuda":
        raise ValueError(f"no fused anisotropic step kernel for device "
                         f"{y.device}")
    if ac.kind != "aniso":
        raise ValueError("the anisotropic kernel takes AnisoConstants "
                         "(kernel_common.prepare_aniso_constants)")
    out = launch_erk_tile("crd_fused_aniso_step",
                          tuple(c.data_ptr() for c in ac.coeffs),
                          y, h, fz, ac, tableau, rtol, atol)
    fused_aniso_step.launches += 1
    return out


fused_aniso_step.launches = 0


def build_fused_aniso_step(problem, tableau: Tableau):
    """step_err(t, y, h, params) -> (y_new, err_ss) of `problem` through the
    fused anisotropic step, in the problem's dtype on its device
    (crdmodel_tpu/ops/pallas_aniso.py:82). The freeze comes from
    params["_seg_end"]; t is unused (the kinetics are autonomous)."""
    cfg = problem.cfg
    dtype = problem.y0.dtype
    ac = prepare_aniso_constants(problem, dtype, problem.device)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    t_boundary = float(cfg.t_boundary)

    def step_err(t, y, h, params):
        fz = freeze_scalar(params, ac.has_freeze, t_boundary, dtype)
        y_new, ss = fused_aniso_step(y, h.to(dtype), fz, ac, tableau, rtol,
                                     atol)
        return y_new, torch.sum(ss)

    return step_err
