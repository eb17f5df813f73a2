"""Fused embedded-ERK step of the divergence-form operator, kernel K4
(counterpart of crdmodel_tpu/ops/pallas_divform.py).

One launch performs a whole embedded Runge–Kutta step of the conservative
face-coefficient operator

    L u = aE (uE - u) + aW (uW - u) + aN (uN - u) + aS (uS - u)

on variable 0, with the kinetics of any family with a device function,
the row freeze and the tissue mask of an obstacle (csrc/fused_divform.cu).
It takes every attempted step of an ERK run whose operator exists only in
this form (kernel_common.needs_divform): no-flux domain walls, obstacle
scars, 2-D diffusion fields, and diffusion fields on the flat surface, as
in the bounded cardiac-tissue program. The profile kernels K1-K3 decline
those problems.

  fused_divform_step            the wrapper: launches the CUDA kernel for a
                                CUDA tensor, runs the plain version for a
                                CPU tensor
  fused_divform_step_reference  the same step in plain torch, the kernel's
                                oracle
  fused_divform_tile_sums       the plain version of the kernel's partial
                                sums, one a tile in its order
  build_fused_divform_step      a problem's step_err(t, y, h, params)

Semantics kept from the TPU kernel (pallas_divform.py:221-289): the stage
inputs, update and error of K1 (ops/fused_step.py); the face coefficients
cast once from the float64 arrays of the torch path's operator; aS read as
roll_y(aN), exact because the gate checks aS == roll_y(aN) on the float64
fields; ydot times live = 1 - fz*(1 - m) with a freeze, then times the 0/1
tissue field with an obstacle (equal to the torch path's where). Gone with
the TPU layout: the lane padding, the strip windows, the strip-divisor rule
and the runtime coefficient input (params["_divform_coeffs"]); aE, aW, aN
and the tissue field are contiguous (ny, nx) tensors in the step's dtype.
The sweep overrides (params["_fused_b"], "dscale") are not ported yet
(ROADMAP queue 1, item 14). A structured forcing enters as in K1
(pallas_divform.py:171-198, 249-256, 344): each stage's amplitudes from
kernel_common.stage_amplitudes, the stimuli's terms added to the RHS
before the live factor and the tissue field.
"""

from __future__ import annotations

import torch

from crdmodel_tpu_torch.integrate.erk import Tableau
from crdmodel_tpu_torch.ops.fused_kstep import tile_error_sums
from crdmodel_tpu_torch.ops.fused_step import (MAX_STAGES,
                                               erk_stages_reference,
                                               erk_step_reference,
                                               launch_erk_tile,
                                               tile_plan)
from crdmodel_tpu_torch.ops.kernel_common import (DivformConstants,
                                                  face_coeffs64,
                                                  forcing_of,
                                                  freeze_scalar,
                                                  fused_forcing,
                                                  kernel_ready_kinetics,
                                                  make_divform_rhs_block,
                                                  needs_divform,
                                                  prepare_divform_constants,
                                                  prepare_stim_constants,
                                                  south_is_rolled_north,
                                                  stage_amplitudes,
                                                  stim_args)


def is_divform_supported(problem, tableau: Tableau, dtype) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_divform.py:105) without
    the TPU strip-divisor rule: a divergence-form problem on the flat or
    torus surface, f32, at most MAX_STAGES stages, no forcing the kernel
    cannot take (kernel_common.fused_forcing), the port-only kinetics
    rule (kernel_common.kernel_ready_kinetics), and aS == roll_y(aN)
    exactly on the float64 face fields."""
    if not needs_divform(problem):
        return False
    if fused_forcing(problem) is False:
        return False
    if problem.geometry.kind not in ("flat", "torus"):
        return False
    if dtype != torch.float32:
        return False
    if tableau.stages > MAX_STAGES:
        return False
    if not kernel_ready_kinetics(problem):
        return False
    return south_is_rolled_north(face_coeffs64(problem))


def fused_divform_step_reference(y, h, fz, dc: DivformConstants,
                                 tableau: Tableau, rtol: float, atol: float,
                                 stim=None, amps=None):
    """One step in plain torch: (y_new, ss) with ss a (1,) tensor holding
    the sum of squared WRMS-scaled errors; stim, amps: a structured
    forcing's StimConstants and amplitudes, or None."""
    return erk_step_reference(y, h, make_divform_rhs_block(dc, fz), tableau,
                              rtol, atol, forcing_of(stim, amps, y))


def fused_divform_tile_sums(y, h, fz, dc: DivformConstants,
                            tableau: Tableau, rtol: float, atol: float,
                            stim=None, amps=None):
    """The kernel's partial sums in plain torch: (n_tiles,) sums of
    squared WRMS-scaled errors, one a tile of tile_plan, each in the ERK
    tile kernels' order (fused_kstep.tile_error_sums), as both of the
    kernel's schemes write them (csrc/erk_slots.cuh, erk_tile.cuh)."""
    _, err = erk_stages_reference(y, h, make_divform_rhs_block(dc, fz),
                                  tableau, forcing_of(stim, amps, y))
    tile_y = tile_plan(tableau.stages, y.element_size())[1]
    return tile_error_sums(err, y, rtol, atol, tile_y)


def fused_divform_step(y, h, fz, dc: DivformConstants, tableau: Tableau,
                       rtol: float, atol: float, stim=None, amps=None):
    """One fused step: (y_new (2, ny, nx), ss partials (n_blocks,)).

    h and fz are 0-d tensors in y's dtype on y's device: the kernel reads
    them there, so a step needs no host sync. stim, amps: a structured
    forcing's StimConstants and its (n_stim, n_stages) amplitudes on the
    same device, or None (the unforced kernel). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (float32, or float64 as a
    parity tool) or raises. bs32 runs the register-resident scheme
    (csrc/erk_slots.cuh), zonneveld43 and dopri54 erk_tile.cuh's: the
    launcher's dispatch on the stage count (erk_slots.kernel_name).
    `fused_divform_step.launches` counts kernel launches.
    """
    if y.device.type == "cpu":
        return fused_divform_step_reference(y, h, fz, dc, tableau, rtol,
                                            atol, stim, amps)
    if y.device.type != "cuda":
        raise ValueError(f"no fused divergence-form step kernel for device "
                         f"{y.device}")
    if dc.kind != "divform":
        raise ValueError("the divergence-form kernel takes DivformConstants "
                         "(kernel_common.prepare_divform_constants)")
    tissue = None if dc.tissue is None else dc.tissue.data_ptr()
    out = launch_erk_tile(
        "crd_fused_divform_step",
        (*(c.data_ptr() for c in dc.coeffs), tissue),
        y, h, fz, dc, tableau, rtol, atol,
        stim_args(stim, amps, (tableau.stages,)))
    fused_divform_step.launches += 1
    return out


fused_divform_step.launches = 0


def build_fused_divform_step(problem, tableau: Tableau):
    """step_err(t, y, h, params) -> (y_new, err_ss) of `problem` through the
    fused divergence-form step, in the problem's dtype on its device
    (crdmodel_tpu/ops/pallas_divform.py:130). The freeze comes from
    params["_seg_end"]; t enters only through a structured forcing's stage
    amplitudes (the kinetics are autonomous)."""
    cfg = problem.cfg
    dtype = problem.y0.dtype
    dc = prepare_divform_constants(problem, dtype, problem.device)
    stim = prepare_stim_constants(problem, dtype, problem.device)
    c_nodes = torch.tensor(tableau.c, dtype=dtype, device=problem.device)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    t_boundary = float(cfg.t_boundary)

    def step_err(t, y, h, params):
        h = h.to(dtype)
        fz = freeze_scalar(params, dc.has_freeze, t_boundary, dtype)
        amps = (None if stim is None else stage_amplitudes(
            stim.forcing, t, h, c_nodes, params, dtype))
        y_new, ss = fused_divform_step(y, h, fz, dc, tableau, rtol, atol,
                                       stim, amps)
        return y_new, torch.sum(ss)

    return step_err
