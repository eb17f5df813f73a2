"""Fused embedded-ERK step of the divergence-form operator, or of the 2-D
tensor operator, on one shard of a mesh, kernel K11 (counterpart of
crdmodel_tpu/ops/pallas_shard_divform.py).

K4 (ops/fused_divform.py) per shard: one exchange of width HALO a step
fills the halo of every shard's buffer (parallel/halo.py::refresh_halos),
then one launch a shard computes every stage of the conservative face
operator

    L u = aE (uE - u) + aW (uW - u) + aN (uN - u) + aS (uS - u)

with the kinetics, the update and per-block partial sums of squared
WRMS-scaled errors over the shard's PHYSICAL cells
(csrc/fused_shard_divform.cu). It takes the bounded, scarred tissue on a
mesh: no-flux walls, obstacles, 2-D diffusion fields and diffusion fields
on the flat surface, the problems K8 declines.

Its aniso mode takes the 2-D diffusion tensor, flat and on the torus: the
same face operator plus the mixed pair on the raw Dxy, in the XLA path's
association axis + inv4 * (t1 + t2), with inv4 a scalar on the flat
surface and an (nx,) column profile 1/(4 dx dy r ring) on the torus
(crdmodel_tpu/ops/kernel_common.py:196-209). K5 folds Dxy*inv4 into one
field and adds axis + (t1 + t2), which a varying inv4 forbids, so K11 is
the only fused route of a tensor on the torus; its plain version follows
the XLA path and agrees with the sharded torch path to rounding.

  fused_shard_divform_step            the wrapper: launches the CUDA kernel
                                      for a CUDA tensor, runs the plain
                                      version for a CPU tensor
  fused_shard_divform_step_reference  the same step in plain torch
  fused_shard_divform_tile_sums       the plain version of the kernel's
                                      partial sums
  build_fused_shard_divform           a sharded problem's step_err

The coefficients are static, so the (3 or 4, nyl + 2 HALO, nxl + 2 HALO)
stack of aE, aW, aN and the tissue field or Dxy is built once a run from
the global float64 fields and halo-padded by one exchange of the mesh
(kernel_common.py::make_shard_divform_constants), as the JAX package's
prepare_params does once a dispatch. aS is aN of the row below, exact
because the gate checks aS == roll_y(aN) on the global fields. Closed faces
carry zero coefficients, so the halo values they meet contribute exact
zeros, and obstacle cells, whose RHS the tissue field zeroes, hold their
IC bitwise. The state layout is K8's (ops/fused_shard_step.py), HALO 8,
with the mirror-pad semantics on a mesh that does not divide the grid.

A structured forcing (rank-1 stimuli; pallas_shard_divform.py:99-101,
204-211, 263-271, 343-352, 444-467) is taken in both modes as K8 takes
it: the step's amplitudes at the tableau's c nodes on the control device,
copied to each shard (build_shard_stepper), each shard's profiles
halo-padded once a run (kernel_common.prepare_shard_stim_constants). The
forcing joins the operator before the freeze and the tissue field, as
K4's does; a cell outside the no-flux walls meets zero faces and still
reads its profile at its source index.
"""

from __future__ import annotations

import numpy as np
import torch

from crdmodel_tpu_torch.integrate.erk import Tableau
from crdmodel_tpu_torch.ops.fused_kstep import tile_error_sums
from crdmodel_tpu_torch.ops.fused_step import (MAX_STAGES, _stage_arrays,
                                               erk_stages_reference,
                                               tile_plan)
from crdmodel_tpu_torch.ops.fused_shard_step import (HALO, FusedShardStep,
                                                     build_shard_stepper,
                                                     interior,
                                                     masked_error_sum)
from crdmodel_tpu_torch.ops.kernel_common import (ShardDivformConstants,
                                                  check_shard_stim,
                                                  check_tensor,
                                                  face_coeffs64,
                                                  forcing_of,
                                                  fused_forcing,
                                                  kernel_ready_kinetics,
                                                  make_shard_divform_constants,
                                                  make_shard_divform_rhs_block,
                                                  needs_divform,
                                                  prepare_shard_stim_constants,
                                                  south_is_rolled_north,
                                                  stim_args)

# the kernel's operator modes (csrc/fused_shard_divform.cu)
MODES = {"shard_divform": 0, "shard_aniso": 1}


def is_shard_divform_supported(problem, tableau: Tableau, dtype, nyl: int,
                               nxl: int, aniso: bool = False) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_shard_divform.py:96-136)
    without the TPU strip rule: divform mode takes a problem whose operator
    exists only in the divergence form (kernel_common.needs_divform), aniso
    mode one with a 2-D diffusion tensor, each on the flat or torus
    surface; f32, at most HALO stages, a local block at least HALO deep on
    both axes, aS == roll_y(aN) exactly on the global float64 fields; plus
    the port's rule: kinetics with a device function. A structured forcing
    is taken in both modes (kernel_common.fused_forcing not False, as the
    JAX gate's :99-101), a free-form one declines."""
    if problem.geometry.kind not in ("flat", "torus"):
        return False
    if aniso != (problem.diffusion_tensor is not None):
        return False
    if not aniso and not needs_divform(problem):
        return False
    if fused_forcing(problem) is False or dtype != torch.float32:
        return False
    if tableau.stages > min(HALO, MAX_STAGES) or nyl < HALO or nxl < HALO:
        return False
    if not kernel_ready_kinetics(problem):
        return False
    if aniso:
        faces, _, _ = problem.geometry.tensor_coeffs64(
            *problem.diffusion_tensor, boundary=problem.cfg.boundary)
        return bool(np.array_equal(faces[3], np.roll(faces[2], 1, axis=0)))
    return south_is_rolled_north(face_coeffs64(problem))


def fused_shard_divform_step_reference(yp, h, fz, sc: ShardDivformConstants,
                                       tableau: Tableau, rtol: float,
                                       atol: float, stim=None, amps=None):
    """One step in plain torch on a halo-padded buffer: (y_new, ss), y_new
    a buffer whose block is the step's (its halo is yp's), ss a (1,) tensor
    holding the physical cells' sum of squared WRMS-scaled errors. The
    stages run on the whole buffer, wrapping at its edge: the n_stages
    outer rings go wrong, and the block, HALO >= n_stages rings in, is the
    kernel's bitwise. stim, amps: the shard's StimConstants and the step's
    (n_stim, n_stages) amplitudes, or None."""
    y_all, err = erk_stages_reference(
        yp, h, make_shard_divform_rhs_block(sc, fz), tableau,
        forcing_of(stim, amps, yp))
    y_new = yp.clone()
    interior(y_new, sc.halo).copy_(interior(y_all, sc.halo))
    return y_new, masked_error_sum(err, yp, sc, rtol, atol)


def fused_shard_divform_tile_sums(yp, h, fz, sc: ShardDivformConstants,
                                  tableau: Tableau, rtol: float,
                                  atol: float, stim=None, amps=None):
    """The kernel's partial sums in plain torch: (n_tiles,) sums over the
    block's tiles (tile_plan) of the physical cells' squared WRMS-scaled
    errors, each in the ERK tile kernels' order (fused_kstep.
    tile_error_sums; a mirror-pad cell adds +0.0, as the kernel's skip)."""
    _, err = erk_stages_reference(
        yp, h, make_shard_divform_rhs_block(sc, fz), tableau,
        forcing_of(stim, amps, yp))
    err = interior(err, sc.halo).clone()
    err[:, sc.valid_rows:] = 0.0
    err[:, :, sc.valid_cols:] = 0.0
    tile_y = tile_plan(tableau.stages, yp.element_size())[1]
    return tile_error_sums(err, interior(yp, sc.halo), rtol, atol, tile_y)


def check_shard_divform_constants(sc: ShardDivformConstants, nyl: int,
                                  nxl: int, dtype, device):
    """check_tensor on every constant K11 reads."""
    p = sc.halo
    n_fields = 3 + int(sc.tissue is not None or sc.dxy is not None)
    check_tensor("coefficient stack", sc.stack,
                 (n_fields, nyl + 2 * p, nxl + 2 * p), dtype, device)
    if sc.inv4 is not None:
        check_tensor("inv4", sc.inv4, (nxl + 2 * p,) if sc.inv4.dim() else (),
                     dtype, device)
    check_tensor("beta", sc.b, (nyl + 2 * p, 1) if sc.b_is_field else (),
                 dtype, device)
    check_tensor("mask", sc.mask, (nyl + 2 * p, 1), dtype, device)


def fused_shard_divform_step(yp, h, fz, sc: ShardDivformConstants,
                             tableau: Tableau, rtol: float, atol: float,
                             stim=None, amps=None):
    """One fused step on one shard: (y_new, ss partials (n_blocks,)).

    yp is the shard's halo-padded buffer (2, nyl + 2 HALO, nxl + 2 HALO)
    with its halo filled; h and fz are 0-d tensors on its device. Only the
    block of y_new is written. stim, amps: the shard's StimConstants
    (prepare_shard_stim_constants) and the step's (n_stim, n_stages)
    amplitudes on its device, or None (the unforced kernel). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    bs32 runs the register-resident scheme (csrc/erk_slots.cuh),
    zonneveld43 and dopri54 erk_tile.cuh's: erk_slots.kernel_name.
    `fused_shard_divform_step.launches` counts kernel launches."""
    if yp.device.type == "cpu":
        return fused_shard_divform_step_reference(yp, h, fz, sc, tableau,
                                                  rtol, atol, stim, amps)
    if yp.device.type != "cuda":
        raise ValueError(f"no fused shard divergence-form kernel for device "
                         f"{yp.device}")
    dtype, device = yp.dtype, yp.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {dtype}")
    if sc.kind not in MODES:
        raise ValueError(f"the shard divergence-form kernel takes "
                         f"ShardDivformConstants, not {sc.kind!r}")
    n, p = tableau.stages, sc.halo
    if n > min(p, MAX_STAGES):
        raise ValueError(f"{n} stages; the kernel takes at most "
                         f"min(halo, {MAX_STAGES}) = {min(p, MAX_STAGES)}")
    if yp.dim() != 3 or yp.shape[0] != 2:
        raise ValueError(f"yp must be (2, nyl+2P, nxl+2P), got "
                         f"{tuple(yp.shape)}")
    nyl, nxl = yp.shape[1] - 2 * p, yp.shape[2] - 2 * p
    if nyl < p or nxl < p:
        raise ValueError(f"block {nyl}x{nxl} shallower than the halo {p}")
    check_tensor("yp", yp, yp.shape, dtype, device)
    check_tensor("h", h, (), dtype, device)
    check_tensor("fz", fz, (), dtype, device)
    check_shard_divform_constants(sc, nyl, nxl, dtype, device)
    if stim is not None:
        check_shard_stim(stim, nyl, nxl, p, dtype, device)

    from crdmodel_tpu_torch.ops._build import load_library
    lib = load_library()
    tile_x, tile_y, _ = tile_plan(n, yp.element_size())
    n_blocks = -(-nxl // tile_x) * -(-nyl // tile_y)
    y_new = torch.empty_like(yp)
    ss = torch.empty(n_blocks, dtype=dtype, device=device)
    a, b, d = _stage_arrays(tableau.name)
    fourth = sc.tissue if sc.tissue is not None else sc.dxy
    launch = (lib.crd_fused_shard_divform_step_f32
              if dtype == torch.float32
              else lib.crd_fused_shard_divform_step_f64)
    # the CUDA runtime launches on the current device: make it the shard's
    with torch.cuda.device(device):
        rc = launch(yp.data_ptr(), y_new.data_ptr(), ss.data_ptr(),
                    h.data_ptr(), fz.data_ptr(),
                    *stim_args(stim, amps, (tableau.stages,)),
                    *(c.data_ptr() for c in sc.coeffs),
                    None if fourth is None else fourth.data_ptr(),
                    MODES[sc.kind],
                    None if sc.inv4 is None else sc.inv4.data_ptr(),
                    int(sc.inv4 is not None and sc.inv4.dim() == 1),
                    sc.b.data_ptr(), int(sc.b_is_field), sc.mask.data_ptr(),
                    int(sc.has_freeze), sc.kinetics_id, nyl, nxl, p,
                    sc.valid_rows, sc.valid_cols, tile_x, tile_y, n, a, b, d,
                    float(rtol), float(atol),
                    torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused shard divergence-form kernel launch "
                           f"failed: CUDA error {rc}")
    fused_shard_divform_step.launches += 1
    return y_new, ss


fused_shard_divform_step.launches = 0


def build_fused_shard_divform(problem, tableau: Tableau, mesh, pad_spec=None,
                              aniso: bool = False) -> FusedShardStep:
    """step_err(t, yp, h, params) -> (y_new, err_ss) of `problem` on `mesh`
    (crdmodel_tpu/ops/pallas_shard_divform.py:139): the coefficient stack
    halo-padded once here, then a step refreshes every shard's halo and
    launches once a shard under its device (build_shard_stepper), with a
    structured forcing's amplitudes at the tableau's c nodes."""
    cfg = problem.cfg
    dtype = problem.y0.dtype
    consts = make_shard_divform_constants(problem, mesh, pad_spec, HALO,
                                          dtype, aniso=aniso)
    stims = prepare_shard_stim_constants(problem, mesh, pad_spec, HALO,
                                         dtype)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    return build_shard_stepper(
        problem, mesh, pad_spec, consts,
        lambda buf, h, fz, sc, stim, amps: fused_shard_divform_step(
            buf, h, fz, sc, tableau, rtol, atol, stim, amps),
        stims, tuple(float(c) for c in tableau.c))
