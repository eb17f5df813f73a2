"""Fused embedded-ERK step on the 3-D box, kernel K6 (counterpart of
crdmodel_tpu/ops/pallas_box3d.py).

One launch performs a whole embedded Runge–Kutta step of
y' = kinetics(y) + div(D grad y) on the (2, nz, ny, nx) state of a box:
every stage's operator and kinetics, the solution update and per-block
partial sums of squared WRMS-scaled errors (csrc/fused_box3d.cu). x and y
are periodic or walled; the z walls must be closed, because the kernel
clamps the planes above the top and below the bottom (exact only where the
z-seam coefficients are zero, which kernel_common.box_mode checks). The
operator comes in the four modes of box_mode: profile (six face
profiles), tissue (the profiles times the openness recovered from a 0/1
obstacle field, whose inert cells keep their IC), field (three (nz, ny,
nx) face fields) and tensor (the 19-point operator's six fields). It takes
every attempted step of an ERK run on a box on the fused path (sim.py).

  fused_box3d_step            the wrapper: launches the CUDA kernel for a
                              CUDA tensor, runs the plain version for a CPU
                              tensor
  fused_box3d_step_reference  the same step in plain torch, the kernel's
                              oracle
  fused_box3d_tile_sums       the stream scheme's partial sums in plain
                              torch
  build_fused_box3d_step      a problem's step_err(t, y, h, params)

bs32 runs the z-streaming scheme (csrc/box_stream.cuh, ops/box_stream.py:
one block a tile and z chunk, one partial sum each in a fixed order); the
other tableaus the gate takes run the persistent scheme (csrc/box3d.cuh:
one partial sum a resident block, in an order the card's occupancy sets).

Semantics kept from the TPU kernel (pallas_box3d.py:533-713): the stage
inputs, update and error of K1 (ops/fused_step.py); the seven-point sum
E, W, N, S, U, D and the mixed pairs' association
(kernel_common.box_kernel_laplacian); ydot times live = 1 - fz*(1 - m)
with a freeze, then times the tissue field with an obstacle. Gone with the
TPU layout: the z-streaming plane rings, the lane padding, the y strips
and the strip rule (_pick_strip, _box_strip_target). The sweep overrides
(params["_fused_b"], "dscale") are not ported yet (ROADMAP queue 1,
item 14).

A structured forcing (core/forcing.py::SeparableForcing, rank-1 stimuli,
each with an optional depth profile zprof; pallas_box3d.py:360-394,
654-667, 781-782) adds its terms to every stage, before the freeze and the
tissue field: stimulus j at stage s and plane k adds ((amps[j, s] * z[j,
k]) * rows[j, y]) * cols[j, x] (kernel_common.stim_terms), the amplitudes
computed on the device at the true stage times (stage_amplitudes), the
profiles and the depth table once a run (prepare_stim_constants).
"""

from __future__ import annotations

import ctypes

import torch

from crdmodel_tpu_torch.integrate.erk import Tableau
from crdmodel_tpu_torch.ops import box_stream
from crdmodel_tpu_torch.ops.fused_step import (MAX_STAGES, _stage_arrays,
                                               erk_stages_reference,
                                               erk_step_reference)
from crdmodel_tpu_torch.ops.kernel_common import (NO_BOX_STIM_ARGS,
                                                  KernelConstants,
                                                  box_mode, check_tensor,
                                                  forcing_of, freeze_scalar,
                                                  fused_forcing,
                                                  kernel_ready_kinetics,
                                                  make_box_rhs_block,
                                                  prepare_box_constants,
                                                  prepare_stim_constants,
                                                  stage_amplitudes,
                                                  stim_args)

THREADS = 256                  # csrc/box3d.cuh kBoxThreads
# the kernels' operator modes (csrc/box3d.cuh, enum BoxMode)
MODE_IDS = {"box_profile": 0, "box_tissue": 1, "box_field": 2,
            "box_tensor": 3}


def is_box3d_supported(problem, tableau: Tableau, dtype) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_box3d.py:276) without the
    TPU strip rule: a box whose operator box_mode expresses (closed z
    walls), f32, 2 to MAX_STAGES stages, no tensor with an obstacle, no
    forcing but a structured one (rank-1 stimuli, with or without zprof:
    kernel_common.fused_forcing), plus the port-only kinetics rule
    (kernel_common.kernel_ready_kinetics)."""
    if fused_forcing(problem) is False:
        return False            # a free-form forcing: the torch path
    if problem.geometry.kind != "box":
        return False
    if dtype != torch.float32:
        return False
    if not 2 <= tableau.stages <= MAX_STAGES:
        return False
    mode, _ = box_mode(problem)
    if mode is None:
        return False
    if mode == "tensor" and problem.obstacle_mask is not None:
        return False            # build_problem refuses it anyway
    return kernel_ready_kinetics(problem)


def fused_box3d_step_reference(y, h, fz, bc: KernelConstants,
                               tableau: Tableau, rtol: float, atol: float,
                               stim=None, amps=None):
    """One step in plain torch: (y_new, ss) with ss a (1,) tensor holding
    the sum of squared WRMS-scaled errors. stim: the StimConstants of a
    structured forcing (with its depth table) and amps its (n_stim,
    n_stages) amplitudes, or None."""
    return erk_step_reference(y, h, make_box_rhs_block(bc, fz), tableau,
                              rtol, atol, forcing_of(stim, amps, y))


def fused_box3d_tile_sums(y, h, fz, bc: KernelConstants, tableau: Tableau,
                          rtol: float, atol: float, stim=None, amps=None):
    """The stream scheme's partial sums in plain torch: (n_tiles,) sums of
    squared WRMS-scaled errors, one a tile and z chunk of the plan
    (box_stream.stream_plan), each in the kernel's order
    (box_stream.stream_tile_sums). Raises ValueError for a tableau the
    stream scheme does not take: the persistent scheme's order depends on
    the card's occupancy."""
    if not box_stream.uses_stream(tableau):
        raise ValueError(f"{tableau.name} runs the persistent scheme, whose "
                         "partial sums no plain version replays")
    _, err = erk_stages_reference(y, h, make_box_rhs_block(bc, fz), tableau,
                                  forcing_of(stim, amps, y))
    tile_y, z_chunk, _, _ = box_stream.stream_plan(y.element_size(),
                                                   tuple(y.shape[1:]))
    return box_stream.stream_tile_sums(
        box_stream.scaled_squares(err, y, rtol, atol), tile_y, z_chunk)


def fused_box3d_step(y, h, fz, bc: KernelConstants, tableau: Tableau,
                     rtol: float, atol: float, stim=None, amps=None):
    """One fused step: (y_new (2, nz, ny, nx), ss partials (n_blocks,)).

    h and fz are 0-d tensors in y's dtype on y's device: the kernel reads
    them there, so a step needs no host sync. bc comes from
    kernel_common.prepare_box_constants. stim, amps: a structured forcing's
    StimConstants (prepare_stim_constants, with its depth table) and its
    (n_stim, n_stages) amplitude table on the same device
    (stage_amplitudes), or None (the unforced kernel). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (float32, or
    float64 as a parity tool) or raises. `fused_box3d_step.launches`
    counts kernel launches.
    """
    if y.device.type == "cpu":
        return fused_box3d_step_reference(y, h, fz, bc, tableau, rtol, atol,
                                          stim, amps)
    n = tableau.stages
    if not 2 <= n <= MAX_STAGES:
        raise ValueError(f"{n} stages; the kernel takes 2..{MAX_STAGES}")
    a, b, d = _stage_arrays(tableau.name)
    forcing = stim_args(stim, amps, (n,), box=True)
    if box_stream.uses_stream(tableau):
        tile_y, z_chunk, tiles, _ = box_stream.stream_plan(
            y.element_size(), tuple(y.shape[1:]))
        out = launch_box3d("crd_fused_box3d_step", y, h, fz, bc, 0,
                           (n, a, b, d, tile_y, z_chunk), rtol, atol,
                           partials=tiles, stim=stim, forcing=forcing)
    else:
        out = launch_box3d("crd_fused_box3d_step", y, h, fz, bc, n + 1,
                           (n, a, b, d, 0, 0), rtol, atol, stim=stim,
                           forcing=forcing)
    fused_box3d_step.launches += 1
    return out


fused_box3d_step.launches = 0


def launch_box3d(symbol, y, h, fz, bc: KernelConstants, work_states: int,
                 step_args, rtol: float, atol: float,
                 partials: int | None = None, stim=None,
                 forcing=NO_BOX_STIM_ARGS):
    """Launch one step of a box kernel of the built library (K6
    `crd_fused_box3d_step`, K7 `crd_fused_box3d_rkc_step`, and on a
    shard's halo-padded buffer K12 `crd_fused_shard_box3d_step` and K13
    `crd_fused_shard_box3d_rkc_step`; csrc/box3d.cuh, box_stream.cuh): the
    launcher `symbol`_f32 or _f64 with scratch for `work_states` states of
    y's shape and the kernel's own arguments `step_args` before the
    operator's. A persistent launch writes a partial sum for each of at
    most as many blocks as the card keeps resident; a stream launch
    (`partials`, the plan's tile count) one for each tile and needs no
    scratch. The constants' shapes follow y's (nz, ny, nx): a shard's are
    halo-padded like its buffer. `forcing`: the launcher's last arguments,
    a structured forcing's (kernel_common.stim_args with box=True) from
    `stim`, whose profiles and depth table are checked against y's shape
    here. Checks every input first and raises on what the kernel does not
    take, and on a launch error. Returns (y_new (2, nz, ny, nx), ss
    partials (n_blocks,))."""
    dtype, device = y.dtype, y.device
    if device.type != "cuda":
        raise ValueError(f"no box kernel for device {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {dtype}")
    if y.dim() != 4 or y.shape[0] != 2:
        raise ValueError(f"y must be (2, nz, ny, nx), got {tuple(y.shape)}")
    if bc.kind not in MODE_IDS:
        raise ValueError(f"the box kernels take box constants "
                         f"(kernel_common.prepare_box_constants), not "
                         f"{bc.kind!r}")
    _, nz, ny, nx = y.shape
    check_tensor("y", y, y.shape, dtype, device)
    check_tensor("h", h, (), dtype, device)
    check_tensor("fz", fz, (), dtype, device)
    coeff_shapes = ([(nx,), (nx,), (ny,), (ny,), (nz,), (nz,)]
                    if bc.kind in ("box_profile", "box_tissue")
                    else [(nz, ny, nx)] * len(bc.coeffs))
    if len(bc.coeffs) != len(coeff_shapes):
        raise ValueError(f"{bc.kind}: {len(bc.coeffs)} coefficient arrays")
    for c, shape in zip(bc.coeffs, coeff_shapes):
        check_tensor("coefficient", c, shape, dtype, device)
    tissue = getattr(bc, "tissue", None)
    if tissue is not None:
        check_tensor("tissue", tissue, (nz, ny, nx), dtype, device)
    invs = getattr(bc, "invs", None)
    if invs is not None:
        check_tensor("invs", invs, (3,), dtype, device)
    check_tensor("beta", bc.b, (ny, 1) if bc.b_is_field else (), dtype,
                 device)
    check_tensor("mask", bc.mask, (ny, 1), dtype, device)
    if stim is not None:
        for name, t, shape in (("rows", stim.rows, (stim.n_stim, ny)),
                               ("columns", stim.cols, (stim.n_stim, nx)),
                               ("depth table", stim.z, (stim.n_stim, nz))):
            check_tensor("stimulus " + name, t, shape, dtype, device)

    from crdmodel_tpu_torch.ops._build import load_library
    lib = load_library()
    if partials is None:
        # at most the blocks one launch can keep resident: a cooperative
        # launch (every block alive at the grid barriers); 2048 threads an
        # SM
        capacity = (torch.cuda.get_device_properties(device)
                    .multi_processor_count * (2048 // THREADS))
    else:
        capacity = partials
    y_new = torch.empty_like(y)
    ss = torch.empty(capacity, dtype=dtype, device=device)
    work = (torch.empty((work_states, *y.shape), dtype=dtype, device=device)
            if work_states else None)
    n_blocks = ctypes.c_int(0)
    ptrs = [c.data_ptr() for c in bc.coeffs] + [None] * (6 - len(bc.coeffs))
    launch = getattr(lib, symbol + ("_f32" if dtype == torch.float32
                                    else "_f64"))
    # the CUDA runtime launches on the current device: make it y's
    with torch.cuda.device(device):
        rc = launch(y.data_ptr(), y_new.data_ptr(), ss.data_ptr(), capacity,
                    ctypes.byref(n_blocks),
                    None if work is None else work.data_ptr(), h.data_ptr(),
                    fz.data_ptr(), *step_args, *ptrs,
                    None if tissue is None else tissue.data_ptr(),
                    None if invs is None else invs.data_ptr(),
                    MODE_IDS[bc.kind], bc.b.data_ptr(), int(bc.b_is_field),
                    bc.mask.data_ptr(), int(bc.has_freeze), bc.kinetics_id, nz,
                    ny, nx, float(rtol), float(atol),
                    torch.cuda.current_stream(device).cuda_stream, *forcing)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
    return y_new, ss[:n_blocks.value]


def build_fused_box3d_step(problem, tableau: Tableau):
    """step_err(t, y, h, params) -> (y_new, err_ss) of `problem` through the
    fused box step, in the problem's dtype on its device
    (crdmodel_tpu/ops/pallas_box3d.py:307). The freeze comes from
    params["_seg_end"]; t enters only through a structured forcing's stage
    amplitudes (the kinetics are autonomous)."""
    cfg = problem.cfg
    dtype = problem.y0.dtype
    bc = prepare_box_constants(problem, dtype, problem.device)
    stim = prepare_stim_constants(problem, dtype, problem.device)
    c_nodes = torch.tensor(tableau.c, dtype=dtype, device=problem.device)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    t_boundary = float(cfg.t_boundary)

    def step_err(t, y, h, params):
        h = h.to(dtype)
        fz = freeze_scalar(params, bc.has_freeze, t_boundary, dtype)
        amps = (None if stim is None else stage_amplitudes(
            stim.forcing, t, h, c_nodes, params, dtype))
        y_new, ss = fused_box3d_step(y, h, fz, bc, tableau, rtol, atol, stim,
                                     amps)
        return y_new, torch.sum(ss)

    return step_err
