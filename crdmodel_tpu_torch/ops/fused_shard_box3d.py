"""Fused embedded-ERK step on one shard of the 3-D box, kernel K12
(counterpart of crdmodel_tpu/ops/pallas_shard_box3d.py).

K6 (ops/fused_box3d.py) per shard of a (py, px) mesh that splits the
box's (y, x) axes and keeps z on every shard: one exchange of width HALO
a step fills the (y, x) halo of every shard's (2, nz, nyl + 2 HALO,
nxl + 2 HALO) buffer, all nz planes at once (parallel/halo.py::
refresh_halos), then one launch a shard computes every stage of the box
operator in its four modes (kernel_common.box_mode: profile, tissue,
field, tensor) with the kinetics, the update and per-block partial sums
of squared WRMS-scaled errors over the shard's PHYSICAL cells
(csrc/fused_shard_box3d.cu). The adaptive loop adds every shard's sums
in a fixed order (parallel/sharded.py::make_reduce), so every shard takes
the same steps.

  fused_shard_box3d_step            the wrapper: launches the CUDA kernel
                                    for a CUDA tensor, runs the plain
                                    version for a CPU tensor
  fused_shard_box3d_step_reference  the same step in plain torch, the
                                    oracle
  fused_shard_box3d_tile_sums       the stream scheme's partial sums in
                                    plain torch
  build_fused_shard_box3d           a sharded problem's step_err

The constants are each shard's, halo-padded once a run
(kernel_common.make_shard_box_constants), so every read across a shard
edge (a tissue neighbour's openness, the field mode's aW = aE at i-1 and
aS = aN at j-1) meets the neighbour shard's true value. z is clamped at
the closed walls the gate requires, as in K6. The stages run on a ladder
of rings: stage j on the block and the n_stages - 1 - j rings around it,
so the update needs no more than the n_stages <= HALO rings the exchange
filled. On a mesh that does not divide the grid the kernel runs the JAX
kernels' mirror-pad semantics (kernel_common.ShardConstants). bs32 runs
K6's z-streaming scheme on the block's tiles (ops/box_stream.py: the plan
cuts z into chunks where a plane's tiles are too few to fill the card),
the other tableaus the persistent scheme on the ring ladder. Gone with the
TPU layout: the lane padding, the row strips and their DMAs, and the strip
rule of the gate.

A structured forcing (pallas_shard_box3d.py:196-213, 445-453, 723-724)
goes in as K6's does (ops/fused_box3d.py), with each shard's row and
column profiles halo-padded like its constants and the whole box's depth
table (kernel_common.prepare_shard_stim_constants), the amplitudes once a
step on the control device and copied to each shard
(fused_shard_step.build_shard_stepper).
"""

from __future__ import annotations

import torch

from crdmodel_tpu_torch.integrate.erk import Tableau
from crdmodel_tpu_torch.ops import box_stream
from crdmodel_tpu_torch.ops.fused_box3d import launch_box3d
from crdmodel_tpu_torch.ops.fused_shard_step import (HALO, FusedShardStep,
                                                     build_shard_stepper,
                                                     interior,
                                                     masked_error_sum)
from crdmodel_tpu_torch.ops.fused_step import (MAX_STAGES, _stage_arrays,
                                               erk_stages_reference)
from crdmodel_tpu_torch.ops.kernel_common import (
    ShardBoxConstants, box_mode, forcing_of, fused_forcing,
    kernel_ready_kinetics, make_box_rhs_block, make_shard_box_constants,
    prepare_shard_stim_constants, stim_args)


def is_shard_box3d_supported(problem, tableau: Tableau, dtype, nyl: int,
                             nxl: int) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_shard_box3d.py:74-96)
    without the TPU strip rule: a box whose operator box_mode expresses
    (closed z walls; a constant 6-tensor declines), f32, 2 to HALO stages,
    a local block at least HALO deep on both axes (a halo never spans two
    shards); plus the port's rules of K6 (ops/fused_box3d.py::
    is_box3d_supported): no forcing but a structured one, kinetics with a
    device function."""
    if fused_forcing(problem) is False:
        return False            # a free-form forcing: the torch path
    if problem.geometry.kind != "box" or dtype != torch.float32:
        return False
    if not 2 <= tableau.stages <= min(HALO, MAX_STAGES):
        return False
    if nyl < HALO or nxl < HALO:
        return False
    mode, _ = box_mode(problem)
    if mode is None:
        return False
    if mode == "tensor" and problem.obstacle_mask is not None:
        return False            # build_problem refuses it anyway
    return kernel_ready_kinetics(problem)


def check_shard_box_block(yp, sc: ShardBoxConstants, depth: int):
    """(nyl, nxl) of a halo-padded box buffer, after checking that its
    halo is at least `depth` rings and its block at least the halo deep."""
    p = sc.halo
    if yp.dim() != 4 or yp.shape[0] != 2:
        raise ValueError(f"yp must be (2, nz, nyl+2P, nxl+2P), got "
                         f"{tuple(yp.shape)}")
    nyl, nxl = yp.shape[2] - 2 * p, yp.shape[3] - 2 * p
    if p < depth or nyl < p or nxl < p:
        raise ValueError(f"halo {p} and block {nyl}x{nxl}: the kernel needs "
                         f"a halo of {depth} and a block at least the halo "
                         "deep")
    return nyl, nxl


def fused_shard_box3d_step_reference(yp, h, fz, sc: ShardBoxConstants,
                                     tableau: Tableau, rtol: float,
                                     atol: float, stim=None, amps=None):
    """One step in plain torch on a halo-padded buffer: (y_new, ss), y_new
    a buffer whose block is the step's (its halo is yp's), ss a (1,) tensor
    holding the physical cells' sum of squared WRMS-scaled errors. The
    stages run on the whole buffer, wrapping at its (y, x) edge: the
    n_stages outer rings go wrong, and the block, HALO >= n_stages rings
    in, is the kernel's bitwise. stim, amps: the shard's StimConstants
    (prepare_shard_stim_constants) and the step's (n_stim, n_stages)
    amplitudes, or None."""
    y_all, err = erk_stages_reference(yp, h, make_box_rhs_block(sc, fz),
                                      tableau, forcing_of(stim, amps, yp))
    y_new = yp.clone()
    interior(y_new, sc.halo).copy_(interior(y_all, sc.halo))
    return y_new, masked_error_sum(err, yp, sc, rtol, atol)


def fused_shard_box3d_tile_sums(yp, h, fz, sc: ShardBoxConstants,
                                tableau: Tableau, rtol: float, atol: float,
                                stim=None, amps=None):
    """The stream scheme's partial sums in plain torch: (n_tiles,) sums
    over the block's tiles and z chunks (box_stream.stream_plan) of the
    physical cells' squared WRMS-scaled errors, each in the kernel's order
    (box_stream.stream_tile_sums; a mirror-pad cell adds +0.0, as the
    kernel's skip). Raises ValueError for a tableau the stream scheme does
    not take."""
    if not box_stream.uses_stream(tableau):
        raise ValueError(f"{tableau.name} runs the persistent scheme, whose "
                         "partial sums no plain version replays")
    _, err = erk_stages_reference(yp, h, make_box_rhs_block(sc, fz),
                                  tableau, forcing_of(stim, amps, yp))
    tile_y, z_chunk, _, _ = box_stream.stream_plan(
        yp.element_size(), tuple(yp.shape[1:]), sc.halo)
    return box_stream.stream_tile_sums(
        physical_squares(err, yp, sc, rtol, atol), tile_y, z_chunk)


def physical_squares(err, yp, sc: ShardBoxConstants, rtol: float,
                     atol: float):
    """The block's squared WRMS-scaled errors of halo-padded err and yp,
    +0.0 at the mirror-pad cells: what each of the block's points adds to
    the stream scheme's partial sums."""
    p = sc.halo
    sq = box_stream.scaled_squares(interior(err, p), interior(yp, p), rtol,
                                   atol)
    sq[:, :, sc.valid_rows:] = 0.0
    sq[:, :, :, sc.valid_cols:] = 0.0
    return sq


def fused_shard_box3d_step(yp, h, fz, sc: ShardBoxConstants,
                           tableau: Tableau, rtol: float, atol: float,
                           stim=None, amps=None):
    """One fused step on one shard: (y_new, ss partials (n_blocks,)).

    yp is the shard's halo-padded buffer (2, nz, nyl + 2 HALO, nxl +
    2 HALO) with its halo filled; h and fz are 0-d tensors on its device.
    stim, amps: the shard's StimConstants (prepare_shard_stim_constants:
    profiles halo-padded to the buffer, the box's depth table) and the
    step's (n_stim, n_stages) amplitudes on its device, or None (the
    unforced kernel). Only the block of y_new is written. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (float32,
    or float64 as a parity tool) or raises.
    `fused_shard_box3d_step.launches` counts kernel launches."""
    if yp.device.type == "cpu":
        return fused_shard_box3d_step_reference(yp, h, fz, sc, tableau, rtol,
                                                atol, stim, amps)
    n = tableau.stages
    if not 2 <= n <= MAX_STAGES:
        raise ValueError(f"{n} stages; the kernel takes 2..{MAX_STAGES}")
    check_shard_box_block(yp, sc, n)
    a, b, d = _stage_arrays(tableau.name)
    shard = (n, a, b, d, sc.halo, sc.valid_rows, sc.valid_cols)
    forcing = stim_args(stim, amps, (n,), box=True)
    if box_stream.uses_stream(tableau):
        tile_y, z_chunk, tiles, _ = box_stream.stream_plan(
            yp.element_size(), tuple(yp.shape[1:]), sc.halo)
        out = launch_box3d("crd_fused_shard_box3d_step", yp, h, fz, sc, 0,
                           (*shard, tile_y, z_chunk), rtol, atol,
                           partials=tiles, stim=stim, forcing=forcing)
    else:
        out = launch_box3d("crd_fused_shard_box3d_step", yp, h, fz, sc,
                           n + 1, (*shard, 0, 0), rtol, atol, stim=stim,
                           forcing=forcing)
    fused_shard_box3d_step.launches += 1
    return out


fused_shard_box3d_step.launches = 0


def build_fused_shard_box3d(problem, tableau: Tableau, mesh,
                            pad_spec=None) -> FusedShardStep:
    """step_err(t, yp, h, params) -> (y_new, err_ss) of `problem` on `mesh`
    (crdmodel_tpu/ops/pallas_shard_box3d.py:109): the constants and a
    structured forcing's profiles halo-padded once here, then a step
    refreshes every shard's halo and launches once a shard under its
    device (build_shard_stepper), with the forcing's amplitudes at the
    tableau's c nodes."""
    cfg = problem.cfg
    dtype = problem.y0.dtype
    consts = make_shard_box_constants(problem, mesh, pad_spec, HALO, dtype)
    stims = prepare_shard_stim_constants(problem, mesh, pad_spec, HALO,
                                         dtype)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    return build_shard_stepper(
        problem, mesh, pad_spec, consts,
        lambda buf, h, fz, sc, stim, amps: fused_shard_box3d_step(
            buf, h, fz, sc, tableau, rtol, atol, stim, amps),
        stims, tuple(float(c) for c in tableau.c))
