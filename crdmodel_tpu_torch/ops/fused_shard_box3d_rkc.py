"""Fused RKC2 step on one shard of the 3-D box, kernel K13 (counterpart of
crdmodel_tpu/ops/pallas_shard_box3d_rkc.py).

K7 (ops/fused_box3d_rkc.py) per shard, with K12's layout and exchange
(ops/fused_shard_box3d.py): one exchange of width HALO = 8 a step fills
the (y, x) halo of every shard's (2, nz, nyl + 2 HALO, nxl + 2 HALO)
buffer, then the shard's step computes all s Chebyshev stages, y_new and
partial sums of squared WRMS-scaled errors over the shard's PHYSICAL
cells (csrc/fused_shard_box3d_rkc.cu), in K7's two schemes chosen on the
mode: in the tensor mode K7's chunks of at most four evaluations on
csrc/box_rkc_stream.cuh, one launch each, one partial sum a tile and z
chunk of the block, a chunk's tiles over the block grown by the
evaluations still to come (box_stream.rkc_chunks,
fused_shard_rkc.extent_rings); in the others the persistent scheme on a
ladder of rings. F1 = f(y_new) on the block needs y0 on s + 1 <= HALO
rings: the stage
cap C_RKC = HALO - 1 = 7 of the TPU kernel (pallas_box3d_rkc.py:65) is
this kernel's bound too. The spectral-radius bound is max-reduced across
the shards (make_rho_bound's max_reduce), so every shard runs the same s
and the same table rows; the adaptive loop caps h at STAB_FACTOR
(C_RKC - 1)^2 / rho (h_limit) and adds every shard's sums in a fixed
order.

  fused_shard_box3d_rkc_step            the wrapper: launches the CUDA
                                        kernel for a CUDA tensor, runs the
                                        plain version for a CPU tensor
  fused_shard_box3d_rkc_step_reference  the same step in plain torch
  fused_shard_box3d_rkc_tile_sums       the chunk kernel's partial sums in
                                        plain torch
  build_fused_shard_box3d_rkc           a sharded problem's step_err and
                                        h_limit

The operator, freeze, tissue field and constants are K12's
(kernel_common.make_shard_box_constants); mirror-pad cells of a padded
mesh step like their sources and stay out of the error sum. A structured
forcing (pallas_shard_box3d_rkc.py:166-181, 716-722) goes in as K7's does,
with K12's halo-padded profiles and the box's depth table
(kernel_common.prepare_shard_stim_constants); its amplitude table is
computed once a step on the control device from the s every shard runs
(fused_shard_rkc.build_shard_rkc_stepper).
"""

from __future__ import annotations

import torch

from crdmodel_tpu_torch.ops import box_stream
from crdmodel_tpu_torch.ops.fused_box3d import launch_box3d
from crdmodel_tpu_torch.ops.fused_box3d_rkc import (C_RKC, check_rkc_tables,
                                                    is_box3d_rkc_supported)
from crdmodel_tpu_torch.ops.fused_rkc import (rkc_forcing,
                                              rkc_stages_reference)
from crdmodel_tpu_torch.ops.fused_shard_box3d import (check_shard_box_block,
                                                      physical_squares)
from crdmodel_tpu_torch.ops.fused_shard_rkc import (FusedShardRKC,
                                                    build_shard_rkc_stepper)
from crdmodel_tpu_torch.ops.fused_shard_step import (HALO, interior,
                                                     masked_error_sum)
from crdmodel_tpu_torch.ops.kernel_common import (
    ShardBoxConstants, check_tensor, make_box_rhs_block,
    make_shard_box_constants, prepare_shard_stim_constants, stim_args)


def is_shard_box3d_rkc_supported(problem, dtype, nyl: int, nxl: int) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_shard_box3d_rkc.py:52-70)
    without the TPU strip rule: K7's (ops/fused_box3d_rkc.py::
    is_box3d_rkc_supported: a box whose operator box_mode expresses, f32,
    a kinetics Jacobian bound, no forcing but a structured one, kinetics
    with a device function) and a local block at least HALO deep on both
    axes."""
    if nyl < HALO or nxl < HALO:
        return False
    return is_box3d_rkc_supported(problem, dtype)


def fused_shard_box3d_rkc_step_reference(yp, h, fz, s, mu1_tab, ctab_tab,
                                         sc: ShardBoxConstants, rtol: float,
                                         atol: float, stim=None, amps=None):
    """One step in plain torch on a halo-padded buffer: (y_new, ss), y_new
    a buffer whose block is the step's (its halo is yp's), ss a (1,) tensor
    holding the physical cells' sum of squared WRMS-scaled errors. Reads s
    on the host. The stages run on the whole buffer, wrapping at its (y, x)
    edge: the s + 1 outer rings go wrong, and the block, HALO >= s + 1
    rings in, is the kernel's bitwise. stim, amps: the shard's
    StimConstants and the step's amplitude table, or None."""
    y_all, est = rkc_stages_reference(yp, h, s, mu1_tab, ctab_tab,
                                      make_box_rhs_block(sc, fz),
                                      rkc_forcing(stim, amps, yp))
    y_new = yp.clone()
    interior(y_new, sc.halo).copy_(interior(y_all, sc.halo))
    return y_new, masked_error_sum(est, yp, sc, rtol, atol)


def fused_shard_box3d_rkc_tile_sums(yp, h, fz, s, mu1_tab, ctab_tab,
                                    sc: ShardBoxConstants, rtol: float,
                                    atol: float, stim=None, amps=None):
    """The chunk kernel's partial sums in plain torch: (n_tiles,) sums over
    the block's tiles and z chunks (box_stream.stream_plan with
    RKC_MIN_TILES) of the physical cells' squared WRMS-scaled errors, each
    in the kernel's order (box_stream.stream_tile_sums; a mirror-pad cell
    adds +0.0, as the kernel's skip). Reads s on the host; an s outside
    [2, s_cap] gives NaN sums, as the kernel. Raises ValueError for a mode
    the persistent scheme takes."""
    if not box_stream.rkc_uses_stream(sc.kind):
        raise ValueError(f"{sc.kind} runs the persistent scheme, whose "
                         "partial sums no plain version replays")
    tile_y, z_chunk, tiles, _ = box_stream.stream_plan(
        yp.element_size(), tuple(yp.shape[1:]), sc.halo,
        min_tiles=box_stream.RKC_MIN_TILES)
    if not 2 <= int(s) <= mu1_tab.shape[0] - 1:
        return torch.full((tiles,), float("nan"), dtype=yp.dtype,
                          device=yp.device)
    _, est = rkc_stages_reference(yp, h, s, mu1_tab, ctab_tab,
                                  make_box_rhs_block(sc, fz),
                                  rkc_forcing(stim, amps, yp))
    return box_stream.stream_tile_sums(
        physical_squares(est, yp, sc, rtol, atol), tile_y, z_chunk)


def fused_shard_box3d_rkc_step(yp, h, fz, s, mu1_tab, ctab_tab,
                               sc: ShardBoxConstants, rtol: float,
                               atol: float, stim=None, amps=None):
    """One fused RKC2 step on one shard: (y_new, ss partials (n_blocks,);
    in the chunk kernel's modes fused_shard_box3d_rkc_tile_sums').

    yp is the shard's halo-padded buffer (2, nz, nyl + 2P, nxl + 2P) with
    its halo filled, P >= s_cap + 1; h and fz 0-d tensors in its dtype, s a
    0-d int32 tensor, and mu1_tab/ctab_tab the static_stage_tables of some
    s_cap <= C_RKC, all on its device. stim, amps: the shard's
    StimConstants (prepare_shard_stim_constants) and the step's amplitude
    table of 1 or s_cap + 2 columns on its device, or None (the unforced
    kernel). Only the block of y_new is written; an s outside [2, s_cap]
    keeps y and gives NaN partial sums (a rejected step). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (the chunk
    kernel once a chunk of evaluations, or the persistent one) or raises.
    `fused_shard_box3d_rkc_step.launches` counts steps launched."""
    if yp.device.type == "cpu":
        return fused_shard_box3d_rkc_step_reference(
            yp, h, fz, s, mu1_tab, ctab_tab, sc, rtol, atol, stim, amps)
    s_cap = check_rkc_tables(mu1_tab, ctab_tab, yp.dtype, yp.device)
    check_shard_box_block(yp, sc, s_cap + 1)
    check_tensor("s", s, (), torch.int32, yp.device)
    args = (s.data_ptr(), mu1_tab.data_ptr(), ctab_tab.data_ptr(), s_cap,
            box_stream.RKC_MIN_TILES, sc.halo, sc.valid_rows, sc.valid_cols)
    forcing = stim_args(stim, amps, (1, s_cap + 2), box=True)
    tiles = (box_stream.stream_plan(
        yp.element_size(), tuple(yp.shape[1:]), sc.halo,
        min_tiles=box_stream.RKC_MIN_TILES)[2]
        if box_stream.rkc_uses_stream(sc.kind) else None)
    out = launch_box3d("crd_fused_shard_box3d_rkc_step", yp, h, fz, sc, 3,
                       args, rtol, atol, partials=tiles, stim=stim,
                       forcing=forcing)
    fused_shard_box3d_rkc_step.launches += 1
    return out


fused_shard_box3d_rkc_step.launches = 0


def build_fused_shard_box3d_rkc(problem, mesh, rho_fn,
                                pad_spec=None) -> FusedShardRKC:
    """The fused box RKC2 step of `problem` on `mesh`
    (crdmodel_tpu/ops/pallas_shard_box3d_rkc.py:82): rho_fn(t, y, params)
    must max-reduce across the shards and takes the Shards of blocks;
    build_shard_rkc_stepper with s_cap C_RKC, whose h_limit is K7's cap
    (ops/fused_box3d_rkc.py::box_rkc_h_limit) on the max-reduced rho.
    Stage j reads y0 on s + 1 <= C_RKC + 1 = HALO rings. A structured
    forcing's profiles are halo-padded once here, its amplitude table
    computed once a step from the s the launches read."""
    cfg = problem.cfg
    dtype = problem.y0.dtype
    consts = make_shard_box_constants(problem, mesh, pad_spec, HALO, dtype)
    stims = prepare_shard_stim_constants(problem, mesh, pad_spec, HALO,
                                         dtype)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    return build_shard_rkc_stepper(
        problem, mesh, rho_fn, pad_spec, consts, C_RKC,
        lambda buf, h, fz, s, mu1, ctab, sc, stim, amps:
        fused_shard_box3d_rkc_step(buf, h, fz, s, mu1, ctab, sc, rtol, atol,
                                   stim, amps), stims)
