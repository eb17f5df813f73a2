"""Fused embedded-ERK step on one shard of a mesh, kernel K8 (counterpart
of crdmodel_tpu/ops/pallas_shard_step.py).

K1 (ops/fused_step.py) per shard: one exchange of width HALO a step fills
the halo of every shard's buffer (parallel/halo.py::refresh_halos), then
one launch a shard computes every stage of the 5-point profile operator
on each diffusing variable with the kinetics of any of the nine
families, the update, and per-block partial sums of squared WRMS-scaled
errors over the shard's PHYSICAL cells (csrc/fused_shard_step.cu for the
base three families, fused_shard_step_families.cu for the other six,
unforced; kernel_common.launcher_symbol). The adaptive loop adds every
shard's sums in a fixed order (parallel/sharded.py::make_reduce), so every
shard takes the same steps.

  fused_shard_step            the wrapper: launches the CUDA kernel for a
                              CUDA tensor, runs the plain version for a CPU
                              tensor
  fused_shard_step_reference  the same step in plain torch, the oracle
  fused_shard_step_tile_sums  the plain version of the kernel's partial
                              sums
  build_fused_shard_step      a sharded problem's step_err on top of it

The loop state is a Shards of halo-padded buffers (nvars, nyl + 2 HALO,
nxl + 2 HALO), the block at [HALO, HALO + nyl) x [HALO, HALO + nxl): the
counterpart of the JAX kernel's lane-padded state, whose column halos it
splices in (pallas_shard_step.py:17-34); here the exchange refreshes the
halo in place and the kernel reads it, no index wraps. HALO is 8, the JAX
package's (pallas_step.py HALO), for every tableau: bs32 consumes 4 rings
a step, dopri54 7. On a mesh that does not divide the grid the kernel
runs the JAX kernels' mirror-pad semantics (kernel_common.py::
ShardConstants). bs32 runs K1's register-resident scheme
(csrc/erk_slots.cuh), whose full tiles read the buffer without a clamp
because HALO >= 4; zonneveld43 and dopri54 run erk_tile.cuh's
(ops/erk_slots.py::kernel_name).

A structured forcing (core/forcing.py::SeparableForcing, rank-1 stimuli;
pallas_shard_step.py:149-230, 281-288, 331-352) is taken as K1 takes it:
the step computes its stage amplitudes once on the mesh's control device
(kernel_common.stage_amplitudes) and copies them to each shard's device,
and each shard's kernel adds (amps[j, s] * rows[j, r]) * cols[j, c] at
the halo-padded (r, c) its state comes from, the profiles halo-padded
once a run like the shard's constants (kernel_common.
prepare_shard_stim_constants). K10 and K11 share the stepper
(build_shard_stepper).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from crdmodel_tpu_torch.integrate.erk import Tableau
from crdmodel_tpu_torch.ops.fused_kstep import tile_error_sums
from crdmodel_tpu_torch.ops.fused_step import (MAX_STAGES, _stage_arrays,
                                               erk_stages_reference,
                                               error_sum,
                                               tile_plan)
from crdmodel_tpu_torch.ops.kernel_common import (ShardConstants,
                                                  check_shard_stim,
                                                  check_state,
                                                  check_tensor,
                                                  forcing_of,
                                                  freeze_scalar,
                                                  fused_forcing,
                                                  kernel_families,
                                                  kernel_ready_kinetics,
                                                  launcher_symbol,
                                                  make_rhs_block,
                                                  make_shard_constants,
                                                  needs_divform,
                                                  prepare_shard_stim_constants,
                                                  stage_amplitudes,
                                                  stim_args)
from crdmodel_tpu_torch.parallel.halo import _alloc, refresh_halos
from crdmodel_tpu_torch.parallel.shards import Shards

HALO = 8      # the exchange's width (crdmodel_tpu/ops/pallas_step.py HALO)


def is_shard_supported(problem, tableau: Tableau, dtype, nyl: int,
                       nxl: int) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_shard_step.py:79-93)
    without the TPU strip rule: f32, at most HALO stages, a local block at
    least HALO deep on both axes (a halo never spans two shards); plus the
    port's rules of K1 (ops/fused_step.py::is_supported): the profile
    operator, kinetics with a device function (kernel_common.
    kernel_ready_kinetics over kernel_families: all nine families
    unforced, the base three forced). A structured forcing is taken
    (kernel_common.fused_forcing not False, as the JAX gate's :81-83), a
    free-form one declines."""
    if needs_divform(problem) or problem.diffusion_tensor is not None:
        return False
    if problem.geometry.kind == "box" or fused_forcing(problem) is False:
        return False
    if dtype != torch.float32 or tableau.stages > min(HALO, MAX_STAGES):
        return False
    if nyl < HALO or nxl < HALO:
        return False
    return kernel_ready_kinetics(problem, kernel_families(problem))


def interior(yp, halo: int):
    """The block of a halo-padded buffer (a view)."""
    return yp[..., halo:yp.shape[-2] - halo, halo:yp.shape[-1] - halo]


def masked_error_sum(err, y, sc: ShardConstants, rtol: float, atol: float):
    """error_sum over the shard's physical cells of halo-padded err and y."""
    p = sc.halo
    cells = (Ellipsis, slice(p, p + sc.valid_rows),
             slice(p, p + sc.valid_cols))
    return error_sum(err[cells], y[cells], rtol, atol)


def fused_shard_step_reference(yp, h, fz, sc: ShardConstants,
                               tableau: Tableau, rtol: float, atol: float,
                               stim=None, amps=None):
    """One step in plain torch on a halo-padded buffer: (y_new, ss), y_new
    a buffer whose block is the step's (its halo is yp's), ss a (1,) tensor
    holding the physical cells' sum of squared WRMS-scaled errors. The
    stages run on the whole buffer, wrapping at its edge: the n_stages
    outer rings go wrong, and the block, HALO >= n_stages rings in, is the
    kernel's bitwise. stim, amps: the shard's StimConstants and the step's
    (n_stim, n_stages) amplitudes, or None."""
    y_all, err = erk_stages_reference(yp, h, make_rhs_block(sc, fz), tableau,
                                      forcing_of(stim, amps, yp))
    y_new = yp.clone()
    interior(y_new, sc.halo).copy_(interior(y_all, sc.halo))
    return y_new, masked_error_sum(err, yp, sc, rtol, atol)


def fused_shard_step_tile_sums(yp, h, fz, sc: ShardConstants,
                               tableau: Tableau, rtol: float, atol: float,
                               stim=None, amps=None):
    """The kernel's partial sums in plain torch: (n_tiles,) sums over the
    block's tiles (tile_plan) of the physical cells' squared WRMS-scaled
    errors, each in the ERK tile kernels' order (fused_kstep.
    tile_error_sums; a mirror-pad cell adds +0.0, as the kernel's skip)."""
    _, err = erk_stages_reference(yp, h, make_rhs_block(sc, fz), tableau,
                                  forcing_of(stim, amps, yp))
    err = interior(err, sc.halo).clone()
    err[:, sc.valid_rows:] = 0.0
    err[:, :, sc.valid_cols:] = 0.0
    tile_y = tile_plan(tableau.stages, yp.element_size(), yp.shape[0])[1]
    return tile_error_sums(err, interior(yp, sc.halo), rtol, atol, tile_y)


def check_shard_constants(sc: ShardConstants, nyl: int, nxl: int, dtype,
                          device):
    """check_tensor on every constant the shard kernels read."""
    p = sc.halo
    coeff_shape = (nxl + 2 * p,) if sc.kind == "torus" else ()
    for c in sc.coeffs:
        check_tensor("coefficient", c, coeff_shape, dtype, device)
    check_tensor("beta", sc.b, (nyl + 2 * p, 1) if sc.b_is_field else (),
                 dtype, device)
    check_tensor("mask", sc.mask, (nyl + 2 * p, 1), dtype, device)


def fused_shard_step(yp, h, fz, sc: ShardConstants, tableau: Tableau,
                     rtol: float, atol: float, stim=None, amps=None):
    """One fused step on one shard: (y_new, ss partials (n_blocks,)).

    yp is the shard's halo-padded buffer (nvars, nyl + 2 HALO, nxl + 2
    HALO) with its halo filled; h and fz are 0-d tensors on its device.
    Only the block of y_new is written. stim, amps: the shard's StimConstants
    (prepare_shard_stim_constants) and the step's (n_stim, n_stages)
    amplitudes on its device, or None (the unforced kernel). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises:
    bs32 the register-resident scheme (csrc/erk_slots.cuh), zonneveld43
    and dopri54 erk_tile.cuh's (erk_slots.kernel_name).
    `fused_shard_step.launches` counts kernel launches."""
    if yp.device.type == "cpu":
        return fused_shard_step_reference(yp, h, fz, sc, tableau, rtol, atol,
                                          stim, amps)
    if yp.device.type != "cuda":
        raise ValueError(f"no fused shard step kernel for device {yp.device}")
    dtype, device = yp.dtype, yp.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {dtype}")
    if sc.kind not in ("torus", "flat"):
        raise ValueError(f"the shard kernel takes profile constants, not "
                         f"{sc.kind!r}")
    n, p = tableau.stages, sc.halo
    if n > min(p, MAX_STAGES):
        raise ValueError(f"{n} stages; the kernel takes at most "
                         f"min(halo, {MAX_STAGES}) = {min(p, MAX_STAGES)}")
    check_state(yp, sc)
    nyl, nxl = yp.shape[1] - 2 * p, yp.shape[2] - 2 * p
    if nyl < p or nxl < p:
        raise ValueError(f"block {nyl}x{nxl} shallower than the halo {p}")
    check_tensor("yp", yp, yp.shape, dtype, device)
    check_tensor("h", h, (), dtype, device)
    check_tensor("fz", fz, (), dtype, device)
    check_shard_constants(sc, nyl, nxl, dtype, device)
    if stim is not None:
        check_shard_stim(stim, nyl, nxl, p, dtype, device)

    from crdmodel_tpu_torch.ops._build import load_library
    lib = load_library()
    tile_x, tile_y, _ = tile_plan(n, yp.element_size(), yp.shape[0])
    n_blocks = -(-nxl // tile_x) * -(-nyl // tile_y)
    y_new = torch.empty_like(yp)
    ss = torch.empty(n_blocks, dtype=dtype, device=device)
    a, b, d = _stage_arrays(tableau.name)
    launch = getattr(lib, launcher_symbol("crd_fused_shard_step", sc)
                     + ("_f32" if dtype == torch.float32 else "_f64"))
    # the CUDA runtime launches on the current device: make it the shard's
    with torch.cuda.device(device):
        rc = launch(yp.data_ptr(), y_new.data_ptr(), ss.data_ptr(),
                    h.data_ptr(), fz.data_ptr(),
                    *stim_args(stim, amps, (tableau.stages,)),
                    *(c.data_ptr() for c in sc.coeffs),
                    int(sc.kind == "torus"), sc.b.data_ptr(),
                    int(sc.b_is_field), sc.mask.data_ptr(), int(sc.has_freeze),
                    sc.kinetics_id, nyl, nxl, p, sc.valid_rows, sc.valid_cols,
                    tile_x, tile_y, n, a, b, d, float(rtol), float(atol),
                    torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused shard step kernel launch failed: CUDA "
                           f"error {rc}")
    fused_shard_step.launches += 1
    return y_new, ss


fused_shard_step.launches = 0


@dataclasses.dataclass(frozen=True)
class FusedShardStep:
    step_err: Callable   # (t, yp, h, params) -> (y_new, per-shard sums)
    pad: Callable        # Shards of blocks -> Shards of halo-padded buffers
    unpad: Callable      # Shards of buffers -> Shards of blocks (views)
    constants: list      # every shard's ShardConstants


def shard_buffers(halo: int):
    """(pad, unpad) between a Shards of blocks and a Shards of halo-padded
    buffers; pad leaves the halo to the step's exchange."""
    def pad(y):
        return Shards(_alloc(list(y), halo, halo))

    def unpad(yp):
        return Shards(interior(b, halo) for b in yp)

    return pad, unpad


def build_shard_stepper(problem, mesh, pad_spec, consts, step, stims=None,
                        c_nodes=()) -> FusedShardStep:
    """The FusedShardStep of a shard kernel with one exchange a step (K8,
    K10, K11, K12): step_err(t, yp, h, params) refreshes every shard's
    halo (the width of consts' halo), then calls step(buf, h, fz, sc,
    stim, amps) -> (y_new, ss partials) on each shard, with h and the
    freeze scalar of the control device copied to the shard's; err_ss is
    the Shards of per-shard sums for the adaptive loop's reduce_fn. t
    enters only through a structured forcing (the kinetics are
    autonomous): with `stims`, every shard's StimConstants
    (prepare_shard_stim_constants), the step's amplitudes at t + c h for
    the stage nodes `c_nodes` are computed once on the control device
    (stage_amplitudes, c_nodes a tensor made there once) and copied to
    each shard's device; without, stim and amps are None."""
    dtype = problem.y0.dtype
    halo = consts[0].halo
    t_boundary = float(problem.cfg.t_boundary)
    pad, unpad = shard_buffers(halo)
    forced = stims is not None
    if forced:
        c_nodes = torch.tensor(c_nodes, dtype=dtype, device=mesh.control)
        forcing = stims[0].forcing
    else:
        stims = [None] * len(consts)

    def step_err(t, yp, h, params):
        bufs = refresh_halos(list(yp), mesh, halo, pad_spec)
        fz = freeze_scalar(params, consts[0].has_freeze, t_boundary, dtype)
        h = h.to(dtype)
        amps = (stage_amplitudes(forcing, t, h, c_nodes, params, dtype)
                if forced else None)
        out, sums = [], []
        for buf, sc, stim in zip(bufs, consts, stims):
            dev = buf.device
            y_new, ss = step(buf, h.to(dev), fz.to(dev), sc, stim,
                             amps if amps is None else amps.to(dev))
            out.append(y_new)
            sums.append(torch.sum(ss))
        return Shards(out), Shards(sums)

    return FusedShardStep(step_err=step_err, pad=pad, unpad=unpad,
                          constants=consts)


def build_fused_shard_step(problem, tableau: Tableau, mesh,
                           pad_spec=None) -> FusedShardStep:
    """step_err(t, yp, h, params) -> (y_new, err_ss) of `problem` on `mesh`
    (crdmodel_tpu/ops/pallas_shard_step.py:105): refresh every shard's
    halo, then one launch a shard (build_shard_stepper), with a structured
    forcing's amplitudes at the tableau's c nodes."""
    cfg = problem.cfg
    dtype = problem.y0.dtype
    consts = make_shard_constants(problem, mesh, pad_spec, HALO, dtype)
    stims = prepare_shard_stim_constants(problem, mesh, pad_spec, HALO,
                                         dtype)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    return build_shard_stepper(
        problem, mesh, pad_spec, consts,
        lambda buf, h, fz, sc, stim, amps: fused_shard_step(
            buf, h, fz, sc, tableau, rtol, atol, stim, amps),
        stims, tuple(float(c) for c in tableau.c))
