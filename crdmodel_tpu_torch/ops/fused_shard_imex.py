"""Fused IMEX ARK3(2)4L[2]SA step on one shard of a mesh, kernel K10
(counterpart of crdmodel_tpu/ops/pallas_shard_imex.py).

K3 (ops/fused_imex.py) per shard: one exchange of width HALO a step fills
the halo of every shard's buffer (parallel/halo.py::refresh_halos), then
one launch a shard computes the 4 explicit profile-stencil evaluations,
the 3 implicit stages (3 full Newton iterations at every point, shard-local:
the kinetics are pointwise), the update, and per-tile partial sums of the
squared WRMS-scaled error plus (1/NEWTON_TOL)^2 times the squared scaled
last Newton updates, both over the shard's PHYSICAL cells
(csrc/fused_shard_imex.cu on csrc/imex_slots.cuh: 512 threads fixed to
a 32x32 tile and its Newton rings, a point's pointwise state in its
thread's registers, the partial sums in K3's 256-thread order; the six
kinetics families beyond the base three unforced in
csrc/fused_shard_imex_families.cu on the same scheme, SIR's Newton 3x3,
kernel_common.launcher_symbol). The
adaptive loop adds every shard's sums in a fixed order
(parallel/sharded.py::make_reduce), so the Newton convergence test rides
the same cross-shard sum as the error, and every shard takes the same
steps.

  fused_shard_imex_step            the wrapper: launches the CUDA kernel
                                   for a CUDA tensor, runs the plain
                                   version for a CPU tensor
  fused_shard_imex_step_reference  the same step in plain torch, the oracle
  fused_shard_imex_tile_sums       the kernel's partial sums in plain torch
  build_fused_shard_imex           a sharded problem's step_err on top of it

The state layout is K8's (ops/fused_shard_step.py): halo-padded buffers
(nvars, nyl + 2 HALO, nxl + 2 HALO), the block at [HALO, HALO + nyl) x
[HALO, HALO + nxl), with the JAX kernels' mirror-pad semantics on a mesh
that does not divide the grid. K3's 4 explicit stencils consume 4 rings a
step, so 4 would do; HALO stays 8, the JAX package's, so that the kernel
takes the blocks the JAX gate takes (at least 8 deep on both axes) and
shares the exchange and the constants' layout of K8.

A structured forcing (rank-1 stimuli; pallas_shard_imex.py:90-124,
147-155, 243-255) rides the explicit stages only, at the ARK's c nodes
(4 amplitude columns), as K3's does: the step's amplitudes on the control
device copied to each shard (build_shard_stepper), each shard's profiles
halo-padded once a run (kernel_common.prepare_shard_stim_constants). The
Newton stage solves stay pointwise and shard-local.
"""

from __future__ import annotations

import torch

from crdmodel_tpu_torch.integrate import imex
from crdmodel_tpu_torch.ops.fused_imex import (HALO as RINGS, TILE, _table,
                                               imex_error_sum,
                                               imex_stages_reference,
                                               imex_tile_sums, slots_bytes)
from crdmodel_tpu_torch.ops.fused_shard_step import (FusedShardStep,
                                                     build_shard_stepper,
                                                     check_shard_constants,
                                                     interior)
from crdmodel_tpu_torch.ops.kernel_common import (BASE_IDS,
                                                  ShardConstants,
                                                  check_shard_stim,
                                                  check_state,
                                                  check_tensor,
                                                  fused_forcing,
                                                  kernel_families,
                                                  kernel_ready_kinetics,
                                                  launcher_symbol,
                                                  make_shard_constants,
                                                  needs_divform,
                                                  prepare_shard_stim_constants,
                                                  stim_args)

HALO = 8      # the exchange's width (crdmodel_tpu/ops/pallas_step.py HALO)


def is_shard_imex_supported(problem, dtype, nyl: int, nxl: int) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_shard_imex.py:39-47)
    without the TPU strip rule: f32, a local block at least HALO deep on
    both axes; plus the port's rules of K3 (ops/fused_imex.py::
    is_imex_supported): the profile operator (theta-only torus fields
    through its remap), kinetics with a device function (kernel_common.
    kernel_ready_kinetics over kernel_families: all nine families
    unforced, the base three forced). A structured forcing is taken
    (kernel_common.fused_forcing not False), a free-form one declines."""
    if needs_divform(problem) or problem.diffusion_tensor is not None:
        return False
    if problem.geometry.kind == "box" or fused_forcing(problem) is False:
        return False
    if dtype != torch.float32 or nyl < HALO or nxl < HALO:
        return False
    return kernel_ready_kinetics(problem, kernel_families(problem))


def fused_shard_imex_step_reference(yp, h, fz, sc: ShardConstants,
                                    rtol: float, atol: float, stim=None,
                                    amps=None):
    """One step in plain torch on a halo-padded buffer: (y_new, ss), y_new
    a buffer whose block is the step's (its halo is yp's), ss a (1,) tensor
    holding the physical cells' sum of squared WRMS-scaled errors plus
    (1/NEWTON_TOL)^2 times their squared scaled last Newton updates. The
    stages run on the whole buffer, wrapping at its edge: the 4 outer rings
    go wrong, and the block, HALO >= 4 rings in, is the kernel's bitwise.
    stim, amps: the shard's StimConstants and the step's (n_stim, STAGES)
    amplitudes of the explicit stages, or None."""
    y_all, err, dys = imex_stages_reference(yp, h, fz, sc, stim, amps)
    y_new = yp.clone()
    interior(y_new, sc.halo).copy_(interior(y_all, sc.halo))
    p = sc.halo
    cells = (Ellipsis, slice(p, p + sc.valid_rows),
             slice(p, p + sc.valid_cols))
    return y_new, imex_error_sum(err[cells], [dy[cells] for dy in dys],
                                 yp[cells], rtol, atol)


def slots_plan(itemsize: int, nvars: int = 2, ndiff: int = 1):
    """(region, slots, shared bytes) of K10's blocks in a dtype of
    `itemsize` bytes for a family of nvars variables, ndiff of them
    diffusing: K3's 32x32 plan (fused_imex.slots_plan), the TILE-square
    tile with RINGS rings (`region` its side); 512 threads, each on two
    tile points and at most one point of the Newton's RINGS - 1 inner
    rings (`slots` = 3); fused_imex.slots_bytes's shared memory."""
    return (TILE + 2 * RINGS, 3,
            slots_bytes(TILE, itemsize, nvars, ndiff))


def fused_shard_imex_tile_sums(yp, h, fz, sc: ShardConstants, rtol: float,
                               atol: float, stim=None, amps=None):
    """The kernel's partial sums in plain torch: (n_tiles,), one a
    TILE-square tile of the block, in the order of K3's first port, which
    the kernel replays (fused_imex.imex_tile_sums on the block), the
    physical cells only: a mirror-pad cell adds +0.0, as the kernel's
    skip."""
    _, err, dys = imex_stages_reference(yp, h, fz, sc, stim, amps)
    p = sc.halo
    return imex_tile_sums(interior(err, p), [interior(dy, p) for dy in dys],
                          interior(yp, p), rtol, atol, TILE,
                          (sc.valid_rows, sc.valid_cols))


def kernel_info(dtype, kinetics_id: int) -> dict:
    """K10's CUDA kernel of (dtype, kinetics) on the current card: its
    resident blocks an SM, registers a thread and shared bytes a block."""
    from crdmodel_tpu_torch.ops._build import kernel_info as query
    f64 = int(torch.empty((), dtype=dtype).element_size() == 8)
    if kinetics_id not in BASE_IDS:
        # the families' kernel (csrc/fused_shard_imex_families.cu)
        return query("crd_fused_shard_imex_families_info", f64, kinetics_id)
    return query("crd_fused_shard_imex_info", f64, kinetics_id)


def fused_shard_imex_step(yp, h, fz, sc: ShardConstants, rtol: float,
                          atol: float, stim=None, amps=None):
    """One fused IMEX step on one shard: (y_new, ss partials (n_blocks,)).

    yp is the shard's halo-padded buffer (nvars, nyl + 2P, nxl + 2P) with
    its halo filled, P >= 4; h and fz are 0-d tensors on its device. Only the
    block of y_new is written. stim, amps: the shard's StimConstants
    (prepare_shard_stim_constants) and the step's (n_stim, STAGES)
    amplitudes of the explicit stages on its device, or None (the unforced
    kernel). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises. `fused_shard_imex_step.launches` counts kernel
    launches."""
    if yp.device.type == "cpu":
        return fused_shard_imex_step_reference(yp, h, fz, sc, rtol, atol,
                                               stim, amps)
    if yp.device.type != "cuda":
        raise ValueError(f"no fused shard IMEX kernel for device {yp.device}")
    dtype, device = yp.dtype, yp.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {dtype}")
    if sc.kind not in ("torus", "flat"):
        raise ValueError(f"the shard IMEX kernel takes profile constants, "
                         f"not {sc.kind!r}")
    check_state(yp, sc)
    p = sc.halo
    nyl, nxl = yp.shape[1] - 2 * p, yp.shape[2] - 2 * p
    if p < imex.STAGES or nyl < p or nxl < p:
        raise ValueError(f"halo {p} and block {nyl}x{nxl}: the kernel needs "
                         f"a halo of at least {imex.STAGES} rings and a block "
                         "at least as deep as the halo")
    check_tensor("yp", yp, yp.shape, dtype, device)
    check_tensor("h", h, (), dtype, device)
    check_tensor("fz", fz, (), dtype, device)
    check_shard_constants(sc, nyl, nxl, dtype, device)
    if stim is not None:
        check_shard_stim(stim, nyl, nxl, p, dtype, device)
    forcing_args = stim_args(stim, amps, (imex.STAGES,))

    from crdmodel_tpu_torch.ops._build import load_library
    lib = load_library()
    tile_x = tile_y = TILE
    n_blocks = -(-nxl // tile_x) * -(-nyl // tile_y)
    y_new = torch.empty_like(yp)
    ss = torch.empty(n_blocks, dtype=dtype, device=device)
    ae, ai, b, d = _table()
    launch = getattr(lib, launcher_symbol("crd_fused_shard_imex_step", sc)
                     + ("_f32" if dtype == torch.float32 else "_f64"))
    # the CUDA runtime launches on the current device: make it the shard's
    with torch.cuda.device(device):
        rc = launch(yp.data_ptr(), y_new.data_ptr(), ss.data_ptr(),
                    h.data_ptr(), fz.data_ptr(), *forcing_args,
                    *(c.data_ptr() for c in sc.coeffs),
                    int(sc.kind == "torus"), sc.b.data_ptr(),
                    int(sc.b_is_field), sc.mask.data_ptr(),
                    int(sc.has_freeze), sc.kinetics_id, nyl, nxl, p,
                    sc.valid_rows, sc.valid_cols, tile_x, tile_y, ae, ai, b,
                    d, imex.GAMMA, float(rtol), float(atol),
                    torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused shard IMEX kernel launch failed: CUDA "
                           f"error {rc}")
    fused_shard_imex_step.launches += 1
    return y_new, ss


fused_shard_imex_step.launches = 0


def build_fused_shard_imex(problem, mesh, pad_spec=None) -> FusedShardStep:
    """step_err(t, yp, h, params) -> (y_new, err_ss) of `problem` on `mesh`
    (crdmodel_tpu/ops/pallas_shard_imex.py:57): refresh every shard's halo,
    then one launch a shard under its device (build_shard_stepper), with a
    structured forcing's amplitudes at the ARK's c nodes."""
    cfg = problem.cfg
    dtype = problem.y0.dtype
    consts = make_shard_constants(problem, mesh, pad_spec, HALO, dtype)
    stims = prepare_shard_stim_constants(problem, mesh, pad_spec, HALO,
                                         dtype)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    return build_shard_stepper(
        problem, mesh, pad_spec, consts,
        lambda buf, h, fz, sc, stim, amps: fused_shard_imex_step(
            buf, h, fz, sc, rtol, atol, stim, amps),
        stims, tuple(float(c) for c in imex.C))
