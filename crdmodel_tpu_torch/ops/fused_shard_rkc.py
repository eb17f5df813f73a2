"""Fused RKC2 step on one shard of a mesh, kernel K9 (counterpart of
crdmodel_tpu/ops/pallas_shard_rkc.py).

K2's profile branch (ops/fused_rkc.py) per shard: one exchange of width
P_RKC = 24 a step fills the halo of every shard's buffer
(parallel/halo.py::refresh_halos), then one launch a shard computes all s
Chebyshev stages, y_new and partial sums of squared WRMS-scaled errors
over the shard's PHYSICAL cells (csrc/fused_shard_rkc.cu, on K2's kernel
csrc/rkc_chunk.cuh: the s + 1 evaluations in chunks of at most CHUNK, a
grid barrier between them; the six kinetics families beyond the base three
unforced in csrc/fused_shard_rkc_families.cu on the same scheme,
kernel_common.launcher_symbol). The exchange's P_RKC >= s + 1 rings hold the
block's cone of dependence for the whole step, so the chunks exchange
nothing: chunk c's tiles cover the block grown by the evaluations still to
come (extent_rings), and the rings beyond go wrong from the buffer's edge
inwards without reaching the block. The spectral-radius bound is
max-reduced across the shards (make_rho_bound's max_reduce), so every
shard runs the same s and the same table rows; s, h, the freeze scalar
and the tables reach each shard's device as tensors, and the host never
reads s. The adaptive loop caps h at the kernel's stage budget (h_limit)
and adds every shard's sums in a fixed order.

  fused_shard_rkc_step            the wrapper: launches the CUDA kernel for
                                  a CUDA tensor, runs the plain version for
                                  a CPU tensor
  fused_shard_rkc_step_reference  the same step in plain torch, the oracle
  fused_shard_rkc_tile_sums       the kernel's partial sums in plain torch
  build_fused_shard_rkc           a sharded problem's step_err and h_limit

The state layout is K8's (ops/fused_shard_step.py): halo-padded buffers,
the block at [P, P + nyl) x [P, P + nxl), mirror-pad cells on a padded
mesh. As in the JAX package, it declines the divergence form (no-flux
walls, obstacles, 2-D fields), which runs rkc2 on the sharded torch path.

A structured forcing (rank-1 stimuli; pallas_shard_rkc.py:54-57, 123-160,
191-199, 335-356) is taken as K2 takes it: when every stimulus is
segment-gated (pulse trains) one amplitude column, constant over the
step; else S_MAX_KERNEL + 2 columns at the true Chebyshev stage times of
the stage count s that every shard runs (fused_rkc.
stage_times_amplitudes), computed on the control device from the same s
the step launches with, before the launch, and copied to each shard's
device. Evaluation e reads column amp_column(e), whichever chunk runs it.
Each shard's profiles are halo-padded to P_RKC once a run
(kernel_common.prepare_shard_stim_constants).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from crdmodel_tpu_torch.integrate import rkc
from crdmodel_tpu_torch.ops.fused_kstep import tile_error_sums
from crdmodel_tpu_torch.ops.fused_rkc import (CHUNK, CHUNK_THREADS,
                                              S_MAX_KERNEL,
                                              SCRATCH_PLANES_PER_VAR,
                                              check_stage_tables,
                                              chunk_schedule, rkc_forcing,
                                              rkc_stages_reference,
                                              stage_times_amplitudes,
                                              stage_times_table,
                                              static_stage_tables, tile_plan)
from crdmodel_tpu_torch.ops.fused_shard_step import (check_shard_constants,
                                                     interior,
                                                     masked_error_sum,
                                                     shard_buffers)
from crdmodel_tpu_torch.ops.kernel_common import (BASE_IDS,
                                                  ShardConstants,
                                                  check_shard_stim,
                                                  check_state,
                                                  check_tensor,
                                                  freeze_scalar,
                                                  fused_forcing,
                                                  kernel_families,
                                                  kernel_ready_kinetics,
                                                  launcher_symbol,
                                                  make_rhs_block,
                                                  make_shard_constants,
                                                  needs_divform,
                                                  prepare_shard_stim_constants,
                                                  stim_args)
from crdmodel_tpu_torch.parallel.halo import refresh_halos
from crdmodel_tpu_torch.parallel.shards import Shards

P_RKC = S_MAX_KERNEL + 1     # the exchange's width (pallas_rkc.py P_RKC)


def is_shard_rkc_supported(problem, dtype, nyl: int, nxl: int) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_shard_rkc.py:53-73)
    without the TPU strip rules: f32, a local block at least P_RKC deep on
    both axes, a kinetics Jacobian bound; plus the port's rules of K2's
    profile branch (ops/fused_rkc.py::is_rkc_supported): the profile
    operator, kinetics with a device function (kernel_common.
    kernel_ready_kinetics over kernel_families: all nine families
    unforced, the base three forced). A structured forcing is taken, gated
    and smooth (kernel_common.fused_forcing not False, as the JAX gate's
    :54-57), a free-form one declines."""
    if fused_forcing(problem) is False or dtype != torch.float32:
        return False
    if nyl < P_RKC or nxl < P_RKC:
        return False
    if needs_divform(problem) or problem.diffusion_tensor is not None:
        return False
    if problem.geometry.kind == "box" or problem.model.jac_bound is None:
        return False
    return kernel_ready_kinetics(problem, kernel_families(problem))


def extent_rings(s: int, depth: int = CHUNK):
    """The chunks of one K9 step of s stages, [(first, count, rings), ...]:
    chunk_schedule's chunks, each computed on tiles over the block grown by
    `rings` = the evaluations still to come after it (csrc/rkc_chunk.cuh::
    extent_rings), so that the last chunk's tiles are the block's."""
    return [(first, n, s + 1 - first - n)
            for first, n in chunk_schedule(s, depth)]


def sum_tiles(s_cap: int, itemsize: int):
    """(tile_x, tile_y) of K9's partial sums: the tiles of the one-pass
    kernel the step first ran on (fused_rkc.tile_plan with s_cap + 1
    rings, two variables' planes), anchored at the block's first cell,
    whatever the family; 32x32 in f32 and 16x8 in f64 at s_cap =
    S_MAX_KERNEL."""
    tile_x, tile_y, _ = tile_plan(s_cap + 1, itemsize)
    return tile_x, tile_y


def fused_shard_rkc_step_reference(yp, h, fz, s, mu1_tab, ctab_tab,
                                   sc: ShardConstants, rtol: float,
                                   atol: float, stim=None, amps=None):
    """One step in plain torch on a halo-padded buffer: (y_new, ss), y_new
    a buffer whose block is the step's (its halo is yp's), ss a (1,) tensor
    holding the physical cells' sum of squared WRMS-scaled errors. Reads s
    on the host. The stages run on the whole buffer, wrapping at its edge:
    the s + 1 outer rings go wrong, and the block, P_RKC >= s + 1 rings in,
    is the kernel's bitwise. stim, amps: the shard's StimConstants and the
    step's amplitude table (fused_rkc.stage_times_amplitudes), or None."""
    rhs_block = make_rhs_block(sc, fz)
    y_all, est = rkc_stages_reference(yp, h, s, mu1_tab, ctab_tab, rhs_block,
                                      rkc_forcing(stim, amps, yp))
    y_new = yp.clone()
    interior(y_new, sc.halo).copy_(interior(y_all, sc.halo))
    return y_new, masked_error_sum(est, yp, sc, rtol, atol)


def fused_shard_rkc_tile_sums(yp, h, fz, s, mu1_tab, ctab_tab,
                              sc: ShardConstants, rtol: float, atol: float,
                              stim=None, amps=None):
    """The kernel's partial sums in plain torch: one a sum tile (sum_tiles)
    of the block, each over the tile's physical cells in the one-pass
    kernel's order (CHUNK_THREADS threads, fused_kstep.tile_error_sums; a
    mirror-pad cell adds +0.0, as the kernel's skip). Reads s on the host;
    an s outside [2, s_cap] gives NaN sums, as the kernel."""
    p = sc.halo
    nyl, nxl = yp.shape[1] - 2 * p, yp.shape[2] - 2 * p
    s_cap = mu1_tab.shape[0] - 1
    tile_x, tile_y = sum_tiles(s_cap, yp.element_size())
    if not 2 <= int(s) <= s_cap:
        n = -(-nyl // tile_y) * -(-nxl // tile_x)
        return torch.full((n,), float("nan"), dtype=yp.dtype,
                          device=yp.device)
    _, est = rkc_stages_reference(yp, h, s, mu1_tab, ctab_tab,
                                  make_rhs_block(sc, fz),
                                  rkc_forcing(stim, amps, yp))
    err = interior(est, p).clone()
    err[:, sc.valid_rows:] = 0.0
    err[:, :, sc.valid_cols:] = 0.0
    return tile_error_sums(err, interior(yp, p), rtol, atol, tile_y, tile_x,
                           CHUNK_THREADS)


def kernel_info(dtype, kinetics_id: int) -> dict:
    """K9's CUDA kernel of (dtype, kinetics) on the current card: its
    resident blocks an SM, registers a thread and shared bytes a block."""
    from crdmodel_tpu_torch.ops._build import kernel_info as query
    f64 = int(torch.empty((), dtype=dtype).element_size() == 8)
    if kinetics_id not in BASE_IDS:
        # the families' kernel (csrc/fused_shard_rkc_families.cu)
        return query("crd_fused_shard_rkc_families_info", f64, kinetics_id)
    return query("crd_fused_shard_rkc_info", f64, kinetics_id)


def fused_shard_rkc_step(yp, h, fz, s, mu1_tab, ctab_tab,
                         sc: ShardConstants, rtol: float, atol: float,
                         stim=None, amps=None):
    """One fused RKC2 step on one shard: (y_new, ss partials, one a sum
    tile of the block (sum_tiles)).

    yp is the shard's halo-padded buffer (nvars, nyl + 2P, nxl + 2P) with
    its halo filled, P >= s_cap + 1; h and fz 0-d tensors in its dtype, s a 0-d
    int32 tensor, and mu1_tab/ctab_tab the static_stage_tables of some
    s_cap <= S_MAX_KERNEL, all on its device. Only the block of y_new is
    written; an s outside [2, s_cap] gives NaN partial sums (a rejected
    step). stim, amps: the shard's StimConstants (prepare_shard_stim_
    constants) and the step's amplitude table on its device (fused_rkc.
    stage_times_amplitudes: one column, or S_MAX_KERNEL + 2), or None (the
    unforced kernel). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises. `fused_shard_rkc_step.launches` counts
    kernel launches."""
    if yp.device.type == "cpu":
        return fused_shard_rkc_step_reference(yp, h, fz, s, mu1_tab,
                                              ctab_tab, sc, rtol, atol,
                                              stim, amps)
    if yp.device.type != "cuda":
        raise ValueError(f"no fused shard RKC kernel for device {yp.device}")
    dtype, device = yp.dtype, yp.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {dtype}")
    if sc.kind not in ("torus", "flat"):
        raise ValueError(f"the shard RKC kernel takes profile constants, not "
                         f"{sc.kind!r}")
    check_state(yp, sc)
    p = sc.halo
    nyl, nxl = yp.shape[1] - 2 * p, yp.shape[2] - 2 * p
    s_cap = check_stage_tables(mu1_tab, ctab_tab, dtype, device)
    if p < s_cap + 1 or nyl < p or nxl < p:
        raise ValueError(f"halo {p} and block {nyl}x{nxl}: the kernel needs "
                         f"a halo of s_cap + 1 = {s_cap + 1} and a block at "
                         "least the halo deep")
    check_tensor("yp", yp, yp.shape, dtype, device)
    check_tensor("h", h, (), dtype, device)
    check_tensor("fz", fz, (), dtype, device)
    check_tensor("s", s, (), torch.int32, device)
    check_shard_constants(sc, nyl, nxl, dtype, device)
    if stim is not None:
        check_shard_stim(stim, nyl, nxl, p, dtype, device)
    forcing_args = stim_args(stim, amps, (1, S_MAX_KERNEL + 2))

    from crdmodel_tpu_torch.ops._build import load_library
    lib = load_library()
    tile_x, tile_y = sum_tiles(s_cap, yp.element_size())
    y_new = torch.empty_like(yp)
    ss = torch.empty(-(-nxl // tile_x) * -(-nyl // tile_y), dtype=dtype,
                     device=device)
    # the chunks' hand-off (F0 and two sets in turns, of every variable), on
    # the shard's device
    work = torch.empty((SCRATCH_PLANES_PER_VAR * yp.shape[0],
                        *yp.shape[1:]), dtype=dtype, device=device)
    launch = getattr(lib, launcher_symbol("crd_fused_shard_rkc_step", sc)
                     + ("_f32" if dtype == torch.float32 else "_f64"))
    # the CUDA runtime launches on the current device: make it the shard's
    with torch.cuda.device(device):
        rc = launch(yp.data_ptr(), y_new.data_ptr(), ss.data_ptr(),
                    work.data_ptr(), h.data_ptr(), fz.data_ptr(),
                    *forcing_args, s.data_ptr(),
                    mu1_tab.data_ptr(), ctab_tab.data_ptr(), s_cap,
                    *(c.data_ptr() for c in sc.coeffs),
                    int(sc.kind == "torus"), sc.b.data_ptr(),
                    int(sc.b_is_field), sc.mask.data_ptr(), int(sc.has_freeze),
                    sc.kinetics_id, nyl, nxl, p, sc.valid_rows, sc.valid_cols,
                    tile_x, tile_y, float(rtol), float(atol),
                    torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused shard RKC kernel launch failed: CUDA "
                           f"error {rc}")
    fused_shard_rkc_step.launches += 1
    return y_new, ss


fused_shard_rkc_step.launches = 0


@dataclasses.dataclass(frozen=True)
class FusedShardRKC:
    step_err: Callable   # (t, yp, h, params, carry=()) -> (y_new, sums, ())
    h_limit: Callable    # (t, yp, params) -> stability-capped max h
    pad: Callable
    unpad: Callable
    constants: list


def build_fused_shard_rkc(problem, mesh, rho_fn,
                          pad_spec=None) -> FusedShardRKC:
    """The fused RKC2 step of `problem` on `mesh`
    (crdmodel_tpu/ops/pallas_shard_rkc.py:86): rho_fn(t, y, params) must
    max-reduce across the shards (make_rho_bound's max_reduce) and takes
    the Shards of blocks; build_shard_rkc_stepper with s_cap
    S_MAX_KERNEL and, with a structured forcing, every shard's
    StimConstants halo-padded to P_RKC."""
    cfg = problem.cfg
    dtype = problem.y0.dtype
    consts = make_shard_constants(problem, mesh, pad_spec, P_RKC, dtype)
    stims = prepare_shard_stim_constants(problem, mesh, pad_spec, P_RKC,
                                         dtype)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    return build_shard_rkc_stepper(
        problem, mesh, rho_fn, pad_spec, consts, S_MAX_KERNEL,
        lambda buf, h, fz, s, mu1, ctab, sc, stim, amps:
        fused_shard_rkc_step(buf, h, fz, s, mu1, ctab, sc, rtol, atol, stim,
                             amps), stims)


def build_shard_rkc_stepper(problem, mesh, rho_fn, pad_spec, consts,
                            s_cap: int, step, stims=None) -> FusedShardRKC:
    """The FusedShardRKC of an RKC2 shard kernel (K9, K13): s =
    min(choose_stages(h, rho), s_cap) is chosen on the control device from
    the max-reduced rho_fn (required: every shard must run the same s),
    then step_err refreshes every shard's halo (the width of consts' halo)
    and calls step(buf, h, fz, s, mu1_tab, ctab_tab, sc, stim, amps) ->
    (y_new, ss partials) on each shard, with h, fz, s and the stage tables
    of s_cap on the shard's device; h_limit is the largest h that s_cap
    stages stabilize, STAB_FACTOR (s_cap - 1)^2 / rho. With `stims` (a
    structured forcing, every shard's StimConstants), the step's amplitude
    table is computed on the control device from that same s, before the
    launches (fused_rkc.stage_times_amplitudes on the stage times of
    fused_rkc.stage_times_table: K9's 25 columns, K13's 9) and copied to
    each shard's device; without, stim and amps are None."""
    if rho_fn is None:
        raise ValueError("the sharded fused RKC needs a max-reduced rho_fn")
    dtype = problem.y0.dtype
    halo = consts[0].halo
    t_boundary = float(problem.cfg.t_boundary)
    tables = {d: static_stage_tables(s_cap, dtype, d)
              for d in dict.fromkeys(mesh.device_list())}
    forced = stims is not None
    if forced:
        ctimes = stage_times_table(s_cap, dtype, mesh.control)
        forcing = stims[0].forcing
    else:
        stims = [None] * len(consts)
    pad, unpad = shard_buffers(halo)

    def step_err(t, yp, h, params, carry=()):
        rho = rho_fn(t, unpad(yp), params).to(dtype)
        s = torch.clamp_max(rkc.choose_stages(h, rho), s_cap)
        bufs = refresh_halos(list(yp), mesh, halo, pad_spec)
        fz = freeze_scalar(params, consts[0].has_freeze, t_boundary, dtype)
        h = h.to(dtype)
        amps = (stage_times_amplitudes(forcing, t, h, s, ctimes, params,
                                       dtype) if forced else None)
        out, sums = [], []
        for buf, sc, stim in zip(bufs, consts, stims):
            dev = buf.device
            y_new, ss = step(buf, h.to(dev), fz.to(dev), s.to(dev),
                             *tables[dev], sc, stim,
                             amps if amps is None else amps.to(dev))
            out.append(y_new)
            sums.append(torch.sum(ss))
        return Shards(out), Shards(sums), ()

    def h_limit(t, yp, params):
        """Largest h the s_cap-stage budget stabilizes."""
        rho = rho_fn(t, unpad(yp), params).to(dtype)
        return (rkc.STAB_FACTOR * (s_cap - 1) ** 2
                / torch.clamp_min(rho, 1e-30)).to(dtype)

    return FusedShardRKC(step_err=step_err, h_limit=h_limit, pad=pad,
                         unpad=unpad, constants=consts)
