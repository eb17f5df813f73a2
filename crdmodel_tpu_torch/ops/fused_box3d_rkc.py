"""Fused RKC2 step on the 3-D box, kernel K7 (counterpart of
crdmodel_tpu/ops/pallas_box3d_rkc.py).

One call performs a whole RKC2 step (integrate/rkc.py) on the
(2, nz, ny, nx) state of a box, in K6's four operator modes
(kernel_common.box_mode; csrc/fused_box3d_rkc.cu): F0 = f(y0),
Y1 = y0 + (h mu1) F0, the recurrence

    Y_j = (1 - mu - nu) y0 + mu Y_{j-1} + nu Y_{j-2} + (h mut) f(Y_{j-1})
          + (h gt) F0,  j = 2..s,

y_new = Y_s, F1 = f(y_new), the error estimate .8(y0 - y_new) +
.4h(F0 + F1) and partial sums of its squared WRMS-scaled values. It takes
every attempted step of an rkc2 run on a box on the fused path (sim.py).

  fused_box3d_rkc_step            the wrapper: launches the CUDA kernel for
                                  a CUDA tensor, runs the plain version for
                                  a CPU tensor
  fused_box3d_rkc_step_reference  the same step in plain torch, the
                                  kernel's oracle
  fused_box3d_rkc_tile_sums       the chunk kernel's partial sums in plain
                                  torch
  build_fused_box3d_rkc_step      a problem's step_err and h_limit

Two schemes, chosen on the operator mode (box_stream.rkc_uses_stream),
each the faster at the slab's shapes on the H100. The tensor mode runs the
s + 1 evaluations in chunks of at most box_stream.DEPTH = 4, each chunk one
launch of K6's z-streaming scheme (csrc/box_rkc_stream.cuh,
ops/box_stream.py: one block a 32x16 tile and z chunk), the first chunk
handing F0 and its last two stage values to the second through device
memory: two launches a step, one partial sum a tile and z chunk in
fused_box3d_rkc_tile_sums' order. The profile, tissue and field modes run
the persistent scheme (one cooperative launch, every stage through device
memory, one partial sum a resident block, in an order the card's
occupancy sets).

Semantics kept from the TPU kernel (pallas_box3d_rkc.py:476-650): the
stage cap C_RKC = 7 (s = min(choose_stages(h, rho), 7)) and the driver's
h cap STAB_FACTOR (C_RKC - 1)^2 / rho (h_limit). On a TPU the cap comes
from the 8-ring halo of its plane pipeline; here the chunk kernel's two
chunks of four evaluations hold it, and it sets the step sequence. The
coefficients come from static_stage_tables(C_RKC) cast to the state's
dtype and indexed by s on the device; an s outside [2, C_RKC] returns NaN
partial sums. The operator, freeze and tissue follow K6 (fused_box3d.py).

A structured forcing (rank-1 stimuli with optional depth profiles;
pallas_box3d_rkc.py:176-208, 605-622) adds its terms to every RHS
evaluation as K6 does, with K2's amplitude table (ops/fused_rkc.py):
one column when every stimulus is segment-gated, else one a Chebyshev
stage time of the step's s, C_RKC + 2 columns (fused_rkc.
stage_times_table), computed on the device from the s the launch reads;
evaluation e reads column amp_column(e).
"""

from __future__ import annotations

import torch

from crdmodel_tpu_torch.core.problem import make_rho_bound
from crdmodel_tpu_torch.integrate import rkc
from crdmodel_tpu_torch.ops import box_stream
from crdmodel_tpu_torch.ops.fused_box3d import launch_box3d
from crdmodel_tpu_torch.ops.fused_rkc import (FusedRKCStep,
                                              check_stage_tables,
                                              rkc_forcing,
                                              rkc_stages_reference,
                                              rkc_step_reference,
                                              stage_times_amplitudes,
                                              stage_times_table,
                                              static_stage_tables)
from crdmodel_tpu_torch.ops.kernel_common import (KernelConstants,
                                                  box_mode, check_tensor,
                                                  freeze_scalar,
                                                  fused_forcing,
                                                  kernel_ready_kinetics,
                                                  make_box_rhs_block,
                                                  prepare_box_constants,
                                                  prepare_stim_constants,
                                                  stim_args)

C_RKC = 7       # the TPU kernel's stage cap (pallas_box3d_rkc.py:65)


def is_box3d_rkc_supported(problem, dtype) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_box3d_rkc.py:93) without
    the TPU strip rule: a box whose operator box_mode expresses (closed z
    walls, a tensor included), f32, a model with a jac_bound, no forcing
    but a structured one (kernel_common.fused_forcing), plus the port-only
    kinetics rule (kernel_common.kernel_ready_kinetics)."""
    if fused_forcing(problem) is False:
        return False            # a free-form forcing: the torch path
    if problem.geometry.kind != "box":
        return False
    if dtype != torch.float32:
        return False
    if problem.model.jac_bound is None:
        return False
    if box_mode(problem)[0] is None:
        return False
    return kernel_ready_kinetics(problem)


def fused_box3d_rkc_step_reference(y, h, fz, s, mu1_tab, ctab_tab,
                                   bc: KernelConstants, rtol: float,
                                   atol: float, stim=None, amps=None):
    """One step in plain torch: (y_new, ss) with ss a (1,) tensor holding
    the sum of squared WRMS-scaled errors; reads s on the host. stim,
    amps: a structured forcing's StimConstants (with its depth table) and
    amplitude table (fused_rkc.stage_times_amplitudes on
    stage_times_table), or None."""
    return rkc_step_reference(y, h, s, mu1_tab, ctab_tab,
                              make_box_rhs_block(bc, fz), rtol, atol,
                              rkc_forcing(stim, amps, y))


def fused_box3d_rkc_tile_sums(y, h, fz, s, mu1_tab, ctab_tab,
                              bc: KernelConstants, rtol: float, atol: float,
                              stim=None, amps=None):
    """The chunk kernel's partial sums in plain torch: (n_tiles,) sums of
    squared WRMS-scaled errors, one a tile and z chunk of its plan
    (box_stream.stream_plan with RKC_MIN_TILES), each in the kernel's order
    (box_stream.stream_tile_sums). Reads s on the host; an s outside
    [2, s_cap] gives NaN sums, as the kernel. Raises ValueError for a mode
    the persistent scheme takes: its order depends on the card's
    occupancy."""
    if not box_stream.rkc_uses_stream(bc.kind):
        raise ValueError(f"{bc.kind} runs the persistent scheme, whose "
                         "partial sums no plain version replays")
    tile_y, z_chunk, tiles, _ = box_stream.stream_plan(
        y.element_size(), tuple(y.shape[1:]),
        min_tiles=box_stream.RKC_MIN_TILES)
    if not 2 <= int(s) <= mu1_tab.shape[0] - 1:
        return torch.full((tiles,), float("nan"), dtype=y.dtype,
                          device=y.device)
    _, est = rkc_stages_reference(y, h, s, mu1_tab, ctab_tab,
                                  make_box_rhs_block(bc, fz),
                                  rkc_forcing(stim, amps, y))
    return box_stream.stream_tile_sums(
        box_stream.scaled_squares(est, y, rtol, atol), tile_y, z_chunk)


def check_rkc_tables(mu1_tab, ctab_tab, dtype, device) -> int:
    """The s_cap of static_stage_tables mu1_tab, ctab_tab; raises unless
    they are `dtype` tensors on `device` of some s_cap in [2, C_RKC], the
    stages two chunks of the stream scheme hold."""
    s_cap = check_stage_tables(mu1_tab, ctab_tab, dtype, device)
    if s_cap > C_RKC:
        raise ValueError(f"tables for s_cap={s_cap}; the box RKC kernels "
                         f"take 2..{C_RKC}")
    return s_cap


def fused_box3d_rkc_step(y, h, fz, s, mu1_tab, ctab_tab, bc: KernelConstants,
                         rtol: float, atol: float, stim=None, amps=None):
    """One fused RKC2 step: (y_new (2, nz, ny, nx), ss partials
    (n_blocks,); in the chunk kernel's modes fused_box3d_rkc_tile_sums').

    h and fz are 0-d tensors in y's dtype, s a 0-d int32 tensor, and
    mu1_tab/ctab_tab the static_stage_tables of some s_cap <= C_RKC, all on
    y's device: the kernel reads s and its table rows there, so a step
    needs no host sync. bc comes from kernel_common.prepare_box_constants.
    stim, amps: a structured forcing's StimConstants (with its depth table)
    and its amplitude table of 1 or s_cap + 2 columns on the same device
    (fused_rkc.stage_times_amplitudes on stage_times_table), or None (the
    unforced kernel). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (the chunk kernel
    once a chunk of evaluations, or the persistent one) or raises.
    `fused_box3d_rkc_step.launches` counts steps launched.
    """
    if y.device.type == "cpu":
        return fused_box3d_rkc_step_reference(y, h, fz, s, mu1_tab, ctab_tab,
                                              bc, rtol, atol, stim, amps)
    s_cap = check_rkc_tables(mu1_tab, ctab_tab, y.dtype, y.device)
    check_tensor("s", s, (), torch.int32, y.device)
    args = (s.data_ptr(), mu1_tab.data_ptr(), ctab_tab.data_ptr(), s_cap,
            box_stream.RKC_MIN_TILES)
    forcing = stim_args(stim, amps, (1, s_cap + 2), box=True)
    tiles = (box_stream.stream_plan(
        y.element_size(), tuple(y.shape[1:]),
        min_tiles=box_stream.RKC_MIN_TILES)[2]
        if box_stream.rkc_uses_stream(bc.kind) else None)
    out = launch_box3d("crd_fused_box3d_rkc_step", y, h, fz, bc, 3, args,
                       rtol, atol, partials=tiles, stim=stim,
                       forcing=forcing)
    fused_box3d_rkc_step.launches += 1
    return out


fused_box3d_rkc_step.launches = 0


def build_fused_box3d_rkc_step(problem, dtype=torch.float32,
                               rho_fn=None) -> FusedRKCStep:
    """The fused box RKC2 step of `problem` in `dtype` on its device
    (crdmodel_tpu/ops/pallas_box3d_rkc.py:119): step_err and the h cap of
    C_RKC stages. The freeze comes from params["_seg_end"]; t enters only
    through a structured forcing's amplitudes, computed from the s the
    launch reads (the kinetics are autonomous)."""
    cfg = problem.cfg
    if rho_fn is None:
        rho_fn = make_rho_bound(cfg, problem.model, problem.geometry, dtype,
                                diffusion_field=problem.diffusion_field,
                                diffusion_tensor=problem.diffusion_tensor,
                                face_mask=problem.face_mask)
    bc = prepare_box_constants(problem, dtype, problem.device)
    stim = prepare_stim_constants(problem, dtype, problem.device)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    t_boundary = float(cfg.t_boundary)
    mu1_tab, ctab_tab = static_stage_tables(C_RKC, dtype, problem.device)
    ctimes = stage_times_table(C_RKC, dtype, problem.device)

    def step_err(t, y, h, params, carry=()):
        rho = rho_fn(t, y, params).to(dtype)
        s = torch.clamp_max(rkc.choose_stages(h, rho), C_RKC)
        h = h.to(dtype)
        fz = freeze_scalar(params, bc.has_freeze, t_boundary, dtype)
        amps = (None if stim is None else stage_times_amplitudes(
            stim.forcing, t, h, s, ctimes, params, dtype))
        y_new, ss = fused_box3d_rkc_step(y, h, fz, s, mu1_tab, ctab_tab, bc,
                                         rtol, atol, stim, amps)
        return y_new, torch.sum(ss), ()

    return FusedRKCStep(step_err=step_err,
                        h_limit=box_rkc_h_limit(rho_fn, dtype))


def box_rkc_h_limit(rho_fn, dtype):
    """h_limit(t, y, params): the largest h the C_RKC-stage budget
    stabilizes, STAB_FACTOR (C_RKC - 1)^2 / rho
    (crdmodel_tpu/ops/pallas_box3d_rkc.py:644-650); also the cap a torch-
    path rkc2 run takes to follow the kernel's step sequence."""
    def h_limit(t, y, params):
        rho = rho_fn(t, y, params).to(dtype)
        return (rkc.STAB_FACTOR * (C_RKC - 1) ** 2
                / torch.clamp_min(rho, 1e-30)).to(dtype)

    return h_limit
