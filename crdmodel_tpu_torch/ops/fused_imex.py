"""Fused IMEX ARK3(2)4L[2]SA step, kernel K3 (counterpart of
crdmodel_tpu/ops/pallas_imex.py).

One launch performs a whole additive Runge–Kutta step of integrate/imex.py
on the (nvars, ny, nx) state of any of the nine families (the six beyond
the base three unforced, in csrc/fused_imex_families.cu: nvars 2 or 3,
the stencil on each diffusing variable, a 2x2 or 3x3 Cramer solve): the 4
explicit profile-stencil evaluations, the 3
implicit stages solved at every point by 3 full Newton iterations, the
solution and error assembly, and per-tile partial sums of the squared
WRMS-scaled error plus (1/NEWTON_TOL)^2 times the squared scaled last
Newton updates (csrc/fused_imex.cu on csrc/imex_slots.cuh: THREADS threads
fixed to a tile and its Newton rings, a point's pointwise state in its
thread's registers, the partial sums in the order of the first port's
SUM_THREADS-thread one-pass block). It takes every attempted step of an
ark324 run on the fused path (sim.py).

  fused_imex_step            the wrapper: launches the CUDA kernel for a
                             CUDA tensor, runs fused_imex_step_reference
                             for a CPU tensor
  fused_imex_step_reference  the same step in plain torch, the kernel's
                             oracle
  slots_plan                 the launch's plan, sized to the grid: its
                             tile, threads, slots, shared bytes, blocks
  fused_imex_tile_sums       the kernel's partial sums in plain torch, one
                             a tile of the plan in its order
  build_fused_imex_step      a problem's step_err(t, y, h, params) on top
                             of it

Semantics kept from the TPU kernel (pallas_imex.py:89-152, which mirrors
imex.make_imex_step_err line by line): the stage predictor
Y = rhs_known + (h gamma) kI_{i-1}; full Newton with the Jacobian
re-evaluated every iteration; kI_i = (Y_i - rhs_known_i)/(h gamma); the
update and error weights (h B_j) and (h D_j) on kE_j + kI_j in j order; the
row freeze multiplies every part by live = 1 - fz*(1 - m); no stage times
(the kinetics are autonomous); the error weights come from the step's
start. One port-only difference: the Jacobian is the model's closed form
(ReactionModel.jacobian), where the JAX kernel differentiates the kinetics
with jax.jvp inside the kernel, so the two agree to rounding, not bitwise.
The TPU's lane padding and 8-row halo are gone: the state is (nvars, ny,
nx), contiguous, and a tile carries the 4 rings its 4 stencils consume.
The plan is sized to the grid (slots_plan); at the 32x32 plan the partial
sums, and so a run's steps, are those of the port's first K3 kernel.

A structured forcing (core/forcing.py::SeparableForcing, rank-1 stimuli;
pallas_imex.py:190-217, 232-240, 312) joins the explicit evaluations only,
at the ARK c nodes (imex.C): the step computes the four amplitudes on the
device (kernel_common.stage_amplitudes) and kE_i = (lap + F0, F1) times
live; the Newton stages stay autonomous.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from crdmodel_tpu_torch.integrate import imex
from crdmodel_tpu_torch.ops.fused_kstep import block_sums
from crdmodel_tpu_torch.ops.kernel_common import (BASE_IDS, KernelConstants,
                                                  check_constants,
                                                  check_state,
                                                  check_tensor,
                                                  forcing_of,
                                                  freeze_scalar,
                                                  fused_forcing,
                                                  kernel_families,
                                                  kernel_ready_kinetics,
                                                  launcher_symbol,
                                                  make_split_block,
                                                  needs_divform,
                                                  prepare_constants,
                                                  prepare_stim_constants,
                                                  stage_amplitudes,
                                                  stim_args)

HALO = 4                       # one ring per explicit stencil evaluation
TILE = 32                      # the tiles' width; and the 32x32 plan's rows
SMALL_TILE_Y = 16              # the small-grid plan's rows
THREADS = 512                  # csrc/imex_slots.cuh kImexSlotThreads
SUM_THREADS = 256              # kImexSumThreads: the partial sums' order
# the SMs of an H100 SXM: a grid that 32x32 tiles cover in fewer blocks
# than this takes 32x16 tiles (slots_plan)
SMS = 132
SLOTS_KERNEL = "fused_imex_slots_kernel"


def is_imex_supported(problem, dtype) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_imex.py:60) without the
    TPU strip-divisor rule, plus the port-only kinetics rule
    (kernel_common.kernel_ready_kinetics). A structured forcing is taken
    (kernel_common.fused_forcing). Divergence-form problems decline, as
    in the JAX package, and take the torch path, as do problems with a
    diffusion tensor (crdmodel_tpu/sim.py:240-251)."""
    if needs_divform(problem) or problem.diffusion_tensor is not None:
        return False
    if fused_forcing(problem) is False:
        return False
    if dtype != torch.float32:
        return False
    return kernel_ready_kinetics(problem, kernel_families(problem))


class SlotsPlan(NamedTuple):
    """A K3 launch: tile_y x tile_x tiles, one block of `threads` a tile,
    each thread on `slots` points (its tile points and at most one of the
    Newton's rings), `shared_bytes` a block, `blocks` blocks (and partial
    sums)."""
    tile_y: int
    tile_x: int
    threads: int
    slots: int
    shared_bytes: int
    blocks: int


def slots_bytes(tile_y: int, itemsize: int, nvars: int = 2,
                ndiff: int = 1) -> int:
    """The shared bytes a block of 32 x tile_y tiles (csrc/imex_slots.cuh
    ImexPlan, ImexFamilyPlan): dynamic for y0 and two stage planes of the
    region (the tile and HALO rings) of each of the ndiff diffusing
    variables and the staged squares (3 stages' Newton updates and the
    error, nvars variables, on the tile); static for the warps' sums, the
    tableau's products (h AE, h AI, h B, h D) and the profile operator's
    coefficients of the region's columns (three) and rows (beta and
    live)."""
    width, rows = TILE + 2 * HALO, tile_y + 2 * HALO
    dynamic = (3 * ndiff * width * rows
               + nvars * imex.STAGES * TILE * tile_y)
    static = (THREADS // 32 + 2 * imex.STAGES ** 2 + 2 * imex.STAGES
              + 3 * width + 2 * rows)
    return (dynamic + static) * itemsize


def slots_plan(ny: int, nx: int, itemsize: int, nvars: int = 2,
               ndiff: int = 1) -> SlotsPlan:
    """K3's plan on an (nvars, ny, nx) state with ndiff diffusing
    variables in a dtype of `itemsize` bytes: 32x32 tiles (two tile points
    a thread), or 32x16 ones (one) where 32x32 tiles would number fewer
    than SMS, so that a small grid spreads over more SMs; each thread also
    takes at most one point of the Newton's HALO - 1 rings."""
    small = -(-nx // TILE) * -(-ny // TILE) < SMS
    tile_y = SMALL_TILE_Y if small else TILE
    return SlotsPlan(tile_y, TILE, THREADS, TILE * tile_y // THREADS + 1,
                     slots_bytes(tile_y, itemsize, nvars, ndiff),
                     -(-nx // TILE) * -(-ny // tile_y))


@functools.cache
def _table():
    """ctypes copies of AE and AI (row-major), B, D = b - bhat."""
    rows = ([x for row in imex.AE for x in row],
            [x for row in imex.AI for x in row], imex.B, imex.D)
    return tuple((ctypes.c_double * len(x))(*x) for x in rows)


def imex_stages_reference(y, h, fz, kc: KernelConstants, stim=None,
                          amps=None):
    """(y_new, err, dys) of one step in plain torch, in the kernel's order:
    dys holds each implicit stage's last Newton update. stim, amps: a
    structured forcing's StimConstants and its (n_stim, STAGES)
    amplitudes, added to the explicit evaluations, or None."""
    split_ex, im_block, jac_block = make_split_block(kc, fz)
    fs = forcing_of(stim, amps, y)

    def ex_block(x, s):
        return split_ex(x) if fs is None else split_ex(x, fs(s))

    AE, AI, B, D = imex.AE, imex.AI, imex.B, imex.D
    hg = h * imex.GAMMA
    nvars = y.shape[0]
    eye = torch.eye(nvars, dtype=y.dtype, device=y.device).reshape(
        nvars, nvars, 1, 1)

    kE = [ex_block(y, 0)]
    kI = [im_block(y)]
    dys = []
    for s in range(1, imex.STAGES):
        rhs_known = y
        for j in range(s):
            if AE[s][j] != 0.0:
                rhs_known = rhs_known + (h * AE[s][j]) * kE[j]
            if AI[s][j] != 0.0:
                rhs_known = rhs_known + (h * AI[s][j]) * kI[j]
        yi = rhs_known + hg * kI[s - 1]
        dy = torch.zeros_like(y)
        for _ in range(imex.NEWTON_ITERS):
            m = eye - hg * jac_block(yi)
            resid = yi - hg * im_block(yi) - rhs_known
            dy = imex.solve_pointwise(m, -resid)
            yi = yi + dy
        dys.append(dy)
        kE.append(ex_block(yi, s))
        kI.append((yi - rhs_known) / hg)

    y_new = y
    err = torch.zeros_like(y)
    for j in range(imex.STAGES):
        k_sum = kE[j] + kI[j]
        if B[j] != 0.0:
            y_new = y_new + (h * B[j]) * k_sum
        if D[j] != 0.0:
            err = err + (h * D[j]) * k_sum
    return y_new, err, dys


def imex_error_sum(err, dys, y, rtol: float, atol: float):
    """(1,) sum of squared WRMS-scaled errors plus (1/NEWTON_TOL)^2 times
    the sum of the squared scaled last Newton updates, weights from y."""
    w = 1.0 / (rtol * torch.abs(y) + atol)
    delta_ss = torch.zeros((), dtype=y.dtype, device=y.device)
    for dy in dys:
        sdy = dy * w
        delta_ss = delta_ss + torch.sum(sdy * sdy)
    scaled = err * w
    pen = (1.0 / imex.NEWTON_TOL) ** 2
    return (torch.sum(scaled * scaled) + pen * delta_ss).reshape(1)


def fused_imex_step_reference(y, h, fz, kc: KernelConstants, rtol: float,
                              atol: float, stim=None, amps=None):
    """One step in plain torch: (y_new, ss) with ss a (1,) tensor holding
    the sum of squared WRMS-scaled errors plus (1/NEWTON_TOL)^2 times the
    sum of the squared scaled last Newton updates of the three stages."""
    y_new, err, dys = imex_stages_reference(y, h, fz, kc, stim, amps)
    return y_new, imex_error_sum(err, dys, y, rtol, atol)


def imex_tile_sums(err, dys, y0, rtol: float, atol: float, tile_y: int,
                   counted=None):
    """The IMEX kernels' partial sums (K3, K10) in plain torch from a
    step's error, its stages' last Newton updates and its start, each
    (nvars, ny, nx) on the extent the tiles cover: (n_tiles,), one a TILE x
    tile_y tile, row-major, in the order of the SUM_THREADS-thread one-pass
    block that csrc/imex_slots.cuh replays: thread t adds its points of
    each implicit stage s's (TILE + 2 (HALO - s)) x (tile_y + 2 (HALO -
    s)) region, in its strided order, restricted to the tile's counted
    cells (squared scaled last Newton updates, variable by variable), and
    apart its tile points' squared scaled errors (stride SUM_THREADS,
    variable by variable), then
    acc + (1/NEWTON_TOL)^2 dacc, then the block's reduction
    (fused_kstep.block_sums). counted = (rows, cols): only the first rows
    x cols cells count (K10's physical cells), default all; a cell that
    does not adds +0.0, as the kernel's skip."""
    ny, nx = y0.shape[-2:]
    w = 1.0 / (rtol * torch.abs(y0) + atol)
    n_ty, n_tx = -(-ny // tile_y), -(-nx // TILE)
    rows, cols = (ny, nx) if counted is None else counted

    nv = y0.shape[0]

    def tile_squares(a):
        """(nvars, n_tiles, TILE * tile_y) squares of a's scaled values."""
        sq = a * w
        sq = sq * sq
        sq[:, rows:] = 0.0
        sq[:, :, cols:] = 0.0
        sq = torch.nn.functional.pad(sq, (0, n_tx * TILE - nx,
                                          0, n_ty * tile_y - ny))
        return (sq.reshape(nv, n_ty, tile_y, n_tx, TILE)
                .permute(0, 1, 3, 2, 4).reshape(nv, n_ty * n_tx,
                                                 tile_y * TILE))

    threads = torch.arange(SUM_THREADS, device=y0.device)
    dacc = torch.zeros((n_ty * n_tx, SUM_THREADS), dtype=y0.dtype,
                       device=y0.device)
    for s, dy in enumerate(dys, start=1):
        sq = tile_squares(dy)
        width, height = TILE + 2 * (HALO - s), tile_y + 2 * (HALO - s)
        for m in range(-(-width * height // SUM_THREADS)):
            q = threads + SUM_THREADS * m
            ty = s + q // width - HALO
            tx = s + q % width - HALO
            on = ((q < width * height) & (ty >= 0) & (ty < tile_y)
                  & (tx >= 0) & (tx < TILE))
            i = torch.where(on, ty * TILE + tx, 0)
            for var in range(nv):
                dacc = dacc + torch.where(on, sq[var][:, i], 0.0)
    sq = tile_squares(err)
    acc = torch.zeros_like(dacc)
    for m in range(TILE * tile_y // SUM_THREADS):
        cells = slice(SUM_THREADS * m, SUM_THREADS * (m + 1))
        for var in range(nv):
            acc = acc + sq[var][:, cells]
    acc = acc + (1.0 / imex.NEWTON_TOL) ** 2 * dacc
    return block_sums(acc)


def fused_imex_tile_sums(y, h, fz, kc: KernelConstants, rtol: float,
                         atol: float, stim=None, amps=None):
    """The kernel's partial sums in plain torch: (n_blocks,), one a tile of
    slots_plan, each in the kernel's order (imex_tile_sums)."""
    _, err, dys = imex_stages_reference(y, h, fz, kc, stim, amps)
    nv, ny, nx = y.shape
    tile_y = slots_plan(ny, nx, y.element_size(), nv).tile_y
    return imex_tile_sums(err, dys, y, rtol, atol, tile_y)


def kernel_info(dtype, kinetics_id: int, tile_y: int) -> dict:
    """K3's CUDA kernel of (dtype, kinetics) on 32 x tile_y tiles on the
    current card: its resident blocks an SM, registers a thread and shared
    bytes a block (the families' kernel for a NEW_FAMILIES id)."""
    from crdmodel_tpu_torch.ops._build import kernel_info as query
    f64 = int(torch.empty((), dtype=dtype).element_size() == 8)
    name = ("crd_fused_imex_info" if kinetics_id in BASE_IDS
            else "crd_fused_imex_families_info")
    return query(name, f64, kinetics_id, tile_y)


def fused_imex_step(y, h, fz, kc: KernelConstants, rtol: float, atol: float,
                    stim=None, amps=None):
    """One fused IMEX step: (y_new (nvars, ny, nx), ss partials (n_blocks,)),
    on the tiles of slots_plan.

    h and fz are 0-d tensors in y's dtype on y's device: the kernel reads
    them there, so a step needs no host sync. stim, amps: a structured
    forcing's StimConstants and its (n_stim, STAGES) amplitudes of the
    explicit stages on the same device, or None (the unforced kernel). A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. `fused_imex_step.launches` counts kernel launches.
    """
    if y.device.type == "cpu":
        return fused_imex_step_reference(y, h, fz, kc, rtol, atol, stim,
                                         amps)
    if y.device.type != "cuda":
        raise ValueError(f"no fused IMEX step kernel for device {y.device}")
    dtype, device = y.dtype, y.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {dtype}")
    check_state(y, kc)
    nv, ny, nx = y.shape
    check_tensor("y", y, y.shape, dtype, device)
    check_tensor("h", h, (), dtype, device)
    check_tensor("fz", fz, (), dtype, device)
    check_constants(kc, ny, nx, dtype, device)
    forcing_args = stim_args(stim, amps, (imex.STAGES,))

    from crdmodel_tpu_torch.ops._build import load_library
    lib = load_library()
    plan = slots_plan(ny, nx, y.element_size(), nv,
                      len(kc.model.diffusive_vars))
    y_new = torch.empty_like(y)
    ss = torch.empty(plan.blocks, dtype=dtype, device=device)
    ae, ai, b, d = _table()
    launch = getattr(lib, launcher_symbol("crd_fused_imex_step", kc)
                     + ("_f32" if dtype == torch.float32 else "_f64"))
    # the CUDA runtime launches on the current device: make it y's
    with torch.cuda.device(device):
        rc = launch(y.data_ptr(), y_new.data_ptr(), ss.data_ptr(),
                    h.data_ptr(), fz.data_ptr(), *forcing_args,
                    *(c.data_ptr() for c in kc.coeffs),
                    int(kc.kind == "torus"), kc.b.data_ptr(),
                    int(kc.b_is_field), kc.mask.data_ptr(), int(kc.has_freeze),
                    kc.kinetics_id, ny, nx, plan.tile_x, plan.tile_y, ae,
                    ai, b, d, imex.GAMMA, float(rtol), float(atol),
                    torch.cuda.current_stream(device).cuda_stream)
    fused_imex_step.launches += 1
    if rc != 0:
        raise RuntimeError(f"fused IMEX step kernel launch failed: CUDA "
                           f"error {rc}")
    return y_new, ss


fused_imex_step.launches = 0


def build_fused_imex_step(problem):
    """step_err(t, y, h, params) -> (y_new, err_ss) of `problem` through the
    fused IMEX step, in the problem's dtype on its device
    (crdmodel_tpu/ops/pallas_imex.py:155). The freeze comes from
    params["_seg_end"]; t enters only through a structured forcing's
    amplitudes at the explicit stages (the kinetics are autonomous)."""
    cfg = problem.cfg
    dtype = problem.y0.dtype
    kc = prepare_constants(problem, dtype, problem.device)
    stim = prepare_stim_constants(problem, dtype, problem.device)
    c_nodes = torch.tensor(imex.C, dtype=dtype, device=problem.device)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    t_boundary = float(cfg.t_boundary)

    def step_err(t, y, h, params):
        h = h.to(dtype)
        fz = freeze_scalar(params, kc.has_freeze, t_boundary, dtype)
        amps = (None if stim is None else stage_amplitudes(
            stim.forcing, t, h, c_nodes, params, dtype))
        y_new, ss = fused_imex_step(y, h, fz, kc, rtol, atol, stim, amps)
        return y_new, torch.sum(ss)

    return step_err
