"""Fused RKC2 step, kernel K2 (counterpart of crdmodel_tpu/ops/pallas_rkc.py).

One launch performs a whole RKC2 step (integrate/rkc.py) of the 5-point
profile operator, or of the divergence-form operator of K4 (no-flux walls,
obstacles, 2-D diffusion fields: kernel_common.needs_divform), with the
kinetics of a family with a device function (KernelConstants.
kinetics_id; the kinetics and the operator are template parameters of the
kernel, as in K1, K3 and K4; the profile branch takes all nine families,
the six beyond the base three unforced in csrc/fused_rkc_families.cu,
the divergence branch the base three): F0 = f(y0), the s
Chebyshev stages, F(y_new) for the order-2 error estimate, y_new and
per-tile partial sums of squared WRMS-scaled errors (csrc/fused_rkc.cu).
The three-term recurrence keeps a live set of constant size (y0, F0,
Y_{j-1}, Y_{j-2}), so the s + 1 RHS evaluations run in chunks of at most
CHUNK (chunk_schedule), each a pass over CHUNK_TILE-square tiles with a
halo of its own evaluations, the live set handed from chunk to chunk
through device memory at a grid barrier, in one launch for any stage
count up to S_MAX_KERNEL. It takes every attempted step of an rkc2 run on
the fused path (sim.py).

  fused_rkc_step            the wrapper: launches the CUDA kernel for a CUDA
                            tensor, runs fused_rkc_step_reference for a CPU
                            tensor
  fused_rkc_step_reference  the same step in plain torch, the kernel's oracle
  build_fused_rkc_step      a problem's step_err and h_limit on top of it

Semantics kept from the TPU kernel (pallas_rkc.py:586-618, 695-758): no
carry, F0 is recomputed every step; the coefficients come from f64 tables
(static_stage_tables) cast to the state's dtype and indexed by s; the stage
count is s = min(choose_stages(h, rho), s_cap) and the driver caps h to the
coverage of s_cap stages (h_limit); the row freeze multiplies every
evaluation by live = 1 - fz*(1 - m); the error weights come from the step's
start. The TPU's VMEM strip plan (variant_plan, choose_blocking, P_LADDER)
is layout and is gone: s_cap is S_MAX_KERNEL = 23 at every grid size, where
the JAX package caps lower at very wide rows, and so is the column-blocked
layout of its K2b (pallas_rkc.py::_build_blocked), which exists only to fit
a TPU row strip: the tiles here do not depend on nx, so K2 at K2b's shapes
is K2b's step. The JAX package also caps s at 15 on divergence-form
problems whose strip plan lacks its deep variant (ROADMAP queue 2). The
divergence branch reads the face coefficients as K4 does (DivformConstants,
aS = roll_y(aN)). The state is (nvars, ny, nx), contiguous and unpadded.

A structured forcing (core/forcing.py::SeparableForcing, rank-1 stimuli;
pallas_rkc.py:434-468, 517-551, 715-735) adds its terms to every RHS
evaluation, before the freeze and the tissue field, in both branches. When
every stimulus is segment-gated (pulse trains) the amplitudes are constant
over the step: one column, waveform(t, seg_end). Otherwise one column per
stage time of static_stage_tables(with_times=True), the true Chebyshev
stage times t + c h of the step's s, computed on the device
(stage_times_amplitudes); evaluation e reads column amp_column(e), the
step's evaluation index, whatever chunk runs it. The JAX package declines
forcing on its column-blocked K2b (pallas_rkc.py:230-234), a layout this
kernel does not have: it takes forcing at every width.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from crdmodel_tpu_torch.core.problem import make_rho_bound
from crdmodel_tpu_torch.integrate import rkc
from crdmodel_tpu_torch.ops.fused_step import error_sum
from crdmodel_tpu_torch.ops.kernel_common import (BASE_IDS, SMEM_BYTES,
                                                  KernelConstants,
                                                  check_constants,
                                                  check_state,
                                                  check_tensor,
                                                  face_coeffs64,
                                                  forcing_amplitudes,
                                                  forcing_of,
                                                  freeze_scalar,
                                                  fused_forcing,
                                                  kernel_families,
                                                  kernel_ready_kinetics,
                                                  launcher_symbol,
                                                  make_divform_rhs_block,
                                                  make_rhs_block,
                                                  needs_divform,
                                                  prepare_constants,
                                                  prepare_divform_constants,
                                                  prepare_stim_constants,
                                                  south_is_rolled_north,
                                                  stim_args)

S_MAX_KERNEL = 23              # the TPU kernel's halo P=24 less one
# the tiles of the one-pass RKC kernel the shard step first ran on, which
# define K9's partial sums (tile_plan): (tile_x, tile_y) candidates, best
# first
TILES = ((32, 32), (32, 16), (16, 16), (16, 8), (8, 8))
# K2's chunked tiles (csrc/fused_rkc.cu): the most RHS evaluations a chunk
# takes (its halo's rings), the square tile's side, the block's threads,
# and the shared planes of a region (y0 and F0, two variables each, and
# two of Y_{j-1}'s variable 0)
CHUNK = 6
CHUNK_TILE = 32
CHUNK_THREADS = 512
CHUNK_PLANES = 6
# the scratch planes a launch (K2, K9) hands its chunks through: F0 and
# two (Y_{j-1}, Y_{j-2}) pairs in turns, of every variable: 5 a variable
SCRATCH_PLANES_PER_VAR = 5


def is_rkc_supported(problem, dtype) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_rkc.py:218) without the
    TPU strip plan, plus the port-only kinetics rule
    (kernel_common.kernel_ready_kinetics). Divergence-form problems take
    the divergence branch on the flat and torus surfaces when aS ==
    roll_y(aN) exactly on the float64 faces (pallas_rkc.py:239-253).
    Problems with a diffusion tensor decline: rkc2 takes no kernel there
    (crdmodel_tpu/sim.py:189-191). A structured forcing is taken, gated
    and smooth waveforms alike (kernel_common.fused_forcing), at every
    width: the JAX package's K2b predicate (pallas_rkc.py:230-234) is its
    column-blocked layout's, which this kernel does not have."""
    if fused_forcing(problem) is False:
        return False
    if dtype != torch.float32:
        return False
    if problem.diffusion_tensor is not None:
        return False
    if problem.model.jac_bound is None:
        return False
    # pallas_rkc.pole_inflated_rho declines only surfaces of revolution,
    # which the port has not yet (ROADMAP queue 1, item 12)
    if needs_divform(problem):
        # the divergence branch (DivformRhs) takes the base families
        return (kernel_ready_kinetics(problem)
                and problem.geometry.kind in ("flat", "torus")
                and south_is_rolled_north(face_coeffs64(problem)))
    return kernel_ready_kinetics(problem, kernel_families(problem))


def chunk_schedule(s: int, depth: int = CHUNK):
    """The chunks of one K2 step of s stages: [(first, count), ...] over
    its s + 1 RHS evaluations (0: F0 and Y1; e in 1..s-1: Y_{e+1} from
    f(Y_e); s: F1), C = ceil((s+1)/depth) chunks split evenly, chunk c
    taking evaluations [c (s+1) // C, (c+1) (s+1) // C), as the kernel
    computes them. A chunk of n evaluations takes its i-th (from 0) on
    the points depth - n + i + 1 rings or more inside its tile's region,
    so its last lands on the tile."""
    n_evals = s + 1
    n_chunks = -(-n_evals // depth)
    firsts = [c * n_evals // n_chunks for c in range(n_chunks + 1)]
    return [(a, b - a) for a, b in zip(firsts, firsts[1:])]


def grid_barriers(s: int) -> int:
    """K2's grid barriers in a launch of stage count s: one between
    chunks."""
    return len(chunk_schedule(s)) - 1


def chunk_plan(itemsize: int):
    """(tile, halo, slots, shared bytes) of K2's (and K9's) blocks: a
    CHUNK_TILE-square tile with a CHUNK-ring halo, each of the block's
    CHUNK_THREADS threads owning `slots` of the region's points, and
    CHUNK_PLANES planes of the region in dynamic shared memory, each with a
    guard of a row and a point on either side (csrc/tile_slots.cuh), and
    the profile operator's coefficients of the region's columns (three)
    and rows (beta and live); plus the warps' sums and the tile's squared
    errors, two variables, in static shared memory."""
    side = CHUNK_TILE + 2 * CHUNK
    slots = -(-side * side // CHUNK_THREADS)
    smem = (CHUNK_PLANES * (side * side + 2 * (side + 1)) + 5 * side
            + CHUNK_THREADS // 32 + 2 * CHUNK_TILE ** 2) * itemsize
    return CHUNK_TILE, CHUNK, slots, smem


def n_chunk_tiles(ny: int, nx: int) -> int:
    """K2's tiles on an ny x nx grid: the length of its partial sums."""
    return -(-ny // CHUNK_TILE) * -(-nx // CHUNK_TILE)


def kernel_info(dtype, divform: bool, kinetics_id: int) -> dict:
    """K2's CUDA kernel of (dtype, operator, kinetics) on the current
    card: its resident blocks an SM, registers a thread and shared bytes a
    block (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    cudaFuncGetAttributes)."""
    from crdmodel_tpu_torch.ops._build import kernel_info as query
    f64 = int(torch.empty((), dtype=dtype).element_size() == 8)
    if kinetics_id not in BASE_IDS:
        # the families' profile kernel (csrc/fused_rkc_families.cu)
        return query("crd_fused_rkc_families_info", f64, kinetics_id)
    return query("crd_fused_rkc_info", f64, int(divform), kinetics_id)


def tile_plan(halo: int, itemsize: int):
    """(tile_x, tile_y, shared bytes) of the one-pass RKC tile the shard
    step first ran on: the first of TILES whose four live buffers (y0, F0,
    Y_{j-1}, Y_{j-2}), two variables each, with a `halo`-ring border fit in
    shared memory. No kernel runs these tiles now; they define K9's partial
    sums (fused_shard_rkc.sum_tiles), so that a sharded run's error sums,
    and its steps, stay those of that kernel."""
    for tile_x, tile_y in TILES:
        smem = 8 * (tile_x + 2 * halo) * (tile_y + 2 * halo) * itemsize
        if smem <= SMEM_BYTES - 1024:       # room for the static reduction
            return tile_x, tile_y, smem
    raise ValueError(f"a {halo}-ring halo does not fit in shared memory")


def rkc_stage_coeffs(s, dtype):
    """(mu1, coeffs) of stage count s, computed by the recurrence in
    `dtype` (crdmodel_tpu/ops/pallas_rkc.py:263): coeffs (S_MAX_KERNEL+1, 4)
    with coeffs[j] = (mu_j, nu_j, mut_j, gt_j) for j in [2, s], zero
    elsewhere."""
    s = int(s)
    one = torch.ones((), dtype=dtype)
    sf = torch.tensor(s, dtype=dtype)
    w0 = one + rkc.EPS_DAMP / (sf * sf)
    _, dts, d2ts = rkc._cheb_scalars(s, w0)
    w1 = dts / d2ts
    dt2 = 4 * w0
    b2 = 4.0 / (dt2 * dt2)
    mu1 = b2 * w1
    tab = torch.zeros((S_MAX_KERNEL + 1, 4), dtype=dtype)
    tjm1, tjm2 = w0, one
    djm1, djm2 = one, torch.zeros_like(w0)
    d2jm1, d2jm2 = torch.zeros_like(w0), torch.zeros_like(w0)
    bjm1, bjm2 = b2, b2
    for j in range(2, s + 1):
        tj = 2 * w0 * tjm1 - tjm2
        dj = 2 * w0 * djm1 - djm2 + 2 * tjm1
        d2j = 2 * w0 * d2jm1 - d2jm2 + 4 * djm1
        bj = d2j / (dj * dj)
        mu = 2 * bj * w0 / bjm1
        nu = -bj / bjm2
        mut = 2 * bj * w1 / bjm1
        gt = -(one - bjm1 * tjm1) * mut
        tab[j] = torch.stack([mu, nu, mut, gt])
        tjm1, tjm2 = tj, tjm1
        djm1, djm2 = dj, djm1
        d2jm1, d2jm2 = d2j, d2jm1
        bjm1, bjm2 = bj, bjm1
    return mu1, tab


def static_stage_tables(s_cap: int, dtype, device="cpu",
                        with_times: bool = False):
    """mu1[s] (s_cap+1,) and ctab[s] (s_cap+1, S_MAX_KERNEL+1, 4) =
    rkc_stage_coeffs(s) for every s in [2, s_cap], computed in float64
    numpy and cast to `dtype` (crdmodel_tpu/ops/pallas_rkc.py:300-353).

    with_times: also ctimes[s, a] (s_cap+1, S_MAX_KERNEL+2), the normalised
    stage time of the RHS evaluation of amplitude column a (the offsets of
    the torch path's rkc2, integrate/rkc.py): a = 0 is F0 at t, a = j for
    j in [2, s] is f(Y_{j-1}) at t + c_{j-1} h, a = s + 1 is F1 at t + h
    (amp_column maps the kernel's evaluations onto them)."""
    mu1 = np.zeros((s_cap + 1,), np.float64)
    ctab = np.zeros((s_cap + 1, S_MAX_KERNEL + 1, 4), np.float64)
    ctimes = np.zeros((s_cap + 1, S_MAX_KERNEL + 2), np.float64)
    for s in range(2, s_cap + 1):
        w0 = 1.0 + rkc.EPS_DAMP / (s * s)
        T = np.zeros(s + 1)
        dT = np.zeros(s + 1)
        d2T = np.zeros(s + 1)
        T[0], T[1] = 1.0, w0
        dT[1] = 1.0
        for j in range(2, s + 1):
            T[j] = 2 * w0 * T[j - 1] - T[j - 2]
            dT[j] = 2 * w0 * dT[j - 1] - dT[j - 2] + 2 * T[j - 1]
            d2T[j] = 2 * w0 * d2T[j - 1] - d2T[j - 2] + 4 * dT[j - 1]
        w1 = dT[s] / d2T[s]
        b = np.zeros(s + 1)
        b[0] = b[1] = 1.0 / (4.0 * w0 * w0)   # b2 = 4/(4 w0)^2
        for j in range(2, s + 1):
            b[j] = d2T[j] / dT[j] ** 2
        mu1[s] = b[1] * w1
        for j in range(2, s + 1):
            mu = 2 * b[j] * w0 / b[j - 1]
            nu = -b[j] / b[j - 2]
            mut = 2 * b[j] * w1 / b[j - 1]
            gt = -(1.0 - b[j - 1] * T[j - 1]) * mut
            ctab[s, j] = (mu, nu, mut, gt)
            # c_{j-1} = w1 T''_{j-1} / T'_{j-1}, c_1 = w1 / (4 w0)
            ctimes[s, j] = (0.25 * w1 / w0 if j == 2
                            else w1 * d2T[j - 1] / dT[j - 1])
        ctimes[s, s + 1] = 1.0
    tables = (mu1, ctab, ctimes) if with_times else (mu1, ctab)
    return tuple(torch.tensor(a, dtype=dtype, device=device)
                 for a in tables)


def stage_times_table(s_cap: int, dtype, device="cpu"):
    """The stage-time table of a forced RKC kernel of stage cap s_cap:
    static_stage_tables(with_times=True)'s ctimes cut to its first
    s_cap + 2 columns, the most a step of s <= s_cap stages reads (K2's and
    K9's S_MAX_KERNEL + 2, the box kernels' C_RKC + 2:
    crdmodel_tpu/ops/pallas_box3d_rkc.py:595-598)."""
    ctimes = static_stage_tables(s_cap, dtype, device, with_times=True)[2]
    return ctimes[:, :s_cap + 2].contiguous()


def amp_column(e: int, n_cols: int) -> int:
    """The amplitude column of a step's RHS evaluation e (0: F0 and Y1; e
    in 1..s-1: f(Y_e); s: F1) in a table of n_cols columns
    (csrc/rkc_chunk.cuh::rkc_amp_column): 0 with one column, else the
    with_times index, 0 for F0 and e + 1 after."""
    return 0 if n_cols == 1 or e == 0 else e + 1


def stage_times_amplitudes(forcing, t, h, s, ctimes_tab, params, dtype):
    """The (n_stim, n_cols) amplitude table of one K2 step on t's device:
    (n_stim, 1) at t (segment-gated waveforms at params["_seg_end"]) when
    every stimulus is segment-gated, else (n_stim, S_MAX_KERNEL + 2) at
    the stage times t + ctimes[s] h of the step's stage count s (a 0-d
    int tensor, never read on the host) (crdmodel_tpu/ops/pallas_rkc.py:
    715-735)."""
    if all(getattr(st.waveform, "segment_gated", False)
           for st in forcing.stimuli):
        return forcing_amplitudes(forcing, t.reshape(1), params, dtype)
    ct = torch.index_select(ctimes_tab, 0, s.reshape(1).long())[0]
    return forcing_amplitudes(forcing, t + ct * h, params, dtype)


def rkc_forcing(stim, amps, y):
    """fe(e) -> the forcing of a K2 step's RHS evaluation e (amp_column of
    the table amps), or None without a forcing."""
    fs = forcing_of(stim, amps, y)
    if fs is None:
        return None
    return lambda e: fs(amp_column(e, amps.shape[-1]))


def fused_rkc_step_reference(y, h, fz, s, mu1_tab, ctab_tab,
                             kc: KernelConstants, rtol: float, atol: float,
                             stim=None, amps=None):
    """One step in plain torch: (y_new, ss) with ss a (1,) tensor holding
    the sum of squared WRMS-scaled errors. Reads the stage count s (a 0-d
    int tensor) on the host. kc is the profile operator's KernelConstants
    or the divergence form's DivformConstants (K4's RHS,
    kernel_common.make_divform_rhs_block); stim, amps a structured
    forcing's StimConstants and amplitude table, or None."""
    rhs_block = (make_divform_rhs_block(kc, fz) if kc.kind == "divform"
                 else make_rhs_block(kc, fz))
    return rkc_step_reference(y, h, s, mu1_tab, ctab_tab, rhs_block, rtol,
                              atol, rkc_forcing(stim, amps, y))


def rkc_step_reference(y, h, s, mu1_tab, ctab_tab, rhs_block, rtol: float,
                       atol: float, fe=None):
    """One RKC2 step of s stages (a 0-d int tensor, read on the host) on
    rhs_block(y) -> ydot in plain torch, in the order of the fused RKC
    kernels (csrc/fused_rkc.cu, csrc/fused_box3d_rkc.cu): (y_new, ss) with
    ss a (1,) tensor holding the sum of squared WRMS-scaled errors. fe(e)
    -> evaluation e's forcing (rkc_forcing), or None."""
    y_new, est = rkc_stages_reference(y, h, s, mu1_tab, ctab_tab, rhs_block,
                                      fe)
    return y_new, error_sum(est, y, rtol, atol)


def rkc_stages_reference(y, h, s, mu1_tab, ctab_tab, rhs_block, fe=None):
    """(y_new, est) of one RKC2 step of s stages on rhs_block(y) in plain
    torch, in the order of the fused RKC kernels; est is the order-2 error
    estimate; fe(e) -> the forcing of RHS evaluation e (0: F0; e in
    1..s-1: f(Y_e); s: F1), or None."""
    def f(e, x):
        return rhs_block(x) if fe is None else rhs_block(x, fe(e))

    n = int(s)
    mu1 = mu1_tab[n]
    f0 = f(0, y)
    yjm1, yjm2 = y + (h * mu1) * f0, y
    for j in range(2, n + 1):
        mu, nu, mut, gt = ctab_tab[n, j]
        fy = f(j - 1, yjm1)
        yj = ((1.0 - mu - nu) * y + mu * yjm1 + nu * yjm2
              + (h * mut) * fy + (h * gt) * f0)
        yjm1, yjm2 = yj, yjm1
    y_new = yjm1
    f1 = f(n, y_new)
    est = 0.8 * (y - y_new) + (0.4 * h) * (f0 + f1)
    return y_new, est


def fused_rkc_tile_sums(y, h, fz, s, mu1_tab, ctab_tab, kc: KernelConstants,
                        rtol: float, atol: float, stim=None, amps=None):
    """The kernel's partial sums in plain torch: (n_chunk_tiles(ny, nx),),
    one a CHUNK_TILE-square tile, each in the one-pass kernel's order
    (CHUNK_THREADS threads over the tile, fused_kstep.tile_error_sums)."""
    # imported here: fused_kstep imports fused_step, as this module does
    from crdmodel_tpu_torch.ops.fused_kstep import tile_error_sums
    rhs_block = (make_divform_rhs_block(kc, fz) if kc.kind == "divform"
                 else make_rhs_block(kc, fz))
    _, est = rkc_stages_reference(y, h, s, mu1_tab, ctab_tab, rhs_block,
                                  rkc_forcing(stim, amps, y))
    return tile_error_sums(est, y, rtol, atol, CHUNK_TILE, CHUNK_TILE,
                           CHUNK_THREADS)


def check_stage_tables(mu1_tab, ctab_tab, dtype, device) -> int:
    """The s_cap of static_stage_tables mu1_tab, ctab_tab; raises unless
    they are `dtype` tensors on `device` of some s_cap in
    [2, S_MAX_KERNEL]."""
    s_cap = mu1_tab.shape[0] - 1
    if not 2 <= s_cap <= S_MAX_KERNEL:
        raise ValueError(f"tables for s_cap={s_cap}; the kernel takes "
                         f"2..{S_MAX_KERNEL}")
    check_tensor("mu1_tab", mu1_tab, (s_cap + 1,), dtype, device)
    check_tensor("ctab_tab", ctab_tab, (s_cap + 1, S_MAX_KERNEL + 1, 4),
                 dtype, device)
    return s_cap


def fused_rkc_step(y, h, fz, s, mu1_tab, ctab_tab, kc: KernelConstants,
                   rtol: float, atol: float, stim=None, amps=None):
    """One fused RKC2 step: (y_new (nvars, ny, nx), ss partials
    (n_chunk_tiles(ny, nx),)).

    h and fz are 0-d tensors in y's dtype, s a 0-d int32 tensor, and
    mu1_tab/ctab_tab the static_stage_tables of some s_cap <= S_MAX_KERNEL,
    all on y's device: the kernel reads s and its table rows there, so a
    step needs no host sync. An s outside [2, s_cap] makes the kernel
    return NaN partial sums (a rejected step). kc's type picks the
    operator: KernelConstants the profile branch, DivformConstants the
    divergence branch. stim, amps: a structured forcing's StimConstants
    and its amplitude table on y's device (stage_times_amplitudes: one
    column, or S_MAX_KERNEL + 2), or None (the unforced kernel). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises. `fused_rkc_step.launches` counts kernel launches.
    """
    if y.device.type == "cpu":
        return fused_rkc_step_reference(y, h, fz, s, mu1_tab, ctab_tab, kc,
                                        rtol, atol, stim, amps)
    if y.device.type != "cuda":
        raise ValueError(f"no fused RKC step kernel for device {y.device}")
    dtype, device = y.dtype, y.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {dtype}")
    check_state(y, kc)
    nv, ny, nx = y.shape
    s_cap = check_stage_tables(mu1_tab, ctab_tab, dtype, device)
    check_tensor("y", y, y.shape, dtype, device)
    check_tensor("h", h, (), dtype, device)
    check_tensor("fz", fz, (), dtype, device)
    check_tensor("s", s, (), torch.int32, device)
    check_constants(kc, ny, nx, dtype, device)
    forcing_args = stim_args(stim, amps, (1, S_MAX_KERNEL + 2))

    from crdmodel_tpu_torch.ops._build import load_library
    lib = load_library()
    y_new = torch.empty_like(y)
    ss = torch.empty(n_chunk_tiles(ny, nx), dtype=dtype, device=device)
    work = torch.empty((SCRATCH_PLANES_PER_VAR * nv, ny, nx), dtype=dtype,
                       device=device)
    launch = getattr(lib, launcher_symbol("crd_fused_rkc_step", kc)
                     + ("_f32" if dtype == torch.float32 else "_f64"))
    # the operator: three profiles (or scalars) and the torus flag, or the
    # face fields aE, aW, aN and the tissue field (a null pointer without
    # an obstacle); the other operator's pointers are null
    ptrs = [c.data_ptr() for c in kc.coeffs]
    if kc.kind == "divform":
        tissue = None if kc.tissue is None else kc.tissue.data_ptr()
        operator = (None, None, None, 0, *ptrs, tissue)
    elif kc.kind in ("torus", "flat"):
        operator = (*ptrs, int(kc.kind == "torus"), None, None, None, None)
    else:
        raise ValueError(f"the RKC kernel takes profile or divergence-form "
                         f"constants, not {kc.kind!r}")
    # the CUDA runtime launches on the current device: make it y's
    with torch.cuda.device(device):
        rc = launch(y.data_ptr(), y_new.data_ptr(), ss.data_ptr(),
                    work.data_ptr(), h.data_ptr(), fz.data_ptr(),
                    *forcing_args, s.data_ptr(), mu1_tab.data_ptr(),
                    ctab_tab.data_ptr(), s_cap, *operator, kc.b.data_ptr(), int(kc.b_is_field),
                    kc.mask.data_ptr(), int(kc.has_freeze), kc.kinetics_id,
                    ny, nx, float(rtol), float(atol),
                    torch.cuda.current_stream(device).cuda_stream)
    fused_rkc_step.launches += 1
    if rc != 0:
        raise RuntimeError(f"fused RKC step kernel launch failed: CUDA "
                           f"error {rc}")
    return y_new, ss


fused_rkc_step.launches = 0


@dataclasses.dataclass(frozen=True)
class FusedRKCStep:
    step_err: Callable      # (t, y, h, params, carry=()) -> (y_new, err_ss, ())
    h_limit: Callable       # (t, y, params) -> stability-capped max h


def build_fused_rkc_step(problem, dtype=torch.float32,
                         rho_fn=None) -> FusedRKCStep:
    """The fused RKC2 step of `problem` in `dtype` on its device
    (crdmodel_tpu/ops/pallas_rkc.py:365, the profile branch, or the
    divergence branch when needs_divform(problem); one column block at
    every width). The freeze comes from params["_seg_end"]; t enters only
    through a structured forcing's amplitudes (the kinetics are
    autonomous)."""
    cfg = problem.cfg
    device = problem.device
    if rho_fn is None:
        rho_fn = make_rho_bound(cfg, problem.model, problem.geometry, dtype,
                                diffusion_field=problem.diffusion_field,
                                face_mask=problem.face_mask)
    prepare = (prepare_divform_constants if needs_divform(problem)
               else prepare_constants)
    kc = prepare(problem, dtype, device)
    stim = prepare_stim_constants(problem, dtype, device)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    t_boundary = float(cfg.t_boundary)
    s_cap = S_MAX_KERNEL
    mu1_tab, ctab_tab, ctimes_tab = static_stage_tables(s_cap, dtype, device,
                                                        with_times=True)

    def step_err(t, y, h, params, carry=()):
        h = h.to(dtype)
        rho = rho_fn(t, y, params).to(dtype)
        s = torch.clamp_max(rkc.choose_stages(h, rho), s_cap)
        fz = freeze_scalar(params, kc.has_freeze, t_boundary, dtype)
        amps = (None if stim is None else stage_times_amplitudes(
            stim.forcing, t, h, s, ctimes_tab, params, dtype))
        y_new, ss = fused_rkc_step(y, h, fz, s, mu1_tab, ctab_tab, kc, rtol,
                                   atol, stim, amps)
        return y_new, torch.sum(ss), ()

    def h_limit(t, y, params):
        """Largest h the s_cap-stage budget stabilizes."""
        rho = rho_fn(t, y, params).to(dtype)
        return (rkc.STAB_FACTOR * (s_cap - 1) ** 2
                / torch.clamp_min(rho, 1e-30)).to(dtype)

    return FusedRKCStep(step_err=step_err, h_limit=h_limit)
