"""Fused embedded-ERK step, kernel K1 (counterpart of
crdmodel_tpu/ops/pallas_step.py).

One launch performs a whole embedded Runge–Kutta step of the 5-point
profile operator with the kinetics of any of the nine families (a
template parameter of the kernel, KernelConstants.kinetics_id): every
stage's stencil, on each diffusing variable, and kinetics, the solution
update, and per-block partial sums of squared WRMS-scaled errors
(csrc/fused_step.cu for the base three families, fused_step_families.cu
for the other six, unforced; kernel_common.launcher_symbol). It takes
every attempted step of a run on the fused path (sim.py).

  fused_step            the wrapper: launches the CUDA kernel for a CUDA
                        tensor, runs fused_step_reference for a CPU tensor
  fused_step_reference  the same step in plain torch, the kernel's oracle
  fused_step_tile_sums  the plain version of the kernel's partial sums, one
                        a tile in its order
  build_fused_step      a problem's step_err(t, y, h, params) on top of it

bs32, the main path's tableau, runs the register-resident scheme
(csrc/erk_slots.cuh: a point's stage values and coefficients in its
thread's registers), zonneveld43 and dopri54 the one-pass tile of
csrc/erk_tile.cuh: the launcher's dispatch on the stage count
(ops/erk_slots.py::kernel_name). Both write one partial sum a tile, in
the same order, so y_new and the sums do not depend on the scheme.

Semantics kept from the TPU kernel (pallas_step.py:194-255): all stages
are evaluated (no FSAL), without t (the kinetics are autonomous); stage
inputs are y0 + (h*a[s][j])*k_j, the update and error (h*b[s])*k_s and
(h*d[s])*k_s with d = b - bhat, in that order; the row freeze multiplies
each stage by live = 1 - fz*(1 - m); the error weights come from the
step's start. A structured forcing (core/forcing.py::SeparableForcing,
rank-1 stimuli; pallas_step.py:164-192, 212-222, 303-308) is the one
place t enters: the step computes the stages' amplitudes at t + c_s h on
the device (kernel_common.stage_amplitudes) and the kernel adds
(amps[j, s] * row_j) * col_j to stage s's right-hand side before the
freeze (kernel_common.stim_terms in the plain version). The lane padding
and strip alignment of the TPU layout are gone: the state is (nvars, ny,
nx), contiguous.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from crdmodel_tpu_torch.integrate.erk import TABLEAUS, Tableau
from crdmodel_tpu_torch.ops.kernel_common import (SMEM_BYTES,
                                                  KernelConstants,
                                                  check_constants,
                                                  check_state,
                                                  check_tensor,
                                                  forcing_of,
                                                  freeze_scalar,
                                                  fused_forcing,
                                                  kernel_families,
                                                  kernel_ready_kinetics,
                                                  launcher_symbol,
                                                  make_rhs_block,
                                                  needs_divform,
                                                  prepare_constants,
                                                  prepare_stim_constants,
                                                  stage_amplitudes,
                                                  stim_args)

MAX_STAGES = 8                 # the kernel's StageTable bound
TILE_X = 32                    # tile width along x (contiguous)


def is_supported(problem, tableau: Tableau, dtype) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_step.py:89), without the
    TPU strip-divisor rule, plus the port-only kinetics rule
    (kernel_common.kernel_ready_kinetics over kernel_families: all nine
    families unforced, the base three forced). Divergence-form problems go to K4 (ops/fused_divform.py), problems
    with a diffusion tensor to K5 (ops/fused_aniso.py). A structured
    forcing is taken (kernel_common.fused_forcing: not a free-form
    one)."""
    if needs_divform(problem) or problem.diffusion_tensor is not None:
        return False
    if fused_forcing(problem) is False:
        return False
    if dtype != torch.float32:
        return False
    if tableau.stages > MAX_STAGES:
        return False
    return kernel_ready_kinetics(problem, kernel_families(problem))


def tile_plan(n_stages: int, itemsize: int, nvars: int = 2):
    """(tile_x, tile_y, shared bytes) of the kernel's tiles: the tallest of
    32/16/8 rows whose stage buffers (y0, yi and n_stages k, nvars
    variables each, with an n_stages-ring halo) fit in shared memory."""
    for tile_y in (32, 16, 8):
        pts = (TILE_X + 2 * n_stages) * (tile_y + 2 * n_stages)
        smem = nvars * (n_stages + 2) * pts * itemsize
        if smem <= SMEM_BYTES - 1024:       # room for the static reduction
            return TILE_X, tile_y, smem
    raise ValueError(f"{n_stages} stages do not fit in shared memory")


@functools.cache
def _stage_arrays(name: str):
    """ctypes copies of a tableau's a (row-major), b and d = b - bhat."""
    tab = TABLEAUS[name]
    d = tab.b - tab.bhat
    return tuple((ctypes.c_double * x.size)(*x.ravel().tolist())
                 for x in (tab.a, tab.b, d))


def erk_step_reference(y, h, rhs_block, tableau: Tableau, rtol: float,
                       atol: float, fs=None):
    """One step of `tableau` on rhs_block(y) -> ydot in plain torch, in the
    order of the ERK tile kernels (csrc/erk_tile.cuh): (y_new, ss) with ss
    a (1,) tensor holding the sum of squared WRMS-scaled errors. fs(s) ->
    stage s's forcing (kernel_common.forcing_of), or None."""
    y_new, err = erk_stages_reference(y, h, rhs_block, tableau, fs)
    return y_new, error_sum(err, y, rtol, atol)


def error_sum(err, y, rtol: float, atol: float):
    """(1,) sum of squared WRMS-scaled errors, weights from y, in the
    kernels' order."""
    scaled = err * (1.0 / (rtol * torch.abs(y) + atol))
    return torch.sum(scaled * scaled).reshape(1)


def erk_stages_reference(y, h, rhs_block, tableau: Tableau, fs=None):
    """(y_new, err) of one step of `tableau` on rhs_block(y) in plain torch,
    in the order of the ERK tile kernels; fs(s) -> stage s's forcing
    (rhs_block(y, fs(s))), or None."""
    k1 = rhs_block(y) if fs is None else rhs_block(y, fs(0))
    y_new, err, _ = erk_stages_from(y, h, rhs_block, tableau, k1, fs)
    return y_new, err


def erk_stages_from(y, h, rhs_block, tableau: Tableau, k1, fs=None):
    """erk_stages_reference with the first stage k1 given, as an FSAL
    tableau's previous step hands it on (ops/fused_kstep.py): (y_new, err,
    k_last), k_last the last stage."""
    a, bw = tableau.a, tableau.b
    d = tableau.b - tableau.bhat
    n = tableau.stages
    ks = [k1]
    for s in range(1, n):
        yi = y
        for j in range(s):
            if a[s, j] != 0.0:
                yi = yi + (h * float(a[s, j])) * ks[j]
        ks.append(rhs_block(yi) if fs is None else rhs_block(yi, fs(s)))
    y_new = y
    err = torch.zeros_like(y)
    for s in range(n):
        if bw[s] != 0.0:
            y_new = y_new + (h * float(bw[s])) * ks[s]
        if d[s] != 0.0:
            err = err + (h * float(d[s])) * ks[s]
    return y_new, err, ks[-1]


def fused_step_reference(y, h, fz, kc: KernelConstants, tableau: Tableau,
                         rtol: float, atol: float, stim=None, amps=None):
    """One step in plain torch: (y_new, ss) with ss a (1,) tensor holding
    the sum of squared WRMS-scaled errors. stim: the StimConstants of a
    structured forcing and amps its (n_stim, n_stages) amplitudes, or
    None."""
    return erk_step_reference(y, h, make_rhs_block(kc, fz), tableau, rtol,
                              atol, forcing_of(stim, amps, y))


def fused_step_tile_sums(y, h, fz, kc: KernelConstants, tableau: Tableau,
                         rtol: float, atol: float, stim=None, amps=None):
    """The kernel's partial sums in plain torch: (n_tiles,) sums of
    squared WRMS-scaled errors, one a tile of tile_plan, each in the ERK
    tile kernels' order (fused_kstep.tile_error_sums), as both of the
    kernel's schemes write them (csrc/erk_slots.cuh, erk_tile.cuh)."""
    # imported here: fused_kstep imports this module
    from crdmodel_tpu_torch.ops.fused_kstep import tile_error_sums
    _, err = erk_stages_reference(y, h, make_rhs_block(kc, fz), tableau,
                                  forcing_of(stim, amps, y))
    tile_y = tile_plan(tableau.stages, y.element_size(), y.shape[0])[1]
    return tile_error_sums(err, y, rtol, atol, tile_y)


def fused_step(y, h, fz, kc: KernelConstants, tableau: Tableau,
               rtol: float, atol: float, stim=None, amps=None):
    """One fused step: (y_new (nvars, ny, nx), ss partials (n_blocks,)).

    y lives on the device the step runs on. h and fz are 0-d tensors on the
    same device: the kernel reads them there, so a step needs no host sync.
    stim, amps: a structured forcing's StimConstants and its (n_stim,
    n_stages) amplitude table on the same device (stage_amplitudes), or
    None (the unforced kernel).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (float32, or float64 as a parity tool) or raises. bs32 runs the
    register-resident scheme (csrc/erk_slots.cuh), zonneveld43 and dopri54
    erk_tile.cuh's (erk_slots.kernel_name). `fused_step.launches` counts
    kernel launches.
    """
    if y.device.type == "cpu":
        return fused_step_reference(y, h, fz, kc, tableau, rtol, atol, stim,
                                    amps)
    if y.device.type != "cuda":
        raise ValueError(f"no fused step kernel for device {y.device}")
    if kc.kind not in ("torus", "flat"):
        raise ValueError(f"the profile kernel takes profile constants, not "
                         f"{kc.kind!r}")
    out = launch_erk_tile(
        launcher_symbol("crd_fused_erk_step", kc),
        (*(c.data_ptr() for c in kc.coeffs), int(kc.kind == "torus")),
        y, h, fz, kc, tableau, rtol, atol,
        stim_args(stim, amps, (tableau.stages,)))
    fused_step.launches += 1
    return out


fused_step.launches = 0


def launch_erk_tile(symbol, operator_args, y, h, fz, kc: KernelConstants,
                    tableau: Tableau, rtol: float, atol: float,
                    forcing_args=()):
    """Launch one step of an ERK tile kernel of the built library (K1
    `crd_fused_erk_step`, or `crd_fused_erk_step_families` for the
    NEW_FAMILIES, K4 `crd_fused_divform_step` and K5
    `crd_fused_aniso_step`, csrc/erk_slots.cuh for bs32 and erk_tile.cuh
    for the others): the launcher `symbol`_f32
    or _f64, with the forcing's arguments `forcing_args` (K1 and K4:
    kernel_common.stim_args) and the kernel's operator arguments
    `operator_args` after fz. Checks every input first and raises on what
    the kernel does not take, and on a launch error. Returns (y_new
    (nvars, ny, nx), ss partials (n_blocks,))."""
    dtype, device = y.dtype, y.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {dtype}")
    check_state(y, kc)
    n = tableau.stages
    if n > MAX_STAGES:
        raise ValueError(f"{n} stages; the kernel takes at most {MAX_STAGES}")
    _, ny, nx = y.shape
    check_tensor("y", y, y.shape, dtype, device)
    check_tensor("h", h, (), dtype, device)
    check_tensor("fz", fz, (), dtype, device)
    check_constants(kc, ny, nx, dtype, device)

    from crdmodel_tpu_torch.ops._build import load_library
    lib = load_library()
    tile_x, tile_y, _ = tile_plan(n, y.element_size(), y.shape[0])
    n_blocks = -(-nx // tile_x) * -(-ny // tile_y)
    y_new = torch.empty_like(y)
    ss = torch.empty(n_blocks, dtype=dtype, device=device)
    a, b, d = _stage_arrays(tableau.name)
    launch = getattr(lib, symbol + ("_f32" if dtype == torch.float32
                                    else "_f64"))
    # the CUDA runtime launches on the current device: make it y's
    with torch.cuda.device(device):
        rc = launch(y.data_ptr(), y_new.data_ptr(), ss.data_ptr(),
                    h.data_ptr(), fz.data_ptr(), *forcing_args,
                    *operator_args,
                    kc.b.data_ptr(), int(kc.b_is_field), kc.mask.data_ptr(),
                    int(kc.has_freeze), kc.kinetics_id, ny, nx, tile_x, tile_y,
                    n, a, b, d, float(rtol), float(atol),
                    torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
    return y_new, ss


def build_fused_step(problem, tableau: Tableau):
    """step_err(t, y, h, params) -> (y_new, err_ss) of `problem` through the
    fused step, in the problem's dtype on its device. The freeze comes from
    params["_seg_end"]; t enters only through a structured forcing's stage
    amplitudes (the kinetics are autonomous)."""
    cfg = problem.cfg
    dtype = problem.y0.dtype
    kc = prepare_constants(problem, dtype, problem.device)
    stim = prepare_stim_constants(problem, dtype, problem.device)
    c_nodes = torch.tensor(tableau.c, dtype=dtype, device=problem.device)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    t_boundary = float(cfg.t_boundary)

    def step_err(t, y, h, params):
        h = h.to(dtype)
        fz = freeze_scalar(params, kc.has_freeze, t_boundary, dtype)
        amps = (None if stim is None else stage_amplitudes(
            stim.forcing, t, h, c_nodes, params, dtype))
        y_new, ss = fused_step(y, h, fz, kc, tableau, rtol, atol, stim,
                               amps)
        return y_new, torch.sum(ss)

    return step_err
