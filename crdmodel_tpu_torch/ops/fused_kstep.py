"""Speculative K-step fused ERK kernel, kernel K14 (counterpart of
crdmodel_tpu/ops/pallas_kstep.py).

One launch takes K embedded ERK steps of the 5-point profile operator with
one frozen step size h, chained by FSAL (the last stage of sub-step j is
the first of sub-step j + 1), and returns the state of one sub-step,
n_commit, with the K sub-steps' partial sums of squared WRMS-scaled errors
(csrc/fused_kstep.cu). The adaptive loop validates each sub-step against
the WRMS test and commits the longest accepted prefix
(integrate/erk.py::integrate_interval_kernel_batched): one controller
update a batch instead of one a step, and two launches a batch where the
per-step loop issues some 70 small torch ops a step.

  fused_kstep            the wrapper: launches the CUDA kernel for a CUDA
                         tensor, runs fused_kstep_reference for a CPU tensor
  fused_kstep_reference  the same K sub-steps in plain torch, the kernel's
                         oracle
  build_fused_kstep      a problem's call(t, y, h, n_commit, params, full)

Semantics kept from the TPU kernel (pallas_kstep.py:154-205): sub-step j's
stages are K1's (ops/fused_step.py), its first stage the previous
sub-step's last; its error weights come from the state before it; its
state is committed iff n_commit >= j + 1, so n_commit = 0 is the identity.
Sub-step j's state is therefore bitwise j plain K1 steps. The TPU layout
is gone (row strips, the deep halo P = halo_for(tableau, K) ring a RHS
evaluation, the lane padding): the CUDA kernel takes each sub-step in one
pass over K1's tiles with n - 1 rings (kstep_plan) and a grid barrier
between sub-steps, so any K fits, and its partial sums are K1's, one per
K1 tile and sub-step, in K1's order. Two device codes of n_commit serve the
loop's launches without a host read: n_commit < 0 returns at once (a masked
speculative launch, or a recovery launch after an accepted batch); a
recovery launch (full=False) with n_commit <= -2 copies y (a masked
iteration). A recovery launch computes only the first n_commit sub-steps,
and its sums are unspecified.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from crdmodel_tpu_torch.integrate.erk import Tableau
from crdmodel_tpu_torch.ops import fused_step
from crdmodel_tpu_torch.ops.fused_step import (MAX_STAGES, _stage_arrays,
                                               erk_stages_from, error_sum,
                                               tile_plan)
from crdmodel_tpu_torch.ops.kernel_common import (KernelConstants,
                                                  check_constants,
                                                  check_tensor,
                                                  freeze_scalar,
                                                  kernel_ready_kinetics,
                                                  make_rhs_block,
                                                  prepare_constants)

HALO = 8        # crdmodel_tpu/ops/pallas_step.py HALO, max_k's default
THREADS = 512   # the kernel's blocks (csrc/fused_kstep.cu kThreads)
# (n_stages, tile_y) of the kernel's instantiations a dtype's item size:
# bs32 and dopri54, the FSAL tableaus, at K1's tiles
KERNEL_TILES = {4: {(4, 32), (7, 32)}, 8: {(4, 32), (7, 16)}}


def halo_for(tableau: Tableau, k: int) -> int:
    """The JAX kernel's halo depth (pallas_kstep.py:68-74): the smallest
    multiple of 8 covering the 1 + (s-1)K (FSAL) or sK RHS evaluations of a
    batch. The CUDA kernel has no halo; the gate keeps JAX's number."""
    evals = (1 + (tableau.stages - 1) * k if tableau.fsal
             else tableau.stages * k)
    return max(8, -(-evals // 8) * 8)


def max_k(tableau: Tableau, halo: int = HALO) -> int:
    """Largest K whose RHS evaluations fit in a halo of `halo` rings
    (pallas_kstep.py:77-81)."""
    if not tableau.fsal:
        return halo // tableau.stages
    return (halo - 1) // (tableau.stages - 1)


def is_kstep_supported(problem, tableau: Tableau, dtype, k: int) -> bool:
    """The kernel's gate (crdmodel_tpu/ops/pallas_kstep.py:84-100) without
    the TPU strip rules: no forcing, an FSAL tableau, k >= 1, K1's gate
    (ops/fused_step.py::is_supported) and k <= max_k at JAX's halo. K1's
    gate also declines a diffusion tensor, which JAX's K1 gate leaves to
    its driver (ROADMAP queue 3)."""
    if problem.forcing is not None:
        return False
    if not tableau.fsal or k < 1:
        return False
    P = halo_for(tableau, k)
    if tableau.stages > P:
        return False
    if not (fused_step.is_supported(problem, tableau, dtype)
            and kernel_ready_kinetics(problem)):
        return False
    return k <= max_k(tableau, P)


def kstep_plan(n_stages: int, itemsize: int):
    """(tile_y, halo, slots, shared bytes) of the kernel's blocks for an
    n_stages tableau: K1's tile (fused_step.tile_plan) and n_stages - 1
    rings, each of the block's THREADS threads owning `slots` of the
    region's points; the static shared memory holds two planes of the
    stage input's variable 0 on the region, each with a guard of a row
    and a point on either side (csrc/tile_slots.cuh), two of the tile's
    squared errors, the tableau's h a and h d, and the warps' sums."""
    _, tile_y, _ = tile_plan(n_stages, itemsize)
    halo = n_stages - 1
    width = fused_step.TILE_X + 2 * halo
    region = width * (tile_y + 2 * halo)
    slots = -(-region // THREADS)
    smem = (2 * (region + 2 * (width + 1))
            + 2 * fused_step.TILE_X * tile_y + n_stages ** 2 + n_stages
            + THREADS // 32) * itemsize
    return tile_y, halo, slots, smem


def grid_barriers(steps: int) -> int:
    """The kernel's grid barriers in a launch that computes `steps`
    sub-steps: one after the pre-pass that evaluates k_0 = f(y), one
    between sub-steps."""
    return steps


def kernel_info(dtype, kinetics_id: int, n_stages: int) -> dict:
    """The CUDA kernel of (dtype, kinetics, tableau) on the current card:
    its resident blocks an SM, registers a thread and static shared bytes
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, cudaFuncGetAttributes)."""
    from crdmodel_tpu_torch.ops._build import kernel_info as query
    itemsize = torch.empty((), dtype=dtype).element_size()
    tile_y = kstep_plan(n_stages, itemsize)[0]
    return query("crd_fused_kstep_info", int(itemsize == 8), kinetics_id,
                 n_stages, tile_y)


def tile_error_sums(err, y, rtol: float, atol: float, tile_y: int,
                    tile_x: int = fused_step.TILE_X, threads: int = 256):
    """(n_tiles,) partial sums of squared WRMS-scaled errors (weights from
    y) in the ERK tile kernels' order (csrc/erk_tile.cuh): one sum a
    tile_y x tile_x tile, tile t at tile row t // tiles_x; a block's
    `threads` threads each add every variable's square (in variable
    order) of every point q = tid + threads m in turn, then a warp-shuffle tree and the warps in order.
    The plain version of every partial sum the kernels write."""
    scaled = err * (1.0 / (rtol * torch.abs(y) + atol))
    sq = scaled * scaled
    nv, ny, nx = sq.shape
    pad_y, pad_x = -ny % tile_y, -nx % tile_x
    # padded points add +0.0: the sums are non-negative, so exact
    sq = torch.nn.functional.pad(sq, (0, pad_x, 0, pad_y))
    n_ty, n_tx = (ny + pad_y) // tile_y, (nx + pad_x) // tile_x
    per_tile = tile_y * tile_x
    slots = -(-per_tile // threads)
    pts = (sq.reshape(nv, n_ty, tile_y, n_tx, tile_x).permute(0, 1, 3, 2, 4)
           .reshape(nv, n_ty * n_tx, per_tile))
    # a tile smaller than the block: its last threads add +0.0 (exact)
    pts = torch.nn.functional.pad(pts, (0, slots * threads - per_tile))
    pts = pts.reshape(nv, n_ty * n_tx, slots, threads)
    acc = torch.zeros_like(pts[0, :, 0])
    for m in range(pts.shape[2]):
        for var in range(nv):
            acc = acc + pts[var, :, m]
    return block_sums(acc)


def block_sums(acc):
    """(n,) the sums of n blocks' per-thread values acc (n, threads) in the
    kernels' order (rhs_common.cuh::store_block_sum): a warp-shuffle tree
    in each warp of 32 threads, then the warps' sums in order."""
    acc = acc.reshape(acc.shape[0], acc.shape[1] // 32, 32)
    off = 16
    while off:
        acc = acc[..., :off] + acc[..., off:2 * off]
        off //= 2
    total = torch.zeros_like(acc[:, 0, 0])
    for w in range(acc.shape[1]):
        total = total + acc[:, w, 0]
    return total


def fused_kstep_reference(y, h, fz, n_commit, kc: KernelConstants,
                          tableau: Tableau, k: int, rtol: float, atol: float,
                          full: bool = True, tile_y=None):
    """K sub-steps in plain torch: (y_committed, sums (1, k)), each column
    a sub-step's error_sum; with tile_y, sums (n_tiles, k) in the kernel's
    order (tile_error_sums). Reads n_commit on the host. n_commit < 0
    computes nothing and gives y with NaN sums (the kernel returns at once
    or, for a recovery launch, copies y); full=False computes only the
    first min(n_commit, k) sub-steps (the other sums NaN)."""
    n = int(n_commit)
    commit = min(max(n, 0), k)
    steps = 0 if n < 0 else (k if full else commit)
    rhs_block = make_rhs_block(kc, fz)
    sums = []
    committed = y
    k1 = rhs_block(y) if steps else None
    for j in range(steps):
        y_new, err, k_last = erk_stages_from(y, h, rhs_block, tableau, k1)
        sums.append(error_sum(err, y, rtol, atol) if tile_y is None
                    else tile_error_sums(err, y, rtol, atol, tile_y))
        if j + 1 == commit:
            committed = y_new
        y, k1 = y_new, k_last
    n_rows = 1 if tile_y is None else _n_tiles(y.shape[1], y.shape[2],
                                               tile_y)
    nan = torch.full((n_rows,), float("nan"), dtype=y.dtype, device=y.device)
    sums += [nan] * (k - len(sums))
    return committed, torch.stack(sums, dim=1)


def _n_tiles(ny: int, nx: int, tile_y: int) -> int:
    return -(-nx // fused_step.TILE_X) * -(-ny // tile_y)


_COUNTS = {}


def work_counts(device) -> torch.Tensor:
    """The (2,) int32 tensor on `device` that counts the launches that did
    work: [0] speculative (full) launches with n_commit >= 0, the batches;
    [1] recovery launches with n_commit >= 0, the rejected batches. The
    kernel adds to it on the card, the plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _COUNTS:
        _COUNTS[device] = torch.zeros(2, dtype=torch.int32, device=device)
    return _COUNTS[device]


def fused_kstep(y, h, fz, n_commit, kc: KernelConstants, tableau: Tableau,
                k: int, rtol: float, atol: float, full: bool = True):
    """K fused sub-steps: (y_committed (2, ny, nx), partials (n_blocks, k)).

    h and fz are 0-d tensors in y's dtype on y's device, n_commit a 0-d
    int32 tensor there (or a Python int), so a batch needs no host read.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (float32, or float64 as a parity tool) or raises. `fused_kstep.launches`
    counts kernel launches, work_counts those that did work.
    """
    device = y.device
    if device.type == "cpu":
        if int(n_commit) >= 0:
            work_counts(device)[0 if full else 1] += 1
        return fused_kstep_reference(y, h, fz, n_commit, kc, tableau, k,
                                     rtol, atol, full)
    if device.type != "cuda":
        raise ValueError(f"no K-step kernel for device {device}")
    if not torch.is_tensor(n_commit):
        n_commit = torch.tensor(n_commit, dtype=torch.int32, device=device)
    dtype = y.dtype
    if kc.kind not in ("torus", "flat"):
        raise ValueError(f"the K-step kernel takes profile constants, not "
                         f"{kc.kind!r}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {dtype}")
    if y.dim() != 3 or y.shape[0] != 2:
        raise ValueError(f"y must be (2, ny, nx), got {tuple(y.shape)}")
    n_stages = tableau.stages
    if not tableau.fsal or not 2 <= n_stages <= MAX_STAGES:
        raise ValueError(f"{tableau.name}: the kernel takes FSAL tableaus "
                         f"of 2..{MAX_STAGES} stages")
    if k < 1:
        raise ValueError(f"k = {k}; the kernel takes k >= 1")
    tile_y = kstep_plan(n_stages, y.element_size())[0]
    if (n_stages, tile_y) not in KERNEL_TILES[y.element_size()]:
        raise ValueError(f"{tableau.name}: no K-step kernel for "
                         f"{n_stages} stages in {dtype}")
    _, ny, nx = y.shape
    check_tensor("y", y, y.shape, dtype, device)
    check_tensor("h", h, (), dtype, device)
    check_tensor("fz", fz, (), dtype, device)
    check_tensor("n_commit", n_commit, (), torch.int32, device)
    check_constants(kc, ny, nx, dtype, device)

    from crdmodel_tpu_torch.ops._build import load_library
    lib = load_library()
    y_out = torch.empty_like(y)
    ss = torch.empty((_n_tiles(ny, nx, tile_y), k), dtype=dtype,
                     device=device)
    # two sub-step states and two first stages, each in turns
    work = torch.empty((4, *y.shape), dtype=dtype, device=device)
    a, b, d = _stage_arrays(tableau.name)
    launch = (lib.crd_fused_kstep_f32 if dtype == torch.float32
              else lib.crd_fused_kstep_f64)
    # the CUDA runtime launches on the current device: make it y's
    with torch.cuda.device(device):
        rc = launch(y.data_ptr(), y_out.data_ptr(), ss.data_ptr(),
                    work.data_ptr(), h.data_ptr(), fz.data_ptr(),
                    n_commit.data_ptr(), work_counts(device).data_ptr(),
                    int(full), k, *(c.data_ptr() for c in kc.coeffs),
                    int(kc.kind == "torus"), kc.b.data_ptr(),
                    int(kc.b_is_field), kc.mask.data_ptr(),
                    int(kc.has_freeze), kc.kinetics_id, ny, nx, tile_y,
                    n_stages, a, b, d, float(rtol), float(atol),
                    torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"crd_fused_kstep launch failed: CUDA error {rc}")
    fused_kstep.launches += 1
    return y_out, ss


fused_kstep.launches = 0


@dataclasses.dataclass(frozen=True)
class FusedKStep:
    call: Callable     # (t, y, h, n_commit, params, full) -> (y, (n_blocks, k))
    k: int


def build_fused_kstep(problem, tableau: Tableau, k: int) -> FusedKStep:
    """The K-step kernel of `problem` (crdmodel_tpu/ops/pallas_kstep.py:112)
    in the problem's dtype on its device: call(t, y, h, n_commit, params,
    full=True), the freeze from params["_seg_end"] as in
    fused_step.build_fused_step; t is unused (the kinetics are
    autonomous)."""
    if not tableau.fsal or k < 1:
        raise ValueError(f"{tableau.name} with k = {k}: the K-step kernel "
                         "takes an FSAL tableau and k >= 1")
    cfg = problem.cfg
    dtype = problem.y0.dtype
    kc = prepare_constants(problem, dtype, problem.device)
    rtol, atol = float(cfg.rtol), float(cfg.atol)
    t_boundary = float(cfg.t_boundary)

    def call(t, y, h, n_commit, params, full=True):
        fz = freeze_scalar(params, kc.has_freeze, t_boundary, dtype)
        return fused_kstep(y, h.to(dtype), fz, n_commit, kc, tableau, k,
                           rtol, atol, full)

    return FusedKStep(call=call, k=k)
