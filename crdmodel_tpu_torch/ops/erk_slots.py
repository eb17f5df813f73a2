"""The register-resident ERK tile scheme of kernels K1, K4, K5, K8 and K11
(csrc/erk_slots.cuh): its plan and its dispatch on the tableau, mirrored
here for the tests and for chip_smoke.py's reports, and the kernels'
attribute queries.

A block of THREADS threads takes one of K1's tiles (fused_step.tile_plan:
32 x 32 for bs32, in f32 and f64) with STAGES rings; its threads are fixed
to the tile and its first STAGES - 1 rings, `slots` points each, and a
point's stage inputs, error and coefficients stay in its thread's
registers. The scheme takes an FSAL tableau of STAGES stages (bs32); the
launchers send the others the gates take (zonneveld43, dopri54) to K1's
scheme (csrc/erk_tile.cuh). Both write one partial sum a tile in K1's
order, so the partial sums have the same length and the same bits.
"""

from __future__ import annotations

import numpy as np

from crdmodel_tpu_torch.integrate.erk import Tableau
from crdmodel_tpu_torch.ops import fused_step

THREADS = 512           # csrc/erk_slots.cuh kSlotThreads
STAGES = 4              # kSlotStages: bs32
SLOTS_KERNEL = "fused_erk_slots_kernel"
TILE_KERNEL = "fused_erk_tile_kernel"
KERNELS = (SLOTS_KERNEL, TILE_KERNEL)


def uses_slots(tableau: Tableau) -> bool:
    """The launchers' dispatch (erk_slots.cuh::slots_take): STAGES stages
    and FSAL, the last stage's input the update (a[-1] == b exactly)."""
    return (tableau.stages == STAGES
            and bool(np.array_equal(tableau.a[-1], tableau.b)))


def kernel_name(tableau: Tableau) -> str:
    """The kernel a K1, K4, K5, K8 or K11 launch of `tableau` runs."""
    return SLOTS_KERNEL if uses_slots(tableau) else TILE_KERNEL


def slots_plan(itemsize: int, op_planes: int = 0):
    """(tile_y, region, slots, shared bytes) of the scheme's blocks in a
    dtype of `itemsize` bytes: K1's tile for STAGES stages with STAGES
    rings (`region` = (width, rows) of the stage planes); the slots cover
    the region less its outer ring, THREADS threads `slots` points each;
    the dynamic shared memory holds the two stage planes, the operator's
    `op_planes` planes (K11's aniso mode: Dxy; K5: dxyw) and the tile's
    squared errors of both variables; the static the warps' sums."""
    tile_x, tile_y, _ = fused_step.tile_plan(STAGES, itemsize)
    width, rows = tile_x + 2 * STAGES, tile_y + 2 * STAGES
    slots = -(-(width - 2) * (rows - 2) // THREADS)
    elements = ((2 + op_planes) * width * rows + 2 * tile_x * tile_y
                + THREADS // 32)
    return tile_y, (width, rows), slots, elements * itemsize


def kernel_info(symbol: str, dtype, *args) -> dict:
    """The bs32 kernel of a launcher's info query (K1
    `crd_fused_erk_step_info`, and `crd_fused_erk_step_families_info` for
    the six families beyond the base three, K4 `crd_fused_divform_info`, K5
    `crd_fused_aniso_info` and K8 `crd_fused_shard_step_info` with args
    (kinetics,), K11
    `crd_fused_shard_divform_info` with (mode, kinetics)) on the current
    card: resident blocks an SM, registers a thread, shared bytes a block."""
    import torch

    from crdmodel_tpu_torch.ops._build import kernel_info as query
    f64 = int(torch.empty((), dtype=dtype).element_size() == 8)
    return query(symbol, f64, *args)
