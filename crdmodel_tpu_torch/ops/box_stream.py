"""The z-streaming scheme of kernels K6 and K12 (csrc/box_stream.cuh): its
plan, its dispatch on the tableau and its partial sums, mirrored here for
the tests and for chip_smoke.py; the kernels' attribute query; and a
plain-torch model of the pipeline's schedule.

A block of THREADS threads owns one in-plane tile of TILE_X x TILE_Y
output points and one chunk of z_chunk planes, and marches up z: iteration
p evaluates k_0 at plane p, k_1 at p - 1, k_2 at p - 2 and k_3 at p - 3, the
stage inputs' variable 0 in rings of three planes in shared memory, the
pointwise values with their points (in registers; a point's error in
shared memory in ERR_SHARED_MODES) (box_stream_model follows the same
schedule on whole planes). A chunk evaluates k_s on the n - 1 - s planes of the cone
beyond each of its ends, clamped to the box. The plan cuts z into chunks
where the tiles of one plane are fewer than MIN_TILES, so that a launch
fills a round of two blocks on each of the H100's 132 SMs. The scheme takes
an FSAL tableau of STAGES stages (bs32); the launchers send the others the
gates take (zonneveld43, dopri54) to the persistent kernels of
csrc/box3d.cuh. Each tile and chunk writes one partial sum, in an order
that stream_tile_sums replays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from crdmodel_tpu_torch.integrate.erk import Tableau
from crdmodel_tpu_torch.ops.fused_kstep import block_sums
from crdmodel_tpu_torch.ops.kernel_common import box_plane_rhs

THREADS = 512           # csrc/box_stream.cuh kStreamThreads
STAGES = 4              # kStreamStages: bs32
TILE_X = 32             # kStreamTileX
TILE_Y = 16             # kStreamTileY
MIN_TILES = 2 * 132     # blocks a launch should reach: two an SM
# the operator modes whose kernels keep a tile point's error in shared
# memory (box_stream.cuh::stream_err_shared); the profile mode keeps it in
# registers (the faster choice in each, measured at the slab's shapes)
ERR_SHARED_MODES = ("box_tissue", "box_field", "box_tensor")
STREAM_KERNEL = "fused_box_stream_kernel"
# the persistent kernels of the other tableaus: K6's and K12's
PERSISTENT_KERNELS = {False: "fused_box3d_step_kernel",
                      True: "fused_shard_box3d_kernel"}


def uses_stream(tableau: Tableau) -> bool:
    """The launchers' dispatch (box_stream.cuh::stream_take): STAGES stages
    and FSAL, the last stage's input the update (a[-1] == b exactly)."""
    return (tableau.stages == STAGES
            and bool(np.array_equal(tableau.a[-1], tableau.b)))


def kernel_name(tableau: Tableau, shard: bool = False) -> str:
    """The kernel a K6 (K12 with shard) launch of `tableau` runs."""
    return STREAM_KERNEL if uses_stream(tableau) else (
        PERSISTENT_KERNELS[shard])


def kernels(shard: bool = False) -> tuple:
    """The two kernels a K6 (K12) launch can run: stream, persistent."""
    return STREAM_KERNEL, PERSISTENT_KERNELS[shard]


def shared_bytes(itemsize: int, mode: str) -> int:
    """Shared bytes of a block in operator `mode` (box_stream.cuh::
    StreamPlan::bytes and the static warp sums): a ring of three planes
    for each of the STAGES stage inputs' variable 0 and the region's int
    in-plane offsets, on the tile and STAGES rings, and in the modes of
    ERR_SHARED_MODES the tile's errors of both variables on the STAGES
    planes in flight."""
    region = (TILE_X + 2 * STAGES) * (TILE_Y + 2 * STAGES)
    errs = 2 * STAGES * TILE_X * TILE_Y if mode in ERR_SHARED_MODES else 0
    return ((3 * STAGES * region + errs + THREADS // 32) * itemsize
            + 4 * region)


def stream_plan(itemsize: int, shape, halo: int | None = None,
                mode: str = "box_profile"):
    """(tile_y, z_chunk, n_tiles, shared bytes) of a launch on a state of
    (nz, ny, nx) planes in a dtype of `itemsize` bytes, the shared bytes
    those of operator `mode`; with `halo`, the shard's buffer, whose block
    (ny - 2 halo, nx - 2 halo) the tiles cover. z is cut into as few equal
    chunks as bring the tiles to MIN_TILES (at most one a plane); n_tiles
    counts tiles x chunks, the partial sums."""
    nz, ny, nx = shape
    if halo is not None:
        ny, nx = ny - 2 * halo, nx - 2 * halo
    in_plane = -(-ny // TILE_Y) * -(-nx // TILE_X)
    chunks = min(nz, -(-MIN_TILES // in_plane))
    z_chunk = -(-nz // chunks)
    chunks = -(-nz // z_chunk)
    return (TILE_Y, z_chunk, in_plane * chunks,
            shared_bytes(itemsize, mode))


def scaled_squares(err, y, rtol: float, atol: float):
    """The squared WRMS-scaled errors (weights from y) of every point, as
    the kernels form them."""
    scaled = err * (1.0 / (rtol * torch.abs(y) + atol))
    return scaled * scaled


def stream_tile_sums(sq, tile_y: int, z_chunk: int):
    """(n_tiles,) partial sums of the squares sq (2, nz, ny, nx) in the
    stream kernel's order: one a tile and z chunk, chunk-major, then tile
    row, then tile column; thread t of a block adds, plane by plane of its
    chunk and slot by slot (tile point t + THREADS m, row-major), u's
    square then v's; then store_block_sum's warp tree and the warps in
    order. Padded points add +0.0 (exact: the sums are non-negative)."""
    _, nz, ny, nx = sq.shape
    chunks = -(-nz // z_chunk)
    pad_z, pad_y, pad_x = (chunks * z_chunk - nz, -ny % tile_y,
                           -nx % TILE_X)
    sq = torch.nn.functional.pad(sq, (0, pad_x, 0, pad_y, 0, pad_z))
    n_ty, n_tx = (ny + pad_y) // tile_y, (nx + pad_x) // TILE_X
    slots = tile_y * TILE_X // THREADS
    pts = (sq.reshape(2, chunks, z_chunk, n_ty, tile_y, n_tx, TILE_X)
           .permute(0, 1, 3, 5, 2, 4, 6)
           .reshape(2, chunks * n_ty * n_tx, z_chunk, slots, THREADS))
    acc = torch.zeros_like(pts[0, :, 0, 0])
    for q in range(z_chunk):
        for m in range(slots):
            acc = acc + pts[0, :, q, m]
            acc = acc + pts[1, :, q, m]
    return block_sums(acc)


def box_stream_model(y, h, fz, bc, tableau: Tableau, z_chunk: int):
    """(y_new, err) of one step of `tableau` (one uses_stream takes) on the
    (2, nz, ny, nx) box state y computed on the stream kernel's schedule,
    in plain torch, on whole planes (x and y wrap, as the plain version's
    operator does): chunk by chunk, iteration p evaluates k_s at plane p -
    s inside the stage's cone; each stage input's variable 0 lives in a
    ring of three plane slots, plane q in slot q % 3, read at q - 1, q, q + 1
    with the stage input's plane clamped to the box; the pointwise values
    of the planes in flight pass from lag to lag, each stage's k added into
    every later stage input and the error as it is formed. Ring slots
    start as NaN and planes a chunk does not produce stay NaN, so a
    schedule that reads what it has not computed shows."""
    if not uses_stream(tableau):
        raise ValueError(f"{tableau.name}: the stream scheme takes FSAL "
                         f"tableaus of {STAGES} stages")
    n = STAGES
    a = tableau.a
    d = tableau.b - tableau.bhat
    nz = y.shape[1]
    rhs = box_plane_rhs(bc, fz, nz)
    nan = torch.full_like(y[0, 0], float("nan"))
    y_new = torch.full_like(y, float("nan"))
    err = torch.full_like(y, float("nan"))
    for z0 in range(0, nz, z_chunk):
        z1 = min(z0 + z_chunk, nz)
        lo = [max(z0 - (n - 1 - s), 0) for s in range(n)]
        hi = [min(z1 + (n - 1 - s), nz) for s in range(n)]
        rings = [[nan] * 3 for _ in range(n)]
        for k in (max(lo[0] - 1, 0), lo[0]):
            rings[0][k % 3] = y[0, k]
        lags = [None] * n
        for p in range(lo[0], z1 + n - 1):
            if p + 1 < nz:
                rings[0][(p + 1) % 3] = y[0, p + 1]
            if p < nz:
                lags[0] = dict(u={t: y[0, p] for t in range(1, n)},
                               v={t: y[1, p] for t in range(n)},
                               e=[torch.zeros_like(nan)] * 2)
            for s in range(n):
                q = p - s
                if not lo[s] <= q < hi[s]:
                    continue
                st, ring = lags[s], rings[s]
                k = rhs(q, ring[max(q - 1, 0) % 3],
                        torch.stack([ring[q % 3], st["v"][s]]),
                        ring[min(q + 1, nz - 1) % 3])
                for t in range(s + 1, n):
                    if a[t, s] != 0.0:
                        ha = h * float(a[t, s])
                        st["u"][t] = st["u"][t] + ha * k[0]
                        st["v"][t] = st["v"][t] + ha * k[1]
                if d[s] != 0.0:
                    hd = h * float(d[s])
                    st["e"] = [st["e"][0] + hd * k[0],
                               st["e"][1] + hd * k[1]]
                if s < n - 1:
                    rings[s + 1][q % 3] = st["u"][s + 1]
                else:
                    y_new[0, q], y_new[1, q] = st["u"][s], st["v"][s]
                    err[0, q], err[1, q] = st["e"]
            lags = [None] + lags[:-1]
    return y_new, err


def box_planes(bc, nz: int):
    """Box constants (kernel_common.prepare_box_constants) cut to the
    box's first nz planes: the stream scheme takes boxes of any depth,
    nz = 1 and 2 among them, where a configuration takes nz >= 3."""
    coeffs = (bc.coeffs[:4] + tuple(c[:nz] for c in bc.coeffs[4:])
              if bc.kind in ("box_profile", "box_tissue")
              else tuple(c[:nz] for c in bc.coeffs))
    tissue = getattr(bc, "tissue", None)
    return dataclasses.replace(bc, coeffs=coeffs, **(
        {} if tissue is None else {"tissue": tissue[:nz].contiguous()}))


def kernel_info(symbol: str, dtype, mode: int, kinetics: int) -> dict:
    """The stream kernel of a launcher's info query (K6
    `crd_fused_box3d_info`, K12 `crd_fused_shard_box3d_info`) in `mode`
    (ops/fused_box3d.py MODE_IDS) with `kinetics` on the current card:
    resident blocks an SM, registers a thread, shared bytes a block."""
    from crdmodel_tpu_torch.ops._build import kernel_info as query
    f64 = int(torch.empty((), dtype=dtype).element_size() == 8)
    return query(symbol, f64, mode, kinetics)
