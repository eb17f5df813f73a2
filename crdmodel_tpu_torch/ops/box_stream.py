"""The z-streaming scheme of kernels K6 and K12 (csrc/box_stream.cuh) and
of the RKC2 chunk kernels K7 and K13 on it (csrc/box_rkc_stream.cuh): its
plan, its dispatch on the tableau and its partial sums, mirrored here for
the tests and for chip_smoke.py; the kernels' attribute query; and plain-
torch models of the pipelines' schedules.

A block of THREADS threads owns one in-plane tile of TILE_X x TILE_Y
output points and one chunk of z_chunk planes, and marches up z: for bs32
iteration p evaluates k_0 at plane p, k_1 at p - 1, k_2 at p - 2 and k_3 at
p - 3, the stage inputs' variable 0 in rings of three planes in shared
memory, the pointwise values with their points (in registers; a point's
error in shared memory in ERR_SHARED_MODES) (box_stream_model follows the
same schedule on whole planes). A chunk evaluates k_s on the n - 1 - s
planes of the cone beyond each of its ends, clamped to the box. The plan
cuts z into chunks where the tiles of one plane are fewer than MIN_TILES,
so that a launch fills a round of two blocks on each of the H100's 132
SMs. The scheme takes an FSAL tableau of STAGES stages (bs32); the
launchers send the others the gates take (zonneveld43, dopri54) to the
persistent kernels of csrc/box3d.cuh. Each tile and chunk writes one
partial sum, in an order that stream_tile_sums replays.

K7's and K13's chunk kernel runs an RKC2 step's s + 1 right-hand side
evaluations in chunks of at most DEPTH (rkc_chunks), one launch a chunk,
each a pass of the same scheme whose evaluation i runs at plane p - i on
the tile and its n - 1 - i rings; the first chunk hands F0 and its last
two stage values to the second through device memory; on a shard a
chunk's tiles cover the block grown by the evaluations still to come
(box_rkc_stream_model follows the schedule on whole planes). The last
chunk writes y_new and the partial sums, in stream_tile_sums' order on the
last chunk's plan (RKC_MIN_TILES). It takes the operator modes of
RKC_STREAM_MODES, where it was the faster on the H100; K7 and K13 run the
others on their persistent kernels (rkc_uses_stream).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from crdmodel_tpu_torch.integrate.erk import Tableau
from crdmodel_tpu_torch.ops.fused_kstep import block_sums
from crdmodel_tpu_torch.ops.fused_rkc import chunk_schedule
from crdmodel_tpu_torch.ops.kernel_common import box_plane_rhs

THREADS = 512           # csrc/box_stream.cuh kStreamThreads
# kStreamDepth: the region's rings, the most evaluations a pass pipelines
DEPTH = 4
STAGES = DEPTH          # kStreamStages: bs32
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
# K7's and K13's chunk kernel (csrc/box_rkc_stream.cuh), the operator
# modes that take it (rkc_stream_take: where it was the faster at the
# slab's shapes on the H100; the others run K7's and K13's persistent
# kernels), the blocks its plan brings a launch to (one round of the 264
# resident blocks: the slab shard's 128 tiles in two z chunks) and the
# most stages a step takes (two chunks: kRkcStreamStages)
RKC_STREAM_KERNEL = "fused_box_rkc_stream_kernel"
RKC_STREAM_MODES = ("box_tensor",)
RKC_PERSISTENT_KERNELS = {False: "fused_box3d_rkc_kernel",
                          True: "fused_shard_box3d_rkc_kernel"}
RKC_MIN_TILES = 256
RKC_STAGES = 2 * DEPTH - 1


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


def rkc_uses_stream(mode: str) -> bool:
    """K7's and K13's dispatch on the operator mode (box_rkc_stream.cuh::
    rkc_stream_take): the chunk kernel in RKC_STREAM_MODES, the persistent
    kernels in the others."""
    return mode in RKC_STREAM_MODES


def rkc_kernel_name(mode: str, shard: bool = False) -> str:
    """The kernel a K7 (K13 with shard) step in operator `mode` runs."""
    return RKC_STREAM_KERNEL if rkc_uses_stream(mode) else (
        RKC_PERSISTENT_KERNELS[shard])


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


def rkc_shared_bytes(itemsize: int) -> int:
    """Shared bytes of a K7 or K13 chunk-kernel block
    (box_rkc_stream.cuh::rkc_stream_bytes and the static warp sums): the
    rings and offsets of shared_bytes, and F0's two variables on DEPTH
    planes at every slot of the region."""
    region = (TILE_X + 2 * DEPTH) * (TILE_Y + 2 * DEPTH)
    f0 = 2 * DEPTH * -(-region // THREADS) * THREADS
    return ((3 * DEPTH * region + f0 + THREADS // 32) * itemsize
            + 4 * region)


def stream_plan(itemsize: int, shape, halo: int | None = None,
                mode: str = "box_profile", rings: int = 0,
                min_tiles: int | None = None):
    """(tile_y, z_chunk, n_tiles, shared bytes) of a launch on a state of
    (nz, ny, nx) planes in a dtype of `itemsize` bytes, the shared bytes
    those of operator `mode`; with `halo`, the shard's buffer, whose block
    (ny - 2 halo, nx - 2 halo) the tiles cover, or (an RKC2 chunk's) the
    block grown by `rings`. z is cut into as few equal chunks as bring the
    block's tiles to min_tiles (MIN_TILES; K7's and K13's RKC_MIN_TILES),
    at most one a plane; n_tiles counts tiles x chunks, the partial
    sums."""
    nz, ny, nx = shape
    if halo is not None:
        ny, nx = ny - 2 * halo, nx - 2 * halo
    in_plane = -(-ny // TILE_Y) * -(-nx // TILE_X)
    chunks = min(nz, -(-(min_tiles or MIN_TILES) // in_plane))
    z_chunk = -(-nz // chunks)
    chunks = -(-nz // z_chunk)
    if halo is not None:
        in_plane = -(-(ny + 2 * rings) // TILE_Y) * -(-(nx + 2 * rings)
                                                     // TILE_X)
    return (TILE_Y, z_chunk, in_plane * chunks,
            shared_bytes(itemsize, mode))


def rkc_chunks(s: int, shard: bool = False):
    """The chunks of one K7 (K13 with shard) step of s stages,
    [(first, count, rings), ...]: fused_rkc.chunk_schedule with depth
    DEPTH, each chunk's tiles over the extent grown by `rings`: none on the
    whole box, on a shard the evaluations still to come
    (fused_shard_rkc.extent_rings), so the last chunk's are the block's."""
    return [(first, n, s + 1 - first - n if shard else 0)
            for first, n in chunk_schedule(s, DEPTH)]


def rkc_launches(s_cap: int) -> int:
    """The launches of a K7 or K13 step with tables of s_cap stages: one
    for each chunk the largest s has, whatever the step's s (a launch
    whose chunk s does not have returns at once)."""
    return -(-(s_cap + 1) // DEPTH)


def rkc_launch_blocks(shape, halo: int | None, s_cap: int):
    """The blocks of each launch of a K7 (K13 with `halo`) chunk-kernel
    step on a state of (nz, ny, nx) planes with tables of s_cap stages
    (box_rkc_stream.cuh::launch_box_rkc_stream): one launch a chunk, each
    of the most tiles any s in [2, s_cap] gives its chunk (the first also
    the last chunk's plan, on which it keeps y at an s out of range)."""
    blocks = ([stream_plan(4, shape, halo, min_tiles=RKC_MIN_TILES)[2]]
              + [0] * (rkc_launches(s_cap) - 1))
    for s in range(2, s_cap + 1):
        for c, (_, _, rings) in enumerate(rkc_chunks(s, halo is not None)):
            blocks[c] = max(blocks[c], stream_plan(
                4, shape, halo, rings=rings, min_tiles=RKC_MIN_TILES)[2])
    return blocks


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


def box_rkc_stream_model(y, h, s: int, mu1_tab, ctab_tab, fz, bc,
                         z_chunk: int, halo: int | None = None):
    """(y_new, est) of one RKC2 step of s stages on the (2, nz, ny, nx)
    state y computed on K7's schedule (K13's with `halo`, y then a
    shard's halo-padded buffer), in plain torch, on whole planes (x and y
    wrap, as the plain version's operator does): chunk by chunk
    (rkc_chunks), and in each z chunk iteration p takes the chunk's
    evaluation i at plane p - i inside its cone; each evaluation's input's
    variable 0 lives in a ring of three plane slots, plane q in slot q % 3,
    read at q - 1, q, q + 1 with the plane clamped to the box, and Y_{e-1}'s
    u is read from the ring before; the v of Y_e and Y_{e-1} and F0 of the
    planes in flight pass from lag to lag. A chunk hands F0 and its last
    two stage values on through `work` planes written only at its extent
    (on a shard the block grown by its rings). Ring slots and `work` start
    as NaN, so a schedule that reads what it has not computed shows: on a
    shard the points outside a chunk's cone go NaN, and the block must
    not."""
    nz = y.shape[1]
    rhs = box_plane_rhs(bc, fz, nz)
    nan = torch.full_like(y[0, 0], float("nan"))
    y_new = torch.full_like(y, float("nan"))
    est = torch.full_like(y, float("nan"))
    hmu1 = h * mu1_tab[s]
    h04 = 0.4 * h
    work = {}
    for e0, n, rings in rkc_chunks(s, halo is not None):
        last = e0 + n == s + 1
        inside = torch.ones_like(nan, dtype=torch.bool)
        if halo is not None:
            edge = halo - rings
            inside[:edge] = inside[y.shape[2] - edge:] = False
            inside[:, :edge] = inside[:, y.shape[3] - edge:] = False
        hand = {k: torch.full_like(y, float("nan"))
                for k in ("f0", "cur", "prev")}
        src0 = y[0] if e0 == 0 else work["cur"][0]
        for z0 in range(0, nz, z_chunk):
            z1 = min(z0 + z_chunk, nz)
            lo = [max(z0 - (n - 1 - i), 0) for i in range(n)]
            hi = [min(z1 + (n - 1 - i), nz) for i in range(n)]
            ring = [[nan] * 3 for _ in range(n)]
            for k in (max(lo[0] - 1, 0), lo[0]):
                ring[0][k % 3] = src0[k]
            lags = [None] * n
            for p in range(lo[0], z1 + n - 1):
                if p + 1 < nz:
                    ring[0][(p + 1) % 3] = src0[p + 1]
                if p < nz:
                    lags[0] = (dict(cv=y[1, p]) if e0 == 0 else dict(
                        cv=work["cur"][1, p], pv=work["prev"][1, p],
                        pu=work["prev"][0, p], f0=work["f0"][:, p]))
                for i in range(n):
                    q = p - i
                    if not lo[i] <= q < hi[i]:
                        continue
                    st, e, r = lags[i], e0 + i, ring[i]
                    cu, cv = r[q % 3], st["cv"]
                    f = rhs(q, r[max(q - 1, 0) % 3], torch.stack([cu, cv]),
                            r[min(q + 1, nz - 1) % 3])
                    own = z0 <= q < z1
                    if e == 0:
                        st["f0"] = f
                        if own and not last:
                            hand["f0"][:, q] = torch.where(inside, f, nan)
                        yu, yv = cu + hmu1 * f[0], cv + hmu1 * f[1]
                    elif e == s:
                        y_new[0, q], y_new[1, q] = cu, cv
                        est[0, q] = (0.8 * (y[0, q] - cu)
                                     + h04 * (st["f0"][0] + f[0]))
                        est[1, q] = (0.8 * (y[1, q] - cv)
                                     + h04 * (st["f0"][1] + f[1]))
                        continue
                    else:
                        mu, nu, mut, gt = ctab_tab[s, e + 1]
                        cy0, hmut, hgt = 1.0 - mu - nu, h * mut, h * gt
                        pu = ring[i - 1][q % 3] if i > 0 else st["pu"]
                        yu = (cy0 * y[0, q] + mu * cu + nu * pu
                              + hmut * f[0] + hgt * st["f0"][0])
                        yv = (cy0 * y[1, q] + mu * cv + nu * st["pv"]
                              + hmut * f[1] + hgt * st["f0"][1])
                    if i < n - 1:
                        ring[i + 1][q % 3] = yu
                    elif own:
                        for k, (a, b) in (("cur", (yu, yv)),
                                          ("prev", (cu, cv))):
                            hand[k][0, q] = torch.where(inside, a, nan)
                            hand[k][1, q] = torch.where(inside, b, nan)
                    st["pv"], st["cv"] = cv, yv
                lags = [None] + lags[:-1]
        if e0 > 0:
            hand["f0"] = work["f0"]
        work = hand
    return y_new, est


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
