"""Halo exchange between the shards of a mesh (counterpart of
crdmodel_tpu/parallel/halo.py).

The JAX package moves halos with `lax.ppermute` under `shard_map`. Here
one process holds every shard, so a halo is a slice copied into the
neighbour's halo region: `Tensor.copy_`, which orders a copy between two
cards against both cards' current streams, so the step needs no
`torch.cuda.synchronize`. Shards are lists of tensors in row-major mesh
order (parallel/mesh.py).

A halo-padded buffer (..., nyl+2p, nxl+2p) holds its block at
[p, p+nyl) x [p, p+nxl). The exchange is two-phase, as in the JAX
package: rows first (the interior columns), then columns over the full
height of the row-padded buffer, so corners carry the true diagonal
neighbours (halo.py:98-129). `halo_pad` returns fresh buffers, with the
seam legs of a padded axis (`_seam_fix`); `refresh_halos` rewrites the
halos of persistent buffers in place, with the mirror-pad edges of the
fused shard kernels (`mirror_edges`).

Convention: mesh row index increases with global j (south -> north), mesh
column index with global i (west -> east). Periodic wrap in both axes
matches the MPI Cartesian grid's periods={1,1}
(src/FHNmodel_torus.cpp:731-736).
"""

from __future__ import annotations

import torch


def _index(axis, lo, hi, span):
    """Index of positions [lo, hi) along axis (-2 rows, -1 cols), `span`
    along the other trailing axis."""
    if axis == -2:
        return (Ellipsis, slice(lo, hi), span)
    return (Ellipsis, span, slice(lo, hi))


def _neighbour(mesh, k, axis, step):
    """Flat index of the shard `step` positions from shard k along axis
    (wrapping), and k's position and the axis size."""
    py, px = mesh.shape
    iy, ix = divmod(k, px)
    if axis == -2:
        return ((iy + step) % py) * px + ix, iy, py
    return iy * px + (ix + step) % px, ix, px


def _mirror_runs(t0: int, width: int, n: int, blk: int):
    """Static transfer plan for assembling the rows
    [(t0 + i) % n for i in range(width)] of an n-extent physical axis that
    is stored padded to size*blk: a list of (src_shard, src_lo, length)
    pieces, each contiguous within one shard."""
    runs = []
    i = 0
    while i < width:
        g = (t0 + i) % n
        s = g // blk
        length = min(width - i, n - g, (s + 1) * blk - g)
        runs.append((s, g - s * blk, length))
        i += length
    return runs


def mirror_edges(bufs, mesh, axis, p, span, dst, lo, n, blk):
    """Write into shard `dst`'s halo at [lo, lo+p) along axis the width-p
    strip of the n-PERIODIC EXTENSION of a field stored padded to
    size*blk (the fused kernels' mirror-pad semantics: pad cells hold live
    copies of their wrapped physical sources, so only the two array-edge
    halos need repair; crdmodel_tpu/parallel/halo.py:166-194):

      shard 0's lo halo    = extension rows -p..-1      = physical n-p..n-1
      last shard's hi halo = extension rows n_pad..+p-1 = physical
                             (n_pad..n_pad+p-1) mod n
    """
    size = mesh.shape[0 if axis == -2 else 1]
    if p > blk:
        raise ValueError(f"mirror halo width {p} exceeds the block size "
                         f"{blk}: ring transport is one-hop (the fused "
                         "kernels' gates require nyl, nxl >= P)")
    t0 = (n - p) % n if lo == 0 else (size * blk) % n
    _, pos, _ = _neighbour(mesh, dst, axis, 0)
    off = lo
    for s, src_lo, length in _mirror_runs(t0, p, n, blk):
        # shard s along this axis, at dst's position along the other one
        k_src, _, _ = _neighbour(mesh, dst, axis, s - pos)
        bufs[dst][_index(axis, off, off + length, span)].copy_(
            bufs[k_src][_index(axis, p + src_lo, p + src_lo + length, span)])
        off += length


def _fill_halos(bufs, mesh, axis, p, n_local, span, mirror=None):
    """Fill the width-p halos along axis of every buffer in place: ring
    neighbours' edge rows (cols), and with `mirror` = (n, blk) of a
    padded axis the array-edge halos from the periodic extension. Reads
    only positions [p, p+n_local) along axis, writes only the halos, so
    the copies of one phase commute."""
    for k in range(len(bufs)):
        k_prev, pos, size = _neighbour(mesh, k, axis, -1)
        k_next, _, _ = _neighbour(mesh, k, axis, 1)
        if mirror is not None and pos == 0:
            mirror_edges(bufs, mesh, axis, p, span, k, 0, *mirror)
        else:
            bufs[k][_index(axis, 0, p, span)].copy_(
                bufs[k_prev][_index(axis, n_local, n_local + p, span)])
        if mirror is not None and pos == size - 1:
            mirror_edges(bufs, mesh, axis, p, span, k, p + n_local,
                         *mirror)
        else:
            bufs[k][_index(axis, p + n_local, 2 * p + n_local, span)].copy_(
                bufs[k_next][_index(axis, p, 2 * p, span)])


def _seam_fix(bufs, mesh, axis, p, span, seam):
    """Repair the periodic wrap of a PADDED axis (parallel/padding.py) in
    buffers just ring-filled along axis (crdmodel_tpu/parallel/halo.py:
    44-95): the last physical index n-1 lives mid-array at (seam_shard,
    seam_local) = (s*, q). Two extra legs carry the true seam values:

      leg A: shard 0's first p physical rows -> s*, overwriting padded
             positions q+p+1 .. q+2p (in-shard pad rows or the received
             halo, one uniform slice covers both);
      leg B: s*'s last p physical rows -> shard 0's low halo.

    Pad cells read garbage neighbours, but their RHS is masked to zero
    every evaluation, so nothing propagates."""
    s_star, q = seam
    if q + 1 < p:
        raise ValueError(
            f"seam halo width {p} spans shards (last shard holds only "
            f"{q + 1} physical rows); use the width-1 path")
    for k in range(len(bufs)):
        _, pos, _ = _neighbour(mesh, k, axis, 0)
        if pos != 0:
            continue
        k_seam, _, _ = _neighbour(mesh, k, axis, s_star)
        # leg A reads shard 0's block, leg B the seam shard's block: both
        # sources lie outside both destinations (q + 1 >= p)
        bufs[k_seam][_index(axis, q + p + 1, q + 2 * p + 1, span)].copy_(
            bufs[k][_index(axis, p, 2 * p, span)])
        bufs[k][_index(axis, 0, p, span)].copy_(
            bufs[k_seam][_index(axis, q + 1, q + p + 1, span)])


def _alloc(blocks, py_, px_):
    """Fresh buffers (..., nyl+2py_, nxl+2px_) holding each block."""
    bufs = []
    for b in blocks:
        nyl, nxl = b.shape[-2:]
        buf = torch.empty((*b.shape[:-2], nyl + 2 * py_, nxl + 2 * px_),
                          dtype=b.dtype, device=b.device)
        buf[..., py_:py_ + nyl, px_:px_ + nxl] = b
        bufs.append(buf)
    return bufs


def halo_pad(blocks, mesh, p: int = 1, seam_y=None, seam_x=None):
    """Pad every local block (..., nyl, nxl) to (..., nyl+2p, nxl+2p) with
    neighbour halos (periodic). With a 1-device axis this degenerates to
    the single-device periodic wrap. seam_y/seam_x: (seam_shard,
    seam_local) from a PadSpec when the global grid is padded to divide
    the mesh — repairs the physical periodic wrap (see _seam_fix)."""
    nyl, nxl = blocks[0].shape[-2:]
    bufs = _alloc(blocks, p, p)
    interior = slice(p, p + nxl)
    _fill_halos(bufs, mesh, -2, p, nyl, interior)
    if seam_y is not None:
        _seam_fix(bufs, mesh, -2, p, interior, seam_y)
    _fill_halos(bufs, mesh, -1, p, nxl, slice(None))
    if seam_x is not None:
        _seam_fix(bufs, mesh, -1, p, slice(None), seam_x)
    return bufs


def refresh_halos(bufs, mesh, p: int, pad_spec=None):
    """Rewrite the width-p halos of halo-padded buffers in place: the
    two-phase exchange, with the mirror-pad edges along a padded axis
    (crdmodel_tpu/parallel/halo.py::mirror_halo_pad; the fused shard
    kernels' transport, ops/kernel_common.py::make_shard_halo_helpers)."""
    nyl = bufs[0].shape[-2] - 2 * p
    nxl = bufs[0].shape[-1] - 2 * p
    pady = padx = None
    if pad_spec is not None and pad_spec.y.active:
        pady = (pad_spec.y.n, pad_spec.y.blk)
    if pad_spec is not None and pad_spec.x.active:
        padx = (pad_spec.x.n, pad_spec.x.blk)
    _fill_halos(bufs, mesh, -2, p, nyl, slice(p, p + nxl), pady)
    _fill_halos(bufs, mesh, -1, p, nxl, slice(None), padx)
    return bufs


def mirror_halo_pad(blocks, mesh, p: int, pad_spec):
    """Two-phase halo_pad for the mirror extension on a padded grid, in
    fresh buffers (crdmodel_tpu/parallel/halo.py:215-228)."""
    return refresh_halos(_alloc(blocks, p, p), mesh, p, pad_spec)


def halo_pad_rows(blocks, mesh, p: int = 1):
    """Row-only (y) halo pad: (..., nyl, w) -> (..., nyl+2p, w)."""
    bufs = _alloc(blocks, p, 0)
    _fill_halos(bufs, mesh, -2, p, blocks[0].shape[-2], slice(None))
    return bufs


def halo_pad_cols(blocks, mesh, p: int = 1):
    """Column-only (x) halo pad: (..., nxl) -> (..., nxl+2p)."""
    bufs = _alloc(blocks, 0, p)
    _fill_halos(bufs, mesh, -1, p, blocks[0].shape[-1], slice(None))
    return bufs


def mirror_halo_pad_rows(blocks, mesh, p: int, n: int, blk: int):
    """halo_pad_rows for the n-periodic mirror extension (padded axis)."""
    bufs = _alloc(blocks, p, 0)
    _fill_halos(bufs, mesh, -2, p, blocks[0].shape[-2], slice(None),
                (n, blk))
    return bufs


def mirror_halo_pad_cols(blocks, mesh, p: int, n: int, blk: int):
    """halo_pad_cols for the n-periodic mirror extension (padded axis)."""
    bufs = _alloc(blocks, 0, p)
    _fill_halos(bufs, mesh, -1, p, blocks[0].shape[-1], slice(None),
                (n, blk))
    return bufs
