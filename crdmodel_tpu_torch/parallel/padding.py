"""Pad-and-mask support for grids that do not divide the device mesh
(counterpart of crdmodel_tpu/parallel/padding.py, numpy and torch only).

The reference's SetupDecomp handles ANY (grid, ranks) pair by integer block
partition with uneven blocks (src/FHNmodel_torus.cpp:750-755: is = nx*cx/dims0
etc.). The sharded run keeps equal blocks per shard, so it pads the global
grid up to the mesh-divisible size and masks the pad cells:

- on the torch path, pad cells' RHS is zeroed every evaluation, so their
  values never move from the (finite, wrap-copied) initial fill, and the
  error norms exclude them;
- the fused shard kernels (K8-K11) run mirror-pad semantics instead: pad
  cells evolve as live copies of their wrapped physical sources, and the
  error sums are masked to the physical cells in-kernel
  (ops/kernel_common.py::ShardConstants);
- the periodic wrap at the PHYSICAL seam (row ny-1 <-> row 0, col nx-1 <->
  col 0) no longer coincides with the array wrap, so the torch path's halo
  exchange carries two extra legs that deliver the true seam rows/cols
  (parallel/halo.py::halo_pad seam_y/seam_x).

The seam geometry: with block size blk = nyp/py, the last physical row ny-1
lives in shard s* = (ny-1)//blk at local index q = (ny-1)%blk. Physical row
ny-1 reads its +1 neighbour at padded-block position q+p+1 (p = halo width),
which is either an in-shard pad row (q < blk-1) or the received halo row
(q = blk-1) — ONE uniform overwrite with physical row 0 (leg shard 0 -> s*)
covers both. Physical row 0 reads its -1 neighbour from shard 0's low halo,
overwritten with physical row ny-1 (leg s* -> shard 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _cat(arrays, axis):
    if isinstance(arrays[0], np.ndarray):
        return np.concatenate(arrays, axis=axis)
    return torch.cat(arrays, dim=axis)


@dataclasses.dataclass(frozen=True)
class AxisPad:
    """Padding along one grid axis sharded over `size` devices."""
    n: int          # physical extent
    n_pad: int      # padded extent (multiple of size)
    size: int       # devices along this axis
    blk: int        # n_pad // size
    seam_shard: int  # device holding the last physical index
    seam_local: int  # local index of the last physical index in seam_shard

    @property
    def active(self) -> bool:
        return self.n_pad != self.n


def _axis_pad(n: int, size: int) -> AxisPad:
    if n < 2 and size > 1:
        raise ValueError(f"cannot shard an axis of extent {n} over {size} "
                         "devices (periodic stencil needs >= 2 points)")
    blk = -(-n // size)          # ceil
    n_pad = blk * size
    return AxisPad(n=n, n_pad=n_pad, size=size, blk=blk,
                   seam_shard=(n - 1) // blk, seam_local=(n - 1) % blk)


@dataclasses.dataclass(frozen=True)
class PadSpec:
    """Padding plan for a (ny, nx) grid on a (py, px) mesh."""
    y: AxisPad
    x: AxisPad

    @property
    def active(self) -> bool:
        return self.y.active or self.x.active

    @property
    def padded_shape(self) -> tuple:
        return (self.y.n_pad, self.x.n_pad)

    def seam_y(self):
        """(seam_shard, seam_local) for halo_pad, or None when the array
        wrap IS the physical wrap along y."""
        return ((self.y.seam_shard, self.y.seam_local)
                if self.y.active else None)

    def seam_x(self):
        return ((self.x.seam_shard, self.x.seam_local)
                if self.x.active else None)

    def pad_field(self, arr):
        """Wrap-pad the trailing (ny, nx) dims to (nyp, nxp). Wrap fill
        keeps pad values inside the physical value range (finite kinetics,
        conservative spectral-radius bounds) and makes the t=0 pad contents
        physically meaningful."""
        if not self.active:
            return arr
        out = arr
        if self.y.active:
            reps = -(-self.y.n_pad // self.y.n)
            out = _cat([out] * reps, -2)[..., :self.y.n_pad, :]
        if self.x.active:
            reps = -(-self.x.n_pad // self.x.n)
            out = _cat([out] * reps, -1)[..., :, :self.x.n_pad]
        return out

    def pad_rows(self, arr):
        """Wrap-pad a (..., ny, 1) per-row field to (..., nyp, 1)."""
        if self.y.n_pad == self.y.n:
            return arr
        reps = -(-self.y.n_pad // self.y.n)
        return _cat([arr] * reps, -2)[..., :self.y.n_pad, :]

    def pad_cols(self, arr):
        """Wrap-pad a (..., nx) per-column profile to (..., nxp)."""
        if self.x.n_pad == self.x.n:
            return arr
        reps = -(-self.x.n_pad // self.x.n)
        return _cat([arr] * reps, -1)[..., :self.x.n_pad]

    def unpad_field(self, arr):
        """Slice the trailing (nyp, nxp) dims back to (ny, nx)."""
        if not self.active:
            return arr
        return arr[..., :self.y.n, :self.x.n]

    def valid_mask(self) -> np.ndarray:
        """(nyp, nxp) bool, True on physical cells."""
        m = np.zeros(self.padded_shape, dtype=bool)
        m[:self.y.n, :self.x.n] = True
        return m


def compute_pad_spec(ny: int, nx: int, py: int, px: int) -> PadSpec:
    return PadSpec(y=_axis_pad(ny, py), x=_axis_pad(nx, px))


def pad_spec_for(cfg, py: int, px: int) -> PadSpec:
    """The ONE pad layout for cfg's grid on a (py, px) mesh: blocks of
    ceil(n / size), since the port's shard kernels take any block height.
    The JAX package rounds the block up to 8 rows when its fused shard
    kernels could engage (crdmodel_tpu/parallel/padding.py:148-176,
    fused_y_multiple), a rule of its TPU strips (ops/pallas_step.py::
    _pick_strip), which the port drops. So on a grid that does not divide
    the mesh the two layouts can differ: 400 rows on 3 shards give JAX's
    use_pallas=True runs blocks of 136, 136 and 128 physical rows, the
    port's 134, 134 and 132. Both mask their pads, so the physical cells
    agree; compare runs on physical cells only."""
    return compute_pad_spec(cfg.ny, cfg.nx, py, px)
