"""Virtual rank decomposition for reference-format file IO (a copy of
crdmodel_tpu/io/decomp.py, which imports no jax but cannot be imported
without running crdmodel_tpu/__init__.py, which does).

The reference's on-disk contract is per-MPI-rank subdomain files. To write
and read byte-compatible files the port reproduces the reference's
decomposition arithmetic exactly:

  - MPI_Dims_create(nprocs, 2) balanced factorisation, non-increasing dims
  - rank -> cartesian coords with reorder=0: rank = cx*dims[1] + cy
    (MPI_Cart_create row-major, src/FHNmodel_torus.cpp:732,737-745)
  - block extents via integer division:
      is = nx*cx/dims0, ie = nx*(cx+1)/dims0 - 1   (allows uneven blocks)
      js = ny*cy/dims1, je = ny*(cy+1)/dims1 - 1
    (src/FHNmodel_torus.cpp:750-755)
"""

from __future__ import annotations

import dataclasses
import math
from typing import List


def dims_create(nprocs: int, ndims: int = 2) -> tuple:
    """MPI_Dims_create semantics: factorise nprocs into ndims factors as
    close to equal as possible, ordered non-increasing."""
    if ndims != 2:
        raise NotImplementedError
    best = (nprocs, 1)
    for a in range(1, int(math.isqrt(nprocs)) + 1):
        if nprocs % a == 0:
            b = nprocs // a
            best = (b, a)  # b >= a, non-increasing
    return best


@dataclasses.dataclass(frozen=True)
class Subdomain:
    rank: int
    coords: tuple      # (cx, cy)
    i_start: int       # global x (theta) index range, inclusive
    i_end: int
    j_start: int       # global y (phi) index range, inclusive
    j_end: int

    @property
    def nxl(self) -> int:
        return self.i_end - self.i_start + 1

    @property
    def nyl(self) -> int:
        return self.j_end - self.j_start + 1


def decompose(nx: int, ny: int, nprocs: int) -> List[Subdomain]:
    """All ranks' subdomains in rank order."""
    d0, d1 = dims_create(nprocs)
    out = []
    for rank in range(nprocs):
        cx, cy = divmod(rank, d1)
        out.append(Subdomain(
            rank=rank, coords=(cx, cy),
            i_start=nx * cx // d0, i_end=nx * (cx + 1) // d0 - 1,
            j_start=ny * cy // d1, j_end=ny * (cy + 1) // d1 - 1,
        ))
    return out
