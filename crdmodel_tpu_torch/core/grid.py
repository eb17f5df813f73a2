"""Grid and surface geometry (counterpart of crdmodel_tpu/core/grid.py).

The stencil coefficients are computed in float64 numpy exactly as the JAX
package computes them; only the final cast makes tensors, so both packages
start from the same rounded values.

Ported: Grid, FlatGeometry.stencil_coeffs, TorusGeometry.stencil_coeffs and
make_geometry for the flat and torus surfaces. Surfaces of revolution, the
sphere and the 3-D box are not ported yet (ROADMAP queue 1, items 12-13).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from crdmodel_tpu_torch.config import SimConfig


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static 2-D grid descriptor; arrays are (..., ny, nx)."""

    nx: int
    ny: int
    xmin: float
    xmax: float
    ymin: float
    ymax: float

    @property
    def dx(self) -> float:
        return (self.xmax - self.xmin) / (self.nx - 1.0)

    @property
    def dy(self) -> float:
        return (self.ymax - self.ymin) / (self.ny - 1.0)

    @property
    def shape(self) -> tuple:
        return (self.ny, self.nx)


@dataclasses.dataclass(frozen=True)
class FlatGeometry:
    """Flat periodic rectangle: constant stencil coefficients.

    cu1 = D/dx^2, cu2 = D/dy^2, cu3 = -2(cu1+cu2)
    (reference src/FHNmodel_flat.cpp:489-491).
    """

    grid: Grid
    diffusion: float

    kind = "flat"

    def stencil_coeffs(self, dtype, device):
        """(cu1, cu2, cu3) as 0-d tensors:
        ydot_u = cu1*(uW+uE) + cu2*(uS+uN) + cu3*u."""
        d = np.float64(self.diffusion)
        cu1 = d / np.float64(self.grid.dx) ** 2
        cu2 = d / np.float64(self.grid.dy) ** 2
        cu3 = -2.0 * (cu1 + cu2)
        return tuple(torch.tensor(c, dtype=dtype, device=device)
                     for c in (cu1, cu2, cu3))


@dataclasses.dataclass(frozen=True)
class TorusGeometry:
    """Torus surface: theta-dependent metric coefficient profiles
    (reference src/FHNmodel_torus.cpp:535-537):

      c_asym(th) = D * (-sin th) / (r (R + r cos th)) / (2 dx)
      c_theta    = D / (r^2 dx^2)
      c_phi(th)  = D / ((R + r cos th)^2 dy^2)

      ydot_u = c_asym*(uE - uW) + c_theta*(uE - 2u + uW) + c_phi*(uN - 2u + uS)
    """

    grid: Grid
    diffusion: float
    R: float  # major radius = surfaceLength / 2pi
    r: float  # minor radius = surfaceWidth / 2pi

    kind = "torus"

    def _profiles64(self):
        g = self.grid
        th = self.grid.xmin + np.arange(g.nx, dtype=np.float64) * g.dx
        D = np.float64(self.diffusion)
        R, r = np.float64(self.R), np.float64(self.r)
        ring = R + r * np.cos(th)
        c_asym = D * (-np.sin(th) / (r * ring)) / (2.0 * g.dx)
        c_theta = np.full_like(th, D / (r * r * g.dx * g.dx))
        c_phi = D / (ring * ring * g.dy * g.dy)
        return c_asym, c_theta, c_phi

    def stencil_coeffs(self, dtype, device):
        """(c_asym, c_theta, c_phi), each a (nx,) tensor."""
        return tuple(torch.tensor(c, dtype=dtype, device=device)
                     for c in self._profiles64())


Geometry = Union[FlatGeometry, TorusGeometry]


def make_grid(cfg: SimConfig) -> Grid:
    return Grid(nx=cfg.nx, ny=cfg.ny, xmin=cfg.xmin, xmax=cfg.xmax,
                ymin=cfg.ymin, ymax=cfg.ymax)


def make_geometry(cfg: SimConfig) -> Geometry:
    if cfg.surface == "torus":
        return TorusGeometry(grid=make_grid(cfg), diffusion=cfg.diffusion,
                             R=cfg.major_radius, r=cfg.minor_radius)
    if cfg.surface == "flat":
        return FlatGeometry(grid=make_grid(cfg), diffusion=cfg.diffusion)
    item = 13 if cfg.surface == "box" else 12
    raise NotImplementedError(
        f"surface={cfg.surface!r} is not ported yet (ROADMAP queue 1, "
        f"item {item})")
