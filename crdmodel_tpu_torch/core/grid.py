"""Grid and surface geometry (counterpart of crdmodel_tpu/core/grid.py).

The stencil coefficients are computed in float64 numpy exactly as the JAX
package computes them; only the final cast makes tensors, so both packages
start from the same rounded values.

Ported: Grid, the flat and torus geometries' stencil coefficients,
divergence-form face coefficients and anisotropic tensor coefficients,
face_openness (no-flux walls and obstacles), the 3-D box (BoxGeometry,
face_openness3) and make_geometry for the flat, torus and box surfaces.
Surfaces of revolution and the sphere are not ported yet (ROADMAP queue
1, item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from crdmodel_tpu_torch.config import SimConfig


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static grid descriptor; arrays are (..., ny, nx). nz > 0 marks a 3-D
    box grid (surface="box"): arrays gain a leading z axis, (nz, ny, nx),
    and the x/y axes keep their trailing positions."""

    nx: int
    ny: int
    xmin: float
    xmax: float
    ymin: float
    ymax: float
    nz: int = 0
    zmin: float = 0.0
    zmax: float = 0.0

    @property
    def dx(self) -> float:
        return (self.xmax - self.xmin) / (self.nx - 1.0)

    @property
    def dy(self) -> float:
        return (self.ymax - self.ymin) / (self.ny - 1.0)

    @property
    def dz(self) -> float:
        return (self.zmax - self.zmin) / (self.nz - 1.0)

    def z_coords(self) -> np.ndarray:
        """Depth values, float64 (nz,): z_k = ZMIN + k*dz (box only)."""
        return self.zmin + np.arange(self.nz, dtype=np.float64) * self.dz

    @property
    def shape(self) -> tuple:
        if self.nz > 0:
            return (self.nz, self.ny, self.nx)
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

    def divergence_coeffs(self, dfield, dtype, device, face_mask=None):
        """Face coefficients (aE, aW, aN, aS) of the conservative operator
        div(D grad u) as tensors, cast once from divergence_coeffs64:

          L u = aE (uE - u) + aW (uW - u) + aN (uN - u) + aS (uS - u)
        """
        return _as_tensors(self.divergence_coeffs64(dfield, face_mask),
                           dtype, device)

    def divergence_coeffs64(self, dfield, face_mask=None):
        """The face coefficients as float64 numpy
        (crdmodel_tpu/core/grid.py:132): aE_ij = D_{i+1/2,j}/dx^2 with
        arithmetic face means, aW = roll_x(aE), aN = D_{i,j+1/2}/dy^2,
        aS = roll_y(aN). dfield: absolute D values, scalar / (nx,) /
        (ny, nx); scalar and (nx,) fields keep (nx,) profiles. face_mask:
        optional face_openness masks, zeroing closed faces."""
        g = self.grid
        D = np.asarray(dfield, dtype=np.float64)
        if D.ndim < 2:
            D = np.broadcast_to(D, (g.nx,))
            De = 0.5 * (D + np.roll(D, -1))
            Dn = Ds = D
            aW_of = lambda aE: np.roll(aE, 1)   # noqa: E731
        else:
            D = np.broadcast_to(D, (g.ny, g.nx))
            De = 0.5 * (D + np.roll(D, -1, axis=-1))
            Dn = 0.5 * (D + np.roll(D, -1, axis=-2))
            Ds = np.roll(Dn, 1, axis=-2)
            aW_of = lambda aE: np.roll(aE, 1, axis=-1)   # noqa: E731
        inv_dx2 = 1.0 / np.float64(g.dx) ** 2
        inv_dy2 = 1.0 / np.float64(g.dy) ** 2
        aE = De * inv_dx2
        aW = aW_of(aE)
        aN = Dn * inv_dy2
        aS = Ds * inv_dy2
        return _apply_face_mask((aE, aW, aN, aS), face_mask)

    def tensor_coeffs(self, dxx, dyy, dxy, dtype, device,
                      boundary: str = "periodic"):
        """tensor_coeffs64 as tensors, cast once: ((aE, aW, aN, aS), Dxy,
        inv4)."""
        return _tensor_coeffs_as_tensors(
            self.tensor_coeffs64(dxx, dyy, dxy, boundary), dtype, device)

    def tensor_coeffs64(self, dxx, dyy, dxy, boundary: str = "periodic"):
        """Float64 numpy coefficients of the anisotropic conservative
        operator div(D grad u), D = [[Dxx, Dxy], [Dxy, Dyy]] an SPD tensor
        field (crdmodel_tpu/core/grid.py:160): the axis terms in face-flux
        form, aE(uE-u) + aW(uW-u) + aN(uN-u) + aS(uS-u) with arithmetic
        face means of Dxx and Dyy, and the mixed terms Ax(Dxy Ay u) +
        Ay(Dxy Ax u) with centred first differences, weighted by inv4 =
        1/(4 dx dy) (ops/stencil.py::anisotropic_laplacian).

        boundary "noflux"/"noflux_x"/"noflux_y" closes the domain walls:
        the wall faces carry zero aE/aN and Dxy is zeroed on the
        wall-adjacent layers of each closed axis, so every centred
        difference across a wall multiplies zero; aW and aS are rolled
        after the masking. Raises ValueError unless the tensor is SPD
        pointwise. Returns ((aE, aW, aN, aS), Dxy (ny, nx), inv4)."""
        g = self.grid
        Dxx, Dyy, Dxy = _spd_tensor64(dxx, dyy, dxy, (g.ny, g.nx))
        De = 0.5 * (Dxx + np.roll(Dxx, -1, axis=-1))
        Dn = 0.5 * (Dyy + np.roll(Dyy, -1, axis=-2))
        inv_dx2 = 1.0 / np.float64(g.dx) ** 2
        inv_dy2 = 1.0 / np.float64(g.dy) ** 2
        aE = (De * inv_dx2).copy()
        aN = (Dn * inv_dy2).copy()
        if boundary in ("noflux", "noflux_x"):
            aE[..., -1] = 0.0
            Dxy[..., 0] = 0.0
            Dxy[..., -1] = 0.0
        if boundary in ("noflux", "noflux_y"):
            aN[..., -1, :] = 0.0
            Dxy[..., 0, :] = 0.0
            Dxy[..., -1, :] = 0.0
        aW = np.roll(aE, 1, axis=-1)
        aS = np.roll(aN, 1, axis=-2)
        inv4 = 1.0 / (4.0 * np.float64(g.dx) * np.float64(g.dy))
        return (aE, aW, aN, aS), Dxy, inv4


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
        return _as_tensors(self._profiles64(), dtype, device)

    def divergence_coeffs(self, dfield, dtype, device, face_mask=None):
        """Face coefficients (aE, aW, aN, aS) of the conservative
        Laplace–Beltrami operator as tensors (see FlatGeometry)."""
        return _as_tensors(self.divergence_coeffs64(dfield, face_mask),
                           dtype, device)

    def divergence_coeffs64(self, dfield, face_mask=None):
        """Float64 numpy face coefficients of div(D grad u) on the torus
        metric (crdmodel_tpu/core/grid.py:309), ring = R + r cos(theta):

          aE_i = ring(th_i + dx/2) D_{i+1/2} / (r^2 dx^2 ring_i)
          aW_i = ring(th_i - dx/2) D_{i-1/2} / (r^2 dx^2 ring_i)
          aN = D_{j+1/2} / (ring_i^2 dy^2),  aS = D_{j-1/2} / (ring_i^2 dy^2)

        face_mask: optional face_openness masks (obstacle walls)."""
        g = self.grid
        th = g.xmin + np.arange(g.nx, dtype=np.float64) * g.dx
        R, r = np.float64(self.R), np.float64(self.r)
        ring = R + r * np.cos(th)
        ring_e = R + r * np.cos(th + 0.5 * g.dx)          # face i+1/2
        cx = 1.0 / (r * r * np.float64(g.dx) ** 2)
        cy = 1.0 / (ring * ring * np.float64(g.dy) ** 2)   # (nx,)
        D = np.asarray(dfield, dtype=np.float64)
        if D.ndim < 2:
            D = np.broadcast_to(D, (g.nx,))
            De = 0.5 * (D + np.roll(D, -1))
            Dn = Ds = D
            roll_x = lambda a: np.roll(a, 1)   # noqa: E731
        else:
            D = np.broadcast_to(D, (g.ny, g.nx))
            De = 0.5 * (D + np.roll(D, -1, axis=-1))
            Dn = 0.5 * (D + np.roll(D, -1, axis=-2))
            Ds = np.roll(Dn, 1, axis=-2)
            roll_x = lambda a: np.roll(a, 1, axis=-1)   # noqa: E731
        flux_e = ring_e * De * cx                          # per east face
        aE = flux_e / ring
        aW = roll_x(flux_e) / ring
        aN = Dn * cy
        aS = Ds * cy
        return _apply_face_mask((aE, aW, aN, aS), face_mask)

    def tensor_coeffs(self, dxx, dyy, dxy, dtype, device,
                      boundary: str = "periodic"):
        """tensor_coeffs64 as tensors, cast once: ((aE, aW, aN, aS), Dxy,
        inv4 (nx,))."""
        return _tensor_coeffs_as_tensors(
            self.tensor_coeffs64(dxx, dyy, dxy, boundary), dtype, device)

    def tensor_coeffs64(self, dxx, dyy, dxy, boundary: str = "periodic"):
        """Float64 numpy coefficients of the anisotropic conservative
        Laplace–Beltrami operator on the torus metric
        (crdmodel_tpu/core/grid.py:347), D the SPD tensor in the physical
        orthonormal frame (e_theta, e_phi): the axis terms in the face-flux
        form of divergence_coeffs64 with Dxx on the theta faces and Dyy on
        the phi faces, and the flat mixed pair weighted by the profile
        inv4(th) = 1/(4 dx dy r ring(th)). The torus is closed: only
        boundary="periodic". Returns ((aE, aW, aN, aS), Dxy (ny, nx),
        inv4 (nx,))."""
        if boundary != "periodic":
            raise ValueError("the torus surface is closed: tensor "
                             "boundaries other than 'periodic' do not "
                             "exist on it")
        g = self.grid
        Dxx, Dyy, Dxy = _spd_tensor64(dxx, dyy, dxy, (g.ny, g.nx))
        th = g.xmin + np.arange(g.nx, dtype=np.float64) * g.dx
        R, r = np.float64(self.R), np.float64(self.r)
        ring = R + r * np.cos(th)
        ring_e = R + r * np.cos(th + 0.5 * g.dx)
        cx = 1.0 / (r * r * np.float64(g.dx) ** 2)
        cy = 1.0 / (ring * ring * np.float64(g.dy) ** 2)
        De = 0.5 * (Dxx + np.roll(Dxx, -1, axis=-1))
        Dn = 0.5 * (Dyy + np.roll(Dyy, -1, axis=-2))
        flux_e = ring_e * De * cx
        aE = flux_e / ring
        aW = np.roll(flux_e, 1, axis=-1) / ring
        aN = Dn * cy
        aS = np.roll(aN, 1, axis=-2)
        inv4 = 1.0 / (4.0 * np.float64(g.dx) * np.float64(g.dy) * r * ring)
        return (aE, aW, aN, aS), Dxy, inv4


@dataclasses.dataclass(frozen=True)
class BoxGeometry:
    """3-D rectangular volume [0,W] x [0,L] x [0,depth], volumetric tissue
    (crdmodel_tpu/core/grid.py:673). The operator is always the
    conservative divergence form: six face arrays (aE, aW, aN, aS, aU, aD),
    aE = D_{i+1/2}/dx^2 etc. with arithmetic face means, the 3-D extension
    of FlatGeometry.divergence_coeffs64 with the same face-mask hook for
    no-flux walls and 3-D obstacles (face_openness3). Axes: z leads
    ((nz, ny, nx)); E/W = x (axis -1), N/S = y (axis -2), U/D = z
    (axis -3). There is no constant-coefficient stencil form: build_problem
    defaults diffusion_field to the constant cfg.diffusion."""

    grid: Grid
    diffusion: float

    kind = "box"

    def gaussian_curvature(self, dtype, device) -> torch.Tensor:
        return torch.zeros((self.grid.nx,), dtype=dtype, device=device)

    def divergence_coeffs(self, dfield, dtype, device, face_mask=None):
        """divergence_coeffs64 as tensors, cast once. Shapes stay broadcast-
        minimal: scalars for constant D, (nx,) profiles for x-profile D,
        (nz, ny, nx) for full fields; face_mask entries multiply in."""
        return _as_tensors(self.divergence_coeffs64(dfield, face_mask),
                           dtype, device)

    def divergence_coeffs64(self, dfield, face_mask=None):
        """Float64 numpy face coefficients (aE, aW, aN, aS, aU, aD)
        (crdmodel_tpu/core/grid.py:708). dfield: absolute D values, scalar /
        (nx,) / broadcastable to (nz, ny, nx). An x-profile D(x) keeps
        centre values on the N/S and U/D faces, which sit at the same x."""
        g = self.grid
        inv_dx2 = 1.0 / np.float64(g.dx) ** 2
        inv_dy2 = 1.0 / np.float64(g.dy) ** 2
        inv_dz2 = 1.0 / np.float64(g.dz) ** 2
        D = np.asarray(dfield, dtype=np.float64)
        if D.ndim == 0:
            De = Dn = Du = D
            roll_x = roll_y = roll_z = lambda a: a   # noqa: E731
        elif D.ndim == 1:
            D = np.broadcast_to(D, (g.nx,))
            De = 0.5 * (D + np.roll(D, -1))
            Dn = Du = D
            roll_x = lambda a: np.roll(a, 1)   # noqa: E731
            roll_y = roll_z = lambda a: a      # noqa: E731
        else:
            D = np.broadcast_to(D, (g.nz, g.ny, g.nx))
            De = 0.5 * (D + np.roll(D, -1, axis=-1))
            Dn = 0.5 * (D + np.roll(D, -1, axis=-2))
            Du = 0.5 * (D + np.roll(D, -1, axis=-3))
            roll_x = lambda a: np.roll(a, 1, axis=-1)   # noqa: E731
            roll_y = lambda a: np.roll(a, 1, axis=-2)   # noqa: E731
            roll_z = lambda a: np.roll(a, 1, axis=-3)   # noqa: E731
        aE = De * inv_dx2
        aN = Dn * inv_dy2
        aU = Du * inv_dz2
        faces = (aE, roll_x(aE), aN, roll_y(aN), aU, roll_z(aU))
        return _apply_face_mask(faces, face_mask)

    def tensor_coeffs(self, dxx, dyy, dzz, dxy, dxz, dyz, dtype, device,
                      boundary: str = "periodic"):
        """tensor_coeffs64 as tensors, cast once: (six faces, (Dxy, Dxz,
        Dyz), (inv4_xy, inv4_xz, inv4_yz))."""
        faces, mixed, invs = self.tensor_coeffs64(dxx, dyy, dzz, dxy, dxz,
                                                  dyz, boundary)
        return (_as_tensors(faces, dtype, device),
                _as_tensors(mixed, dtype, device),
                _as_tensors(invs, dtype, device))

    def tensor_coeffs64(self, dxx, dyy, dzz, dxy, dxz, dyz,
                        boundary: str = "periodic"):
        """Float64 numpy coefficients of the 3-D anisotropic conservative
        operator div(D grad u), D = [[Dxx,Dxy,Dxz],[Dxy,Dyy,Dyz],
        [Dxz,Dyz,Dzz]] an SPD field (crdmodel_tpu/core/grid.py:740): the
        diagonal terms in the 7-point face-flux form, the mixed terms as
        Aa(Dab Ab u) + Ab(Dab Aa u) per axis pair with centred differences.
        SPD is checked pointwise by Sylvester's criterion (ValueError).

        boundary "noflux"/"noflux_x"/"noflux_y"/"noflux_z" closes walls:
        zero diagonal faces at the walls, and each mixed field zeroed on the
        wall-adjacent layers of its two axes when closed; the rolled faces
        are built after the masking. Returns (six faces, (Dxy, Dxz, Dyz) as
        (nz, ny, nx) arrays, (inv4_xy, inv4_xz, inv4_yz)) with inv4_ab =
        1/(4 da db)."""
        g = self.grid
        shape = (g.nz, g.ny, g.nx)
        Dxx, Dyy, Dzz, Dxy, Dxz, Dyz = (
            np.broadcast_to(np.asarray(c, np.float64), shape)
            for c in (dxx, dyy, dzz, dxy, dxz, dyz))
        m2 = Dxx * Dyy - Dxy * Dxy
        det = (Dxx * (Dyy * Dzz - Dyz * Dyz)
               - Dxy * (Dxy * Dzz - Dyz * Dxz)
               + Dxz * (Dxy * Dyz - Dyy * Dxz))
        scale = Dxx * Dyy * Dzz
        if not (np.all(Dxx > 0.0) and np.all(Dyy > 0.0)
                and np.all(Dzz > 0.0)
                and np.all(m2 >= -1e-14 * Dxx * Dyy)
                and np.all(det >= -1e-14 * scale)):
            raise ValueError("diffusion_tensor must be SPD pointwise "
                             "(Sylvester: Dxx>0, Dyy>0, Dzz>0, "
                             "Dxx*Dyy>=Dxy^2, det(D)>=0)")
        De = 0.5 * (Dxx + np.roll(Dxx, -1, axis=-1))
        Dn = 0.5 * (Dyy + np.roll(Dyy, -1, axis=-2))
        Du = 0.5 * (Dzz + np.roll(Dzz, -1, axis=-3))
        aE = (De / np.float64(g.dx) ** 2).copy()
        aN = (Dn / np.float64(g.dy) ** 2).copy()
        aU = (Du / np.float64(g.dz) ** 2).copy()
        Dxy, Dxz, Dyz = Dxy.copy(), Dxz.copy(), Dyz.copy()
        if boundary in ("noflux", "noflux_x"):
            aE[..., -1] = 0.0
            for Dab in (Dxy, Dxz):
                Dab[..., 0] = 0.0
                Dab[..., -1] = 0.0
        if boundary in ("noflux", "noflux_y"):
            aN[..., -1, :] = 0.0
            for Dab in (Dxy, Dyz):
                Dab[..., 0, :] = 0.0
                Dab[..., -1, :] = 0.0
        if boundary in ("noflux", "noflux_z"):
            aU[-1, ...] = 0.0
            for Dab in (Dxz, Dyz):
                Dab[0, ...] = 0.0
                Dab[-1, ...] = 0.0
        faces = (aE, np.roll(aE, 1, axis=-1), aN, np.roll(aN, 1, axis=-2),
                 aU, np.roll(aU, 1, axis=-3))
        dx, dy, dz = (np.float64(g.dx), np.float64(g.dy), np.float64(g.dz))
        invs = (1.0 / (4.0 * dx * dy), 1.0 / (4.0 * dx * dz),
                1.0 / (4.0 * dy * dz))
        return faces, (Dxy, Dxz, Dyz), invs


Geometry = Union[FlatGeometry, TorusGeometry, BoxGeometry]


def _as_tensors(arrays, dtype, device):
    """float64 numpy arrays -> tensors, cast once."""
    return tuple(torch.tensor(np.asarray(a), dtype=dtype, device=device)
                 for a in arrays)


def _tensor_coeffs_as_tensors(coeffs64, dtype, device):
    """tensor_coeffs64's ((aE, aW, aN, aS), Dxy, inv4) as tensors."""
    faces, dxy, inv4 = coeffs64
    return (_as_tensors(faces, dtype, device),
            *_as_tensors((dxy, inv4), dtype, device))


def _spd_tensor64(dxx, dyy, dxy, shape):
    """(Dxx, Dyy, Dxy) as float64 (ny, nx) arrays, Dxy a writable copy;
    raises ValueError unless the tensor is SPD pointwise (up to a 1e-14
    relative slack on the determinant)."""
    Dxx = np.broadcast_to(np.asarray(dxx, np.float64), shape)
    Dyy = np.broadcast_to(np.asarray(dyy, np.float64), shape)
    Dxy = np.broadcast_to(np.asarray(dxy, np.float64), shape).copy()
    if not (np.all(Dxx > 0.0) and np.all(Dyy > 0.0)
            and np.all(Dxx * Dyy - Dxy * Dxy >= -1e-14 * Dxx * Dyy)):
        raise ValueError("diffusion_tensor must be SPD pointwise "
                         "(Dxx>0, Dyy>0, Dxx*Dyy >= Dxy^2)")
    return Dxx, Dyy, Dxy


def face_openness(ny: int, nx: int, boundary: str = "periodic",
                  tissue=None):
    """0/1 face-openness masks (oE, oW, oN, oS), float64, or None when every
    face is open (crdmodel_tpu/core/grid.py:870).

    A closed face carries zero flux: the masks multiply the face
    coefficients of div(D grad u), closing the domain edges of
    boundary="noflux"/"noflux_x"/"noflux_y" and every face that touches a
    non-tissue cell of `tissue` (bool (ny, nx), True = active medium). They
    satisfy oW = roll_x(oE) and oS = roll_y(oN), so both sides of a face
    close together, and a periodic wrap across a closed face meets a zero
    coefficient. Shapes: (nx,) for the x masks and (ny, 1) for the y masks,
    (ny, nx) once there is a tissue mask."""
    if boundary == "periodic" and tissue is None:
        return None
    oE = np.ones(nx, dtype=np.float64)
    oW = np.ones(nx, dtype=np.float64)
    oN = np.ones((ny, 1), dtype=np.float64)
    oS = np.ones((ny, 1), dtype=np.float64)
    if boundary in ("noflux", "noflux_x"):
        oE[-1] = 0.0
        oW[0] = 0.0
    if boundary in ("noflux", "noflux_y"):
        oN[-1, 0] = 0.0
        oS[0, 0] = 0.0
    if tissue is not None:
        T = np.broadcast_to(np.asarray(tissue, dtype=bool), (ny, nx))
        oE = oE * (T & np.roll(T, -1, axis=-1))
        oW = oW * (T & np.roll(T, 1, axis=-1))
        oN = oN * (T & np.roll(T, -1, axis=-2))
        oS = oS * (T & np.roll(T, 1, axis=-2))
    return oE, oW, oN, oS


def face_openness3(nz: int, ny: int, nx: int, boundary: str = "periodic",
                   tissue=None):
    """0/1 face-openness masks (oE, oW, oN, oS, oU, oD) of the box's
    divergence operator, float64, or None when every face is open
    (crdmodel_tpu/core/grid.py:828): the 3-D extension of face_openness,
    with oW = roll_x(oE) etc., so both sides of a face close together.
    boundary "noflux" closes all six domain walls, "noflux_x"/"noflux_y"/
    "noflux_z" one axis pair; tissue (bool broadcastable to (nz, ny, nx),
    True = active medium) closes every face touching a non-tissue cell.
    Shapes: (nx,) for x, (ny, 1) for y, (nz, 1, 1) for z, (nz, ny, nx) once
    there is a tissue mask."""
    if boundary == "periodic" and tissue is None:
        return None
    oE = np.ones(nx, dtype=np.float64)
    oW = np.ones(nx, dtype=np.float64)
    oN = np.ones((ny, 1), dtype=np.float64)
    oS = np.ones((ny, 1), dtype=np.float64)
    oU = np.ones((nz, 1, 1), dtype=np.float64)
    oD = np.ones((nz, 1, 1), dtype=np.float64)
    if boundary in ("noflux", "noflux_x"):
        oE[-1] = 0.0
        oW[0] = 0.0
    if boundary in ("noflux", "noflux_y"):
        oN[-1, 0] = 0.0
        oS[0, 0] = 0.0
    if boundary in ("noflux", "noflux_z"):
        oU[-1, 0, 0] = 0.0
        oD[0, 0, 0] = 0.0
    if tissue is not None:
        T = np.broadcast_to(np.asarray(tissue, dtype=bool), (nz, ny, nx))
        oE = oE * (T & np.roll(T, -1, axis=-1))
        oW = oW * (T & np.roll(T, 1, axis=-1))
        oN = oN * (T & np.roll(T, -1, axis=-2))
        oS = oS * (T & np.roll(T, 1, axis=-2))
        oU = oU * (T & np.roll(T, -1, axis=-3))
        oD = oD * (T & np.roll(T, 1, axis=-3))
    return oE, oW, oN, oS, oU, oD


def _apply_face_mask(faces, face_mask):
    if face_mask is None:
        return faces
    return tuple(a * o for a, o in zip(faces, face_mask))


def make_grid(cfg: SimConfig) -> Grid:
    return Grid(nx=cfg.nx, ny=cfg.ny, xmin=cfg.xmin, xmax=cfg.xmax,
                ymin=cfg.ymin, ymax=cfg.ymax, nz=cfg.nz, zmin=cfg.zmin,
                zmax=cfg.zmax)


def make_geometry(cfg: SimConfig) -> Geometry:
    if cfg.surface == "box":
        return BoxGeometry(grid=make_grid(cfg), diffusion=cfg.diffusion)
    if cfg.surface == "torus":
        return TorusGeometry(grid=make_grid(cfg), diffusion=cfg.diffusion,
                             R=cfg.major_radius, r=cfg.minor_radius)
    if cfg.surface == "flat":
        return FlatGeometry(grid=make_grid(cfg), diffusion=cfg.diffusion)
    raise NotImplementedError(
        f"surface={cfg.surface!r} is not ported yet (ROADMAP queue 1, "
        "item 12)")
