"""Periodic diffusion stencils on the torch path (counterpart of
crdmodel_tpu/ops/stencil.py:20-271).

Whole-array `torch.roll` shifts: on one device the periodic wrap is the
reference's halo exchange. Arrays are (..., ny, nx): axis -1 is theta/x
(E/W neighbours), axis -2 is phi/y (N/S neighbours); on the 3-D box,
(..., nz, ny, nx), axis -3 is z (U/D neighbours). The expressions keep
the JAX package's association order, so both packages round alike.
"""

from __future__ import annotations

import torch


def shift_w(u):
    """u[..., j, i-1] (west neighbour, periodic)."""
    return torch.roll(u, 1, dims=-1)


def shift_e(u):
    """u[..., j, i+1] (east neighbour, periodic)."""
    return torch.roll(u, -1, dims=-1)


def shift_s(u):
    """u[..., j-1, i] (south neighbour, periodic)."""
    return torch.roll(u, 1, dims=-2)


def shift_n(u):
    """u[..., j+1, i] (north neighbour, periodic)."""
    return torch.roll(u, -1, dims=-2)


def flat_laplacian(u, coeffs):
    """D * 5-point Laplacian on a flat periodic rectangle; coeffs =
    (cu1, cu2, cu3) with cu1=D/dx^2, cu2=D/dy^2, cu3=-2(cu1+cu2)."""
    cu1, cu2, cu3 = coeffs
    return (cu1 * (shift_w(u) + shift_e(u))
            + cu2 * (shift_s(u) + shift_n(u))
            + cu3 * u)


def torus_laplacian(u, coeffs):
    """D * Laplace–Beltrami on the torus parametric grid; coeffs =
    (c_asym, c_theta, c_phi), (nx,) theta profiles broadcast over rows:

      out = c_asym*(uE - uW) + c_theta*(uE - 2u + uW) + c_phi*(uN - 2u + uS)
    """
    c_asym, c_theta, c_phi = coeffs
    uw, ue = shift_w(u), shift_e(u)
    us, un = shift_s(u), shift_n(u)
    return (c_asym * (ue - uw)
            + c_theta * (ue - 2.0 * u + uw)
            + c_phi * (un - 2.0 * u + us))


def laplacian_from_padded(up, coeffs, kind):
    """The profile operator over a halo-padded block up (..., nyl+2,
    nxl+2) whose halo came from the mesh's exchange (parallel/halo.py;
    crdmodel_tpu/ops/stencil.py:252): the flat or torus expression of
    flat_laplacian / torus_laplacian with the neighbours read from the
    halo, not rolled. coeffs: the block's (nxl,) torus profiles or the
    flat scalars."""
    u = up[..., 1:-1, 1:-1]
    uw = up[..., 1:-1, 0:-2]
    ue = up[..., 1:-1, 2:]
    us = up[..., 0:-2, 1:-1]
    un = up[..., 2:, 1:-1]
    if kind == "flat":
        cu1, cu2, cu3 = coeffs
        return cu1 * (uw + ue) + cu2 * (us + un) + cu3 * u
    c_asym, c_theta, c_phi = coeffs
    return (c_asym * (ue - uw)
            + c_theta * (ue - 2.0 * u + uw)
            + c_phi * (un - 2.0 * u + us))


def divergence_laplacian(u, face_coeffs):
    """Conservative variable-coefficient diffusion div(D grad u); face_coeffs
    = (aE, aW, aN, aS) from Geometry.divergence_coeffs, each broadcastable
    to u (closed faces carry zero coefficients). Difference form, exactly
    zero for constant u:

      out = aE*(uE - u) + aW*(uW - u) + aN*(uN - u) + aS*(uS - u)
    """
    aE, aW, aN, aS = face_coeffs
    return (aE * (shift_e(u) - u) + aW * (shift_w(u) - u)
            + aN * (shift_n(u) - u) + aS * (shift_s(u) - u))


def divergence_from_padded(up, face_coeffs):
    """divergence_laplacian over a halo-padded block up (..., nyl+2,
    nxl+2) whose halo came from the mesh's exchange
    (crdmodel_tpu/ops/stencil.py:87); face_coeffs are the block's own
    faces, indexed at the centre point, so they need no halo."""
    aE, aW, aN, aS = face_coeffs
    u = up[..., 1:-1, 1:-1]
    uw = up[..., 1:-1, 0:-2]
    ue = up[..., 1:-1, 2:]
    us = up[..., 0:-2, 1:-1]
    un = up[..., 2:, 1:-1]
    return (aE * (ue - u) + aW * (uw - u)
            + aN * (un - u) + aS * (us - u))


def anisotropic_from_padded(up, face_coeffs, dxy_p, inv4):
    """anisotropic_laplacian over a halo-padded block up (..., nyl+2,
    nxl+2) (crdmodel_tpu/ops/stencil.py:166). The mixed terms read the
    corner halo cells, which the two-phase exchange fills with the true
    diagonal neighbours (parallel/halo.py). dxy_p is Dxy with the same
    width-1 halo: the fluxes Dxy*(du) are formed at the neighbours."""
    axis = divergence_from_padded(up, face_coeffs)
    dys = up[..., 2:, :] - up[..., 0:-2, :]
    fx = dxy_p[..., 1:-1, :] * dys
    t1 = fx[..., :, 2:] - fx[..., :, 0:-2]
    dxs = up[..., :, 2:] - up[..., :, 0:-2]
    fy = dxy_p[..., :, 1:-1] * dxs
    t2 = fy[..., 2:, :] - fy[..., 0:-2, :]
    return axis + inv4 * (t1 + t2)


def anisotropic_laplacian(u, face_coeffs, dxy, inv4):
    """Conservative anisotropic diffusion div(D grad u), D = [[Dxx, Dxy],
    [Dxy, Dyy]] (core/grid.py::tensor_coeffs64; the 9-point stencil): the
    axis terms of divergence_laplacian plus the symmetric mixed pair
    Ax(Dxy Ay u) + Ay(Dxy Ax u) with centred differences, weighted by inv4
    (a scalar on the flat surface, an (nx,) profile on the torus):

      out = axis + inv4*(t1 + t2)
    """
    axis = divergence_laplacian(u, face_coeffs)
    un, us = shift_n(u), shift_s(u)
    dys = un - us
    fx = dxy * dys
    t1 = shift_e(fx) - shift_w(fx)
    dxs = shift_e(u) - shift_w(u)
    fy = dxy * dxs
    t2 = shift_n(fy) - shift_s(fy)
    return axis + inv4 * (t1 + t2)


def shift_d(u):
    """u[..., k-1, j, i] (down/depth- neighbour, periodic; box grids)."""
    return torch.roll(u, 1, dims=-3)


def shift_u3(u):
    """u[..., k+1, j, i] (up/depth+ neighbour, periodic; box grids)."""
    return torch.roll(u, -1, dims=-3)


def divergence_laplacian3(u, face_coeffs):
    """Conservative 7-point div(D grad u) on the 3-D box (..., nz, ny, nx);
    face_coeffs = (aE, aW, aN, aS, aU, aD) from BoxGeometry.divergence_coeffs,
    the same difference form as divergence_laplacian."""
    aE, aW, aN, aS, aU, aD = face_coeffs
    return (aE * (shift_e(u) - u) + aW * (shift_w(u) - u)
            + aN * (shift_n(u) - u) + aS * (shift_s(u) - u)
            + aU * (shift_u3(u) - u) + aD * (shift_d(u) - u))


def _mixed_pair(u, dab, axis_a, axis_b):
    """The symmetric mixed pair Aa(Dab * Ab u) + Ab(Dab * Aa u), Aa and Ab
    the periodic centred differences along axis_a and axis_b, unweighted
    (the caller multiplies by 1/(4 da db))."""
    da = torch.roll(u, -1, axis_b) - torch.roll(u, 1, axis_b)
    fa = dab * da
    t1 = torch.roll(fa, -1, axis_a) - torch.roll(fa, 1, axis_a)
    db = torch.roll(u, -1, axis_a) - torch.roll(u, 1, axis_a)
    fb = dab * db
    t2 = torch.roll(fb, -1, axis_b) - torch.roll(fb, 1, axis_b)
    return t1 + t2


def anisotropic_laplacian3(u, face_coeffs, mixed, invs):
    """Conservative 3-D anisotropic diffusion div(D grad u) on the box, D a
    full SPD 3x3 field (BoxGeometry.tensor_coeffs64; the 19-point stencil):
    the 7-point axis part plus the xy, xz and yz mixed pairs, mixed =
    (Dxy, Dxz, Dyz) and invs their 1/(4 da db) weights:

      out = ((axis + ixy*Txy) + ixz*Txz) + iyz*Tyz
    """
    dxy, dxz, dyz = mixed
    ixy, ixz, iyz = invs
    return (divergence_laplacian3(u, face_coeffs)
            + ixy * _mixed_pair(u, dxy, -1, -2)
            + ixz * _mixed_pair(u, dxz, -1, -3)
            + iyz * _mixed_pair(u, dyz, -2, -3))


def divergence3_from_padded(up, face_coeffs):
    """divergence_laplacian3 over a block haloed in its trailing (y, x)
    axes only, up (..., nz, nyl+2, nxl+2) (crdmodel_tpu/ops/stencil.py:
    126): z stays on the shard, so the z neighbours come from a local
    periodic roll; face_coeffs are the block's own six faces."""
    aE, aW, aN, aS, aU, aD = face_coeffs
    u = up[..., 1:-1, 1:-1]
    uw = up[..., 1:-1, 0:-2]
    ue = up[..., 1:-1, 2:]
    us = up[..., 0:-2, 1:-1]
    un = up[..., 2:, 1:-1]
    ud = shift_d(u)
    uu = shift_u3(u)
    return (aE * (ue - u) + aW * (uw - u)
            + aN * (un - u) + aS * (us - u)
            + aU * (uu - u) + aD * (ud - u))


def anisotropic3_from_padded(up, face_coeffs, mixed_p, invs):
    """anisotropic_laplacian3 over a block haloed in its trailing (y, x)
    axes only, up (..., nz, nyl+2, nxl+2) (crdmodel_tpu/ops/stencil.py:
    214). The xy pair reads the corner halo cells (the two-phase exchange
    fills them with the true diagonal neighbours), the xz and yz pairs
    the x and y halos and local z rolls. mixed_p = (Dxy, Dxz, Dyz), each
    with the state's width-1 (y, x) halo: the fluxes are formed at the
    neighbours. Association as the JAX function's, axis + ixy Txy + ixz
    Txz + iyz Tyz."""
    axis = divergence3_from_padded(up, face_coeffs)
    dxy_p, dxz_p, dyz_p = mixed_p
    ixy, ixz, iyz = invs
    dys = up[..., 2:, :] - up[..., 0:-2, :]
    fx = dxy_p[..., 1:-1, :] * dys
    t1 = fx[..., :, 2:] - fx[..., :, 0:-2]
    dxs = up[..., :, 2:] - up[..., :, 0:-2]
    fy = dxy_p[..., :, 1:-1] * dxs
    t2 = fy[..., 2:, :] - fy[..., 0:-2, :]
    t_xy = t1 + t2
    dzs = shift_u3(up) - shift_d(up)
    fx = dxz_p[..., 1:-1, :] * dzs[..., 1:-1, :]
    t1 = fx[..., :, 2:] - fx[..., :, 0:-2]
    fz = dxz_p[..., 1:-1, 1:-1] * dxs[..., 1:-1, :]
    t2 = shift_u3(fz) - shift_d(fz)
    t_xz = t1 + t2
    fy = dyz_p[..., :, 1:-1] * dzs[..., :, 1:-1]
    t1 = fy[..., 2:, :] - fy[..., 0:-2, :]
    fz = dyz_p[..., 1:-1, 1:-1] * dys[..., :, 1:-1]
    t2 = shift_u3(fz) - shift_d(fz)
    t_yz = t1 + t2
    return axis + ixy * t_xy + ixz * t_xz + iyz * t_yz
