"""Parametric torus surface mesh (counterpart of crdmodel_tpu/viz/
torus_mesh.py; replaces the reference's util/GenTorus.py P5/P6).

The reference builds the torus indirectly through vtkSuperquadricSource with
deliberately swapped theta/phi resolutions, SetSize(R+r), SetThickness(r/R),
triangulation and a point-merging cleanup pass (util/GenTorus.py:29-52).
This generates the exact parametric torus directly:

    x = (R + r cos th) cos ph
    y = (R + r cos th) sin ph
    z = r sin th

with th (minor/tube angle) on nx nodes and ph (major angle) on ny nodes,
periodic in both (no duplicated seam points, no cleanup needed). Cell (i, j)
spans [th_i, th_{i+1}] x [ph_j, ph_{j+1}]; its centre maps to grid indices by
construction, so field attachment (map_output.py) is exact instead of the
reference's nearest-neighbour XYZtoRC search
(util/FHNmodel/MapOutputToTorus.py:16-35).

Axis convention: z is the torus axis (the reference's vtk source uses y —
cosmetic; ParaView renders either). The JAX package's revolution meshes
(revolution_mesh, generate_revolution_vtp) come with the surfaces of
revolution (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import os

import numpy as np

from crdmodel_tpu_torch.viz.vtp import write_vtp


def torus_mesh(R: float, r: float, nx: int, ny: int):
    """Returns (points (nx*ny,3), triangles (2*nx*ny,3), cell_rc (2*nx*ny,2)).

    cell_rc[c] = (row=j, col=i) of the grid sample associated with cell c
    (both triangles of a quad share it, matching the reference's per-cell
    nearest-sample attachment).
    """
    th = 2 * np.pi * np.arange(nx) / nx
    ph = 2 * np.pi * np.arange(ny) / ny
    TH, PH = np.meshgrid(th, ph)              # (ny, nx)
    ring = R + r * np.cos(TH)
    pts = np.stack([ring * np.cos(PH), ring * np.sin(PH),
                    r * np.sin(TH)], axis=-1).reshape(-1, 3)

    def pid(i, j):
        return (j % ny) * nx + (i % nx)

    tris = []
    cell_rc = []
    for j in range(ny):
        for i in range(nx):
            p00, p10 = pid(i, j), pid(i + 1, j)
            p01, p11 = pid(i, j + 1), pid(i + 1, j + 1)
            tris.append((p00, p10, p11))
            tris.append((p00, p11, p01))
            cell_rc.append((j, i))
            cell_rc.append((j, i))
    return (pts, np.asarray(tris, dtype=np.int64),
            np.asarray(cell_rc, dtype=np.int64))


def generate_torus_vtp(cfg, outdir: str = ".", manual: bool = False) -> str:
    """P5 equivalent: writes torus_R<L>_r<W>_mesh<nx>.vtp (same naming as
    util/GenTorus.py:54). manual=True reproduces P6's hardcoded
    R=80/2pi, r=20/2pi, mesh 200 -> torus_manual.vtp."""
    if manual:
        R, r = 80 / (2 * np.pi), 20 / (2 * np.pi)
        nx = 200
        ny = int(nx * R / r)
        name = "torus_manual.vtp"
    else:
        R, r = cfg.major_radius, cfg.minor_radius
        nx, ny = cfg.nx, cfg.ny
        name = (f"torus_R{cfg.surface_length:g}_r{cfg.surface_width:g}"
                f"_mesh{cfg.nx}.vtp")
    pts, tris, _ = torus_mesh(R, r, nx, ny)
    os.makedirs(outdir, exist_ok=True)
    return write_vtp(os.path.join(outdir, name), pts, tris)
