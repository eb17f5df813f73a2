"""Map simulation output onto the 3D torus surface (P7/P8 equivalents;
counterpart of crdmodel_tpu/viz/map_output.py).

Replaces util/FHNmodel/MapOutputToTorus.py and
util/GoldbeterModel/MapOutputToTorus.py (the FHN one ships with a syntax
error at line 58 and cannot run as-is): per output step, attach the field as
named per-cell arrays on the parametric torus mesh, write
<prefix>/<prefix>_NNN.vtp and a <collection>.pvd ParaView collection.

Array names match the reference exactly:
  FHN:       "Activator", "Inhibitor", "Hopf Bifurcations"
  Goldbeter: "Cytosolic Calcium", "Calcium in Stores", "Hopf Bifurcations"
(util/FHNmodel/MapOutputToTorus.py:157-191,
 util/GoldbeterModel/MapOutputToTorus.py:156-198)

Because the mesh is generated parametrically (torus_mesh.py), the cell ->
grid-sample association is exact by construction instead of the reference's
per-cell-centre nearest-neighbour search; the Hopf marker keeps the
reference's |phi - phi_hopf| < 0.01 tolerance band.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from crdmodel_tpu_torch.viz.plots import hopf_positions
from crdmodel_tpu_torch.viz.torus_mesh import torus_mesh
from crdmodel_tpu_torch.viz.vtp import write_pvd, write_vtp

ARRAY_NAMES = {
    "fhn": ("Activator", "Inhibitor"),
    "goldbeter": ("Cytosolic Calcium", "Calcium in Stores"),
}
STEP_PREFIX = {"fhn": "FHNstep", "goldbeter": "GBstep"}
PVD_NAME = {"fhn": "FHNtimeSteps.pvd", "goldbeter": "GBtimeSteps.pvd"}


def _model_naming(model_name: str):
    """(array_names, step_prefix, pvd_name) — reference spellings for the
    reference's models, var_names-derived fallbacks for framework additions
    (barkley, grayscott) that have no reference naming to match."""
    if model_name in ARRAY_NAMES:
        return (ARRAY_NAMES[model_name], STEP_PREFIX[model_name],
                PVD_NAME[model_name])
    from crdmodel_tpu_torch.models import get_model
    model = get_model(model_name)
    prefix = f"{model_name.capitalize()}step"
    return (tuple(model.var_names), prefix,
            f"{model_name.capitalize()}timeSteps.pvd")


def map_output_to_surface(result, outdir: str = ".",
                          mesh_nx: Optional[int] = None) -> str:
    """Surface-generic mapper: torus runs keep the reference's exact layout
    (map_output_to_torus). The JAX package maps sphere and revolution runs
    onto the parametric revolution mesh, which comes with those surfaces
    (ROADMAP queue 1, item 12)."""
    cfg = result.cfg
    if cfg.surface == "torus":
        return map_output_to_torus(result, outdir, mesh_nx)
    if cfg.surface in ("sphere", "revolution", "revolution_capped"):
        raise NotImplementedError(
            f"surface={cfg.surface!r} is not ported yet (ROADMAP queue 1, "
            "item 12)")
    raise ValueError("map_output_to_surface needs a torus / sphere / "
                     "revolution run")


def map_output_to_torus(result, outdir: str = ".",
                        mesh_nx: Optional[int] = None) -> str:
    """result: SimResult of a torus run. Writes step vtps + pvd; returns the
    pvd path."""
    cfg = result.cfg
    if cfg.surface != "torus":
        raise ValueError("map_output_to_torus needs a torus run")
    mesh_nx = mesh_nx or cfg.nx
    mesh_ny = int(mesh_nx * cfg.major_radius / cfg.minor_radius)
    pts, tris, cell_rc = torus_mesh(cfg.major_radius, cfg.minor_radius,
                                    mesh_nx, mesh_ny)
    return _write_steps(result, pts, tris, cell_rc, mesh_nx, mesh_ny, outdir)


def _write_steps(result, pts, tris, cell_rc, mesh_nx, mesh_ny,
                 outdir: str) -> str:
    cfg = result.cfg
    # grid sample indices for each cell (mesh resolution may differ from the
    # field grid: map proportionally, the reference's rc rounding)
    rows = np.minimum((cell_rc[:, 0] * cfg.ny) // mesh_ny, cfg.ny - 1)
    cols = np.minimum((cell_rc[:, 1] * cfg.nx) // mesh_nx, cfg.nx - 1)

    names, prefix, pvd_name = _model_naming(cfg.model)
    main_name = names[0]
    second_name = names[1] if len(names) > 1 else None
    stepdir = os.path.join(outdir, prefix)
    os.makedirs(stepdir, exist_ok=True)

    hopf_arr = None
    if cfg.vary_beta:
        ph_cells = 2 * np.pi * (cell_rc[:, 0] + 0.5) / mesh_ny
        hopf_arr = np.zeros(len(cell_rc))
        for y in hopf_positions(cfg):
            hopf_arr[np.abs(ph_cells - y) < 0.01] = 1.0

    traj = result.trajectory.cpu().numpy()
    nt = traj.shape[0]
    files = {}
    for k in range(nt):
        cell_data = {main_name: traj[k, 0][rows, cols]}
        if cfg.include_all_vars and second_name is not None:
            cell_data[second_name] = traj[k, 1][rows, cols]
        if hopf_arr is not None:
            cell_data["Hopf Bifurcations"] = hopf_arr
        rel = os.path.join(prefix, f"{prefix}_{k:03d}.vtp")
        write_vtp(os.path.join(outdir, rel), pts, tris, cell_data=cell_data)
        time = (k / nt) * cfg.t_final
        files[time] = rel
    return write_pvd(os.path.join(outdir, pvd_name), files)
