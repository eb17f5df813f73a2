"""VTK XML ImageData (.vti) volume writer + 3-D output pipeline
(counterpart of crdmodel_tpu/viz/volume.py).

The 2-D pipeline maps fields onto surface meshes (.vtp — viz/vtp.py,
reference util/FHNmodel/MapOutputToTorus.py); the 3-D box (surface="box",
core/grid.py::BoxGeometry) has no surface to map onto — its natural ParaView
representation is a regular-grid volume (ImageData), rendered with volume
rendering / isosurfaces / slice planes. Same dependency-free inline-base64
XML approach as viz/vtp.py (no `vtk` module needed; the encoded payload
class matches vtkXMLImageDataWriter's).

VTK ImageData point ordering is x-fastest, then y, then z — exactly the
C-order ravel of the framework's (nz, ny, nx) arrays, so fields are written
with zero reshuffling.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from crdmodel_tpu_torch.viz.vtp import _data_array, _decode_array, write_pvd


def write_vti(path: str, fields: dict, spacing, origin=(0.0, 0.0, 0.0),
              fmt: str = "binary") -> str:
    """Write point-data fields on a regular 3-D grid as VTK ImageData.

    fields: {name: (nz, ny, nx) array}; spacing/origin: (dx, dy, dz) /
    (x0, y0, z0) in VTK's (x, y, z) axis order. fmt: "binary" (inline
    base64, default) or "ascii"."""
    if fmt not in ("binary", "ascii"):
        raise ValueError(f"fmt must be binary|ascii, got {fmt!r}")
    if not fields:
        raise ValueError("fields must contain at least one array")
    shapes = {np.asarray(a).shape for a in fields.values()}
    if len(shapes) != 1 or len(next(iter(shapes))) != 3:
        raise ValueError(f"fields must share one (nz, ny, nx) shape, "
                         f"got {sorted(shapes)}")
    nz, ny, nx = next(iter(shapes))
    dx, dy, dz = (float(s) for s in spacing)
    x0, y0, z0 = (float(o) for o in origin)
    ext = f"0 {nx - 1} 0 {ny - 1} 0 {nz - 1}"
    lines = []
    w = lines.append
    w('<?xml version="1.0"?>')
    w('<VTKFile type="ImageData" version="0.1" byte_order="LittleEndian" '
      'header_type="UInt64">')
    w(f'  <ImageData WholeExtent="{ext}" Origin="{x0} {y0} {z0}" '
      f'Spacing="{dx} {dy} {dz}">')
    w(f'    <Piece Extent="{ext}">')
    w('      <PointData>')
    for name, arr in fields.items():
        _data_array(w, np.asarray(arr, dtype=np.float64), "Float64", fmt,
                    name=name)
    w('      </PointData>')
    w('    </Piece>')
    w('  </ImageData>')
    w('</VTKFile>')
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def read_vti(path: str):
    """Parse a .vti written by write_vti: returns ({name: (nz, ny, nx)},
    spacing, origin). Round-trip test hook."""
    root = ET.parse(path).getroot()
    img = root.find("./ImageData")
    ext = [int(v) for v in img.find("./Piece").get("Extent").split()]
    nx, ny, nz = ext[1] + 1, ext[3] + 1, ext[5] + 1
    spacing = tuple(float(v) for v in img.get("Spacing").split())
    origin = tuple(float(v) for v in img.get("Origin").split())
    fields = {}
    for da in img.findall("./Piece/PointData/DataArray"):
        fields[da.get("Name")] = _decode_array(da).reshape(nz, ny, nx)
    return fields, spacing, origin


def save_volume_series(result, outdir: str, fmt: str = "binary") -> str:
    """One .vti per output snapshot + a ParaView .pvd collection — the 3-D
    analogue of the 2-D step-vtp pipeline (viz/map_output.py; reference
    util/FHNmodel/MapOutputToTorus.py:193-218's naming conventions:
    <prog>step/<prog>step_NNN.vti + <prog>VolumeSteps.pvd)."""
    cfg = result.cfg
    if cfg.surface != "box":
        raise ValueError("save_volume_series needs surface='box' "
                         f"(got {cfg.surface!r})")
    model = result.problem.model
    prog = cfg.program_name
    step_dir = os.path.join(outdir, f"{prog}step")
    os.makedirs(step_dir, exist_ok=True)
    traj = result.trajectory.cpu().numpy()   # (nt, nvars, nz, ny, nx)
    nvars = traj.shape[1] if cfg.include_all_vars else 1
    spacing = (cfg.dx, cfg.dy, cfg.dz)
    files = {}
    for k in range(traj.shape[0]):
        fields = {model.var_names[v]: traj[k, v] for v in range(nvars)}
        fname = os.path.join(step_dir, f"{prog}step_{k:03d}.vti")
        write_vti(fname, fields, spacing, fmt=fmt)
        files[float(result.touts[k])] = os.path.relpath(fname, outdir)
    return write_pvd(os.path.join(outdir, f"{prog}VolumeSteps.pvd"), files)


def volume_slice(result, var: int = 0, axis: str = "z", index=None):
    """(nt, ·, ·) slice of a box trajectory for the 2-D movie machinery
    (viz/plots.py::plot_movie accepts raw arrays). axis: "z" (default,
    mid-depth (ny, nx) plane), "y", or "x"; index defaults to the midpoint."""
    traj = result.trajectory.cpu().numpy()   # (nt, nvars, nz, ny, nx)
    ax = {"z": 2, "y": 3, "x": 4}[axis]
    n = traj.shape[ax]
    k = n // 2 if index is None else int(index)
    if not 0 <= k < n:
        raise ValueError(f"slice index {k} out of range for axis "
                         f"{axis!r} of extent {n}")
    return np.take(traj[:, var], k, axis=ax - 1)
