"""Minimal VTK XML PolyData (.vtp) + ParaView collection (.pvd) writers
(a copy of crdmodel_tpu/viz/vtp.py, which imports no jax but cannot be
imported without running crdmodel_tpu/__init__.py, which does).

Dependency-free replacement for the reference's vtkXMLPolyDataWriter + lxml
pvd generation (util/FHNmodel/MapOutputToTorus.py:193-218,
util/GenTorus.py:54-59): the subset of the format these tools need (points,
triangle connectivity, named per-cell double arrays) is a few hundred bytes
of XML scaffolding, so no `vtk` module is needed. Files open in
ParaView/VTK unchanged. A small reader (`read_vtp`) serves round-trip
tests.

Arrays are written inline-base64 ("binary" in VTK XML terms) by default,
the encoded payload class vtkXMLPolyDataWriter produces, because a
per-value Python repr loop (fmt="ascii", the human-readable variant) is
several times slower at production grids.
"""

from __future__ import annotations

import base64
import struct
import xml.etree.ElementTree as ET

import numpy as np

_VTK_TYPES = {"Float64": np.float64, "Float32": np.float32,
              "Int64": np.int64, "Int32": np.int32}


def _fmt(arr, per_line=9):
    flat = np.asarray(arr).reshape(-1)
    parts = []
    for i in range(0, len(flat), per_line):
        parts.append(" ".join(repr(float(v)) if flat.dtype.kind == "f"
                              else str(int(v)) for v in flat[i:i + per_line]))
    return "\n".join(parts)


def _b64(arr) -> str:
    """Inline-binary payload: UInt64 little-endian byte-count header + raw
    array bytes, base64 as ONE block (matching header_type="UInt64" on the
    VTKFile element — VTK decodes the whole block then splits)."""
    raw = np.ascontiguousarray(arr).tobytes()
    return base64.b64encode(struct.pack("<Q", len(raw)) + raw).decode()


def _data_array(w, arr, vtk_type, fmt, name=None, ncomp=None, indent=8):
    pad = " " * indent
    attrs = f'type="{vtk_type}"'
    if name is not None:
        attrs += f' Name="{name}"'
    if ncomp is not None:
        attrs += f' NumberOfComponents="{ncomp}"'
    if fmt == "ascii":
        w(f'{pad}<DataArray {attrs} format="ascii">')
        w(_fmt(arr))
    else:
        w(f'{pad}<DataArray {attrs} format="binary">')
        w(_b64(arr))
    w(f'{pad}</DataArray>')


def write_vtp(path: str, points: np.ndarray, triangles: np.ndarray,
              cell_data: dict | None = None,
              point_data: dict | None = None,
              fmt: str = "binary") -> str:
    """points: (N,3) float; triangles: (M,3) int; cell_data/point_data:
    {name: (M,)/(N,) float arrays}. fmt: "binary" (inline base64, default)
    or "ascii"."""
    if fmt not in ("binary", "ascii"):
        raise ValueError(f"fmt must be binary|ascii, got {fmt!r}")
    points = np.asarray(points, dtype=np.float64)
    triangles = np.asarray(triangles, dtype=np.int64)
    n_pts, n_cells = len(points), len(triangles)
    lines = []
    w = lines.append
    w('<?xml version="1.0"?>')
    w('<VTKFile type="PolyData" version="0.1" byte_order="LittleEndian" '
      'header_type="UInt64">')
    w('  <PolyData>')
    w(f'    <Piece NumberOfPoints="{n_pts}" NumberOfVerts="0" '
      f'NumberOfLines="0" NumberOfStrips="0" NumberOfPolys="{n_cells}">')
    w('      <Points>')
    _data_array(w, points, "Float64", fmt, ncomp=3)
    w('      </Points>')
    w('      <Polys>')
    _data_array(w, triangles, "Int64", fmt, name="connectivity")
    _data_array(w, 3 * (np.arange(n_cells, dtype=np.int64) + 1),
                "Int64", fmt, name="offsets")
    w('      </Polys>')
    for tag, data in (("CellData", cell_data), ("PointData", point_data)):
        if data:
            w(f'      <{tag}>')
            for name, arr in data.items():
                _data_array(w, np.asarray(arr, dtype=np.float64),
                            "Float64", fmt, name=name)
            w(f'      </{tag}>')
    w('    </Piece>')
    w('  </PolyData>')
    w('</VTKFile>')
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def _decode_array(da):
    dtype = _VTK_TYPES[da.get("type", "Float64")]
    if da.get("format") == "binary":
        raw = base64.b64decode("".join(da.text.split()))
        (nbytes,) = struct.unpack("<Q", raw[:8])
        return np.frombuffer(raw[8:8 + nbytes], dtype=dtype)
    return np.fromstring(da.text, sep=" ", dtype=dtype)


def read_vtp(path: str):
    """Parse a .vtp written by write_vtp (ascii or inline-binary): returns
    (points, triangles, cell_data dict)."""
    root = ET.parse(path).getroot()
    piece = root.find("./PolyData/Piece")
    pts_el = piece.find("./Points/DataArray")
    points = _decode_array(pts_el).reshape(-1, 3)
    conn = offs = None
    for da in piece.findall("./Polys/DataArray"):
        if da.get("Name") == "connectivity":
            conn = _decode_array(da)
        elif da.get("Name") == "offsets":
            offs = _decode_array(da)
    tris = conn.reshape(-1, 3) if conn is not None else None
    cell_data = {}
    cd = piece.find("CellData")
    if cd is not None:
        for da in cd.findall("DataArray"):
            cell_data[da.get("Name")] = _decode_array(da)
    return points, tris, cell_data


def write_pvd(path: str, timestep_files: dict) -> str:
    """ParaView collection: {time: vtp_path} -> .pvd
    (reference util/FHNmodel/MapOutputToTorus.py:202-218, format-compatible).
    Times are formatted to one decimal place like the reference."""
    lines = ["<?xml version='1.0' encoding='iso-8859-1'?>",
             "<VTKFile type=\"Collection\" version=\"0.1\" "
             "byte_order=\"LittleEndian\" compressor=\"vtkZLibDataCompressor\">",
             "  <Collection>"]
    for time in sorted(timestep_files):
        tstr = repr(float("{0:.1f}".format(time)))
        lines.append(f'    <DataSet timestep="{tstr}" group="" part="0" '
                     f'file="{timestep_files[time]}"/>')
    lines += ["  </Collection>", "</VTKFile>"]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path
