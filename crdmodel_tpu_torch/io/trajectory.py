"""Reference-compatible trajectory file IO (counterpart of
crdmodel_tpu/io/trajectory.py).

Writer: emits exactly the reference's per-rank text files from a SimResult:
  <prog>_subdomain.NNN.txt : "nx  ny  is  ie  js  je XMIN XMAX TFINAL"
                             (src/FHNmodel_torus.cpp:376-381)
  <prog>_<var0>.NNN.txt    : one line per output time (IC first), values
                             " %.16e"-formatted, x-fastest over the local
                             block (src/FHNmodel_torus.cpp:383-455)
  <prog>_<var1>.NNN.txt    : only when includeAllVars=1
The decomposition into virtual ranks follows the reference's arithmetic
(io/decomp.py), so downstream tooling, the reference's own Python scripts
included, cannot tell these files from the C++ program's. A float32 value
printed with " %.16e" reads back to the same float32 exactly.

Reader: probes subdomain files to count ranks and reassembles the global
(nt, ny, nx) array exactly like the reference plot scripts
(util/FHNmodel/plot_FHNmodel_torus.py:26-87). Works on files written by
the port, by the JAX package or by the original MPI binaries.

Rows go through the g++-built host library (native/trajio.cpp) when it
builds, else through numpy; WRITES counts the files each writer wrote
("g++" or "numpy").
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from crdmodel_tpu_torch.io.decomp import decompose
from crdmodel_tpu_torch.native import build as native_build

# files written by each row writer since the process started (or since a
# caller cleared it)
WRITES = collections.Counter()


def _as_float64(x) -> np.ndarray:
    """A tensor or array as a host float64 array (float32 -> float64 is
    exact)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _write_rows(path: str, data: np.ndarray, mode: str = "w") -> str:
    """data: (n_rows, n_cols) float64 -> ' %.16e'-formatted lines. Returns
    the writer that wrote them, "g++" or "numpy"."""
    data = np.ascontiguousarray(data, dtype=np.float64)
    lib = native_build.load()
    if lib is not None:
        rc = lib.trajio_write_rows(
            path.encode(), mode.encode(),
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            data.shape[0], data.shape[1])
        if rc == 0:
            WRITES["g++"] += 1
            return "g++"
    # numpy fallback (slower): savetxt has no leading-space format quirk,
    # so build lines manually
    with open(path, mode) as fh:
        for row in data:
            fh.write("".join(" %.16e" % v for v in row))
            fh.write("\n")
    WRITES["numpy"] += 1
    return "numpy"


def _write_subdomain(outdir: str, cfg, rank: int, i0: int, i1: int, j0: int,
                     j1: int) -> str:
    spath = os.path.join(outdir, f"{cfg.program_name}_subdomain."
                                 f"{rank:03d}.txt")
    with open(spath, "w") as fh:
        fh.write(f"{cfg.nx}  {cfg.ny}  {i0}  {i1}  {j0}  {j1} "
                 f"{cfg.xmin:f} {cfg.xmax:f} {cfg.t_final:f}\n")
    return spath


def write_reference_files(result, outdir: str, nprocs: int = 1,
                          include_all_vars: Optional[bool] = None) -> list:
    """Write a SimResult as reference-format per-rank files. Returns paths."""
    cfg = result.cfg
    prog = cfg.program_name
    model = result.problem.model
    if include_all_vars is None:
        include_all_vars = bool(cfg.include_all_vars)
    os.makedirs(outdir, exist_ok=True)
    subs = decompose(cfg.nx, cfg.ny, nprocs)
    traj = _as_float64(result.trajectory)   # (nt, nvars, ny, nx)
    nt = traj.shape[0]
    paths = []
    nvars_out = model.nvars if include_all_vars else 1
    for sub in subs:
        paths.append(_write_subdomain(outdir, cfg, sub.rank, sub.i_start,
                                      sub.i_end, sub.j_start, sub.j_end))
        for v in range(nvars_out):
            name = model.var_names[v]
            vpath = os.path.join(outdir, f"{prog}_{name}.{sub.rank:03d}.txt")
            block = traj[:, v, sub.j_start:sub.j_end + 1,
                         sub.i_start:sub.i_end + 1]
            _write_rows(vpath, block.reshape(nt, -1))
            paths.append(vpath)
    return paths


class ShardedReferenceWriter:
    """Incremental reference-format writer for sharded runs: one row per
    output time for every shard, the reference's IO pattern (per-rank
    fprintf per output step, src/FHNmodel_torus.cpp:437-455) with the
    shards as the ranks and no gather. Pass an instance as `on_snapshot=`
    to parallel/sharded.py::simulate_sharded_streaming, which hands it a
    Shards of each shard's physical block, pad cells removed.

    A shard's rank is its flat index in the mesh (row-major), as JAX's
    writer numbers its devices (crdmodel_tpu/io/trajectory.py:114-115), so
    the files form one set that read_reference_files and the reference plot
    scripts reassemble unchanged. A block's global offset along y is the
    height of the blocks above it in its mesh column, along x the width of
    those to its left in its mesh row.
    """

    def __init__(self, outdir: str, cfg, model, mesh,
                 include_all_vars: Optional[bool] = None):
        self.outdir = outdir
        self.cfg = cfg
        self.model = model
        self.mesh_shape = tuple(mesh.shape)
        self.prog = cfg.program_name
        if include_all_vars is None:
            include_all_vars = bool(cfg.include_all_vars)
        self.nvars_out = model.nvars if include_all_vars else 1
        os.makedirs(outdir, exist_ok=True)
        self._started = False

    def _start(self, blocks) -> None:
        py, px = self.mesh_shape
        heights = [b.shape[-2] for b in blocks[::px]]
        widths = [b.shape[-1] for b in blocks[:px]]
        if min(heights) == 0 or min(widths) == 0:
            raise ValueError("a shard of this mesh holds no physical cell; "
                             "its rank would have no file to write")
        j_starts = np.cumsum([0] + heights[:-1])
        i_starts = np.cumsum([0] + widths[:-1])
        for rank, blk in enumerate(blocks):
            iy, ix = divmod(rank, px)
            j0, i0 = int(j_starts[iy]), int(i_starts[ix])
            _write_subdomain(self.outdir, self.cfg, rank, i0,
                             i0 + blk.shape[-1] - 1, j0,
                             j0 + blk.shape[-2] - 1)
            for v in range(self.nvars_out):
                open(self._var_path(v, rank), "w").close()
        self._started = True

    def _var_path(self, v: int, rank: int) -> str:
        name = self.model.var_names[v]
        return os.path.join(self.outdir, f"{self.prog}_{name}.{rank:03d}.txt")

    def __call__(self, k: int, y) -> None:
        """Append snapshot k: y is the Shards of physical blocks
        (nvars, nyl, nxl) in mesh order."""
        del k  # rows are ordered by call sequence, like the reference
        blocks = list(y)
        if not self._started:
            self._start(blocks)
        for rank, blk in enumerate(blocks):
            block = _as_float64(blk)
            for v in range(self.nvars_out):
                _write_rows(self._var_path(v, rank),
                            block[v].reshape(1, -1), mode="a")


def probe_nprocs(outdir: str, prog: str) -> int:
    """Count rank files the way the plot scripts do
    (util/FHNmodel/plot_FHNmodel_torus.py:26-35)."""
    n = 0
    while os.path.exists(os.path.join(outdir, f"{prog}_subdomain.{n:03d}.txt")):
        n += 1
    return n


def _read_values(path: str) -> np.ndarray:
    with open(path) as fh:
        rows = [np.fromstring(line, dtype=np.float64, sep=" ")
                for line in fh if line.strip()]
    return np.vstack(rows)


def read_reference_files(outdir: str, prog: str, var: str):
    """Reassemble (nt, ny, nx) for variable `var` plus metadata dict —
    the inverse of write_reference_files, matching the plot scripts'
    reassembly (util/FHNmodel/plot_FHNmodel_torus.py:37-87)."""
    nprocs = probe_nprocs(outdir, prog)
    if nprocs == 0:
        raise FileNotFoundError(f"no {prog}_subdomain.*.txt in {outdir}")
    meta = None
    subs = []
    for r in range(nprocs):
        vals = np.loadtxt(
            os.path.join(outdir, f"{prog}_subdomain.{r:03d}.txt"))
        if meta is None:
            meta = {"nx": int(vals[0]), "ny": int(vals[1]),
                    "xmin": float(vals[6]), "xmax": float(vals[7]),
                    "t_final": float(vals[8])}
        elif int(vals[0]) != meta["nx"] or int(vals[1]) != meta["ny"]:
            raise ValueError("subdomain files incompatible")
        subs.append(tuple(int(v) for v in vals[2:6]))

    results = None
    nt = None
    for r, (i0, i1, j0, j1) in enumerate(subs):
        data = _read_values(os.path.join(outdir, f"{prog}_{var}.{r:03d}.txt"))
        if results is None:
            nt = data.shape[0]
            results = np.zeros((nt, meta["ny"], meta["nx"]))
        elif data.shape[0] != nt:
            raise ValueError(f"subdomain {r} has {data.shape[0]} != {nt} steps")
        nyl, nxl = j1 - j0 + 1, i1 - i0 + 1
        for k in range(nt):
            results[k, j0:j1 + 1, i0:i1 + 1] = data[k].reshape(nyl, nxl)
    return results, meta


def save_npz(result, path: str):
    """The whole (nt, nvars, ny, nx) trajectory in its own dtype, the output
    times, the per-interval stats and the config in one compressed npz: a
    superset of the reference's text contract at ~10x smaller size."""
    s = result.stats
    np.savez_compressed(
        path,
        trajectory=torch.as_tensor(result.trajectory).cpu().numpy(),
        touts=result.touts,
        steps=s.steps.cpu().numpy(),
        accepted=s.accepted.cpu().numpy(),
        rejected=s.rejected.cpu().numpy(),
        status=s.status.cpu().numpy(),
        config=repr(dataclasses.asdict(result.cfg)),
    )


def load_npz(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
