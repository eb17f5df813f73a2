"""Build and load the port's CUDA kernels (csrc/*.cu).

At first use, one nvcc per source compiles the kernels in parallel (as
many at once as the machine has CPUs, build_jobs), and a last nvcc links
them into one shared library with a plain C interface,
crdmodel_tpu_torch/_build/<hash of the sources, headers and flags>/
libcrdtorch.so; ctypes loads it. Each compile's output, with ptxas's
registers, shared memory and spills of every kernel (-Xptxas -v), stays
beside the library as <source>.log (ptxas_report). Nothing here runs at
import, so the package imports on machines without CUDA.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
LIB_NAME = "libcrdtorch.so"

# sm_90a: Hopper with its architecture-specific instructions. -fmad=false
# keeps every multiply and add separately rounded, as PyTorch's ops are,
# so a kernel and its plain version round alike.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_DOUBLE = ctypes.c_double
_DOUBLEP = ctypes.POINTER(ctypes.c_double)
_INTP = ctypes.POINTER(ctypes.c_int)

# C signature of each exported launcher (csrc/fused_step.cu, fused_rkc.cu,
# fused_imex.cu, fused_divform.cu, fused_aniso.cu, fused_box3d.cu,
# fused_box3d_rkc.cu, fused_shard_step.cu, fused_shard_rkc.cu,
# fused_shard_imex.cu, fused_shard_divform.cu, fused_shard_box3d.cu,
# fused_shard_box3d_rkc.cu, fused_kstep.cu; the box launchers' forced
# instantiations are compiled apart, in csrc/*_forced.cu, and K1's, K2's,
# K3's, K8's, K9's and K10's for the six families beyond the base three in
# csrc/*_families.cu)
# the structured forcing of K1-K4 and K8-K11 after fz: amps, rows, cols;
# n_stim, n_cols, var1 (ops/kernel_common.py::StimConstants.launch_args)
_STIM = [_VOIDP] * 3 + [_INT] * 3
_FUSED_STEP_ARGTYPES = ([_VOIDP] * 5 + _STIM + [_VOIDP] * 3
                        + [_INT, _VOIDP, _INT, _VOIDP]
                        + [_INT] * 7 + [_DOUBLEP] * 3
                        + [_DOUBLE, _DOUBLE, _VOIDP])
# K2: y, y_new, ss, work, h, fz; the forcing; s, mu1_tab, ctab; s_cap;
# c0..c2; torus; aE, aW, aN, tissue; beta, beta_field, mask; has_freeze,
# kinetics, ny, nx
_FUSED_RKC_ARGTYPES = ([_VOIDP] * 6 + _STIM + [_VOIDP] * 3 + [_INT]
                       + [_VOIDP] * 3 + [_INT]
                       + [_VOIDP] * 4 + [_VOIDP, _INT, _VOIDP] + [_INT] * 4
                       + [_DOUBLE, _DOUBLE, _VOIDP])
_FUSED_IMEX_ARGTYPES = ([_VOIDP] * 5 + _STIM + [_VOIDP] * 3
                        + [_INT, _VOIDP, _INT, _VOIDP]
                        + [_INT] * 6 + [_DOUBLEP] * 4
                        + [_DOUBLE] * 3 + [_VOIDP])
_FUSED_DIVFORM_ARGTYPES = ([_VOIDP] * 5 + _STIM + [_VOIDP] * 5
                           + [_INT, _VOIDP] + [_INT] * 7
                           + [_DOUBLEP] * 3 + [_DOUBLE, _DOUBLE, _VOIDP])
_FUSED_ANISO_ARGTYPES = ([_VOIDP] * 9 + [_INT, _VOIDP] + [_INT] * 7
                         + [_DOUBLEP] * 3 + [_DOUBLE, _DOUBLE, _VOIDP])
# the box launchers' operator arguments (csrc/box3d.cuh
# CRD_BOX_OPERATOR_ARGS) and their common head (y, y_new, ss, capacity,
# n_blocks, work, h, fz)
_BOX_OPERATOR = ([_VOIDP] * 8 + [_INT, _VOIDP, _INT, _VOIDP] + [_INT] * 5
                 + [_DOUBLE, _DOUBLE, _VOIDP])
_BOX_HEAD = [_VOIDP] * 3 + [_INT, _INTP] + [_VOIDP] * 3
# the box launchers' structured forcing, after the operator's arguments:
# amps, rows, cols, the depth table z; n_stim, n_cols, var1
# (csrc/box3d.cuh CRD_BOX_STIM_ARGS)
_BOX_STIM = [_VOIDP] * 4 + [_INT] * 3
# K6: n_stages, the tableau, then the stream scheme's tile_y and z_chunk
_FUSED_BOX3D_ARGTYPES = (_BOX_HEAD + [_INT] + [_DOUBLEP] * 3 + [_INT] * 2
                         + _BOX_OPERATOR + _BOX_STIM)
# K7: s, mu1_tab, ctab; s_cap and the plan's min_tiles
_FUSED_BOX3D_RKC_ARGTYPES = (_BOX_HEAD + [_VOIDP] * 3 + [_INT] * 2
                             + _BOX_OPERATOR + _BOX_STIM)
# the shard box launchers: K6's and K7's arguments, then the halo and the
# physical extent (valid_rows, valid_cols) before the operator's (K12:
# then tile_y and z_chunk)
_FUSED_SHARD_BOX3D_ARGTYPES = (_BOX_HEAD + [_INT] + [_DOUBLEP] * 3
                               + [_INT] * 5 + _BOX_OPERATOR + _BOX_STIM)
_FUSED_SHARD_BOX3D_RKC_ARGTYPES = (_BOX_HEAD + [_VOIDP] * 3 + [_INT] * 5
                                   + _BOX_OPERATOR + _BOX_STIM)
_FUSED_SHARD_STEP_ARGTYPES = ([_VOIDP] * 5 + _STIM + [_VOIDP] * 3
                              + [_INT, _VOIDP, _INT, _VOIDP]
                              + [_INT] * 10 + [_DOUBLEP] * 3
                              + [_DOUBLE, _DOUBLE, _VOIDP])
# K9: K2's head (y, y_new, ss, work, h, fz; the forcing; s, mu1_tab, ctab;
# s_cap), the profile operator, then has_freeze, kinetics, nyl, nxl, halo,
# valid_rows, valid_cols and the sum tiles' sum_tx, sum_ty
_FUSED_SHARD_RKC_ARGTYPES = ([_VOIDP] * 6 + _STIM + [_VOIDP] * 3 + [_INT]
                             + [_VOIDP] * 3
                             + [_INT, _VOIDP, _INT, _VOIDP] + [_INT] * 9
                             + [_DOUBLE, _DOUBLE, _VOIDP])
_FUSED_SHARD_IMEX_ARGTYPES = ([_VOIDP] * 5 + _STIM + [_VOIDP] * 3
                              + [_INT, _VOIDP, _INT, _VOIDP]
                              + [_INT] * 9 + [_DOUBLEP] * 4
                              + [_DOUBLE] * 3 + [_VOIDP])
_FUSED_SHARD_DIVFORM_ARGTYPES = ([_VOIDP] * 5 + _STIM + [_VOIDP] * 4
                                 + [_INT, _VOIDP, _INT, _VOIDP, _INT, _VOIDP]
                                 + [_INT] * 10 + [_DOUBLEP] * 3
                                 + [_DOUBLE, _DOUBLE, _VOIDP])
# K14: y, y_out, ss, work, h, fz, n_commit, counts; full, k; K1's
# operator (c0..c2, torus, beta, beta_field, mask), then has_freeze,
# kinetics, ny, nx, tile_y, n_stages and the tableau
_FUSED_KSTEP_ARGTYPES = ([_VOIDP] * 8 + [_INT] * 2 + [_VOIDP] * 3
                         + [_INT, _VOIDP, _INT, _VOIDP] + [_INT] * 6
                         + [_DOUBLEP] * 3 + [_DOUBLE, _DOUBLE, _VOIDP])
SIGNATURES = {
    "crd_fused_erk_step_f32": _FUSED_STEP_ARGTYPES,
    "crd_fused_erk_step_f64": _FUSED_STEP_ARGTYPES,
    "crd_fused_rkc_step_f32": _FUSED_RKC_ARGTYPES,
    "crd_fused_rkc_step_f64": _FUSED_RKC_ARGTYPES,
    "crd_fused_imex_step_f32": _FUSED_IMEX_ARGTYPES,
    "crd_fused_imex_step_f64": _FUSED_IMEX_ARGTYPES,
    "crd_fused_divform_step_f32": _FUSED_DIVFORM_ARGTYPES,
    "crd_fused_divform_step_f64": _FUSED_DIVFORM_ARGTYPES,
    "crd_fused_aniso_step_f32": _FUSED_ANISO_ARGTYPES,
    "crd_fused_aniso_step_f64": _FUSED_ANISO_ARGTYPES,
    "crd_fused_box3d_step_f32": _FUSED_BOX3D_ARGTYPES,
    "crd_fused_box3d_step_f64": _FUSED_BOX3D_ARGTYPES,
    "crd_fused_box3d_rkc_step_f32": _FUSED_BOX3D_RKC_ARGTYPES,
    "crd_fused_box3d_rkc_step_f64": _FUSED_BOX3D_RKC_ARGTYPES,
    "crd_fused_shard_step_f32": _FUSED_SHARD_STEP_ARGTYPES,
    "crd_fused_shard_step_f64": _FUSED_SHARD_STEP_ARGTYPES,
    "crd_fused_shard_rkc_step_f32": _FUSED_SHARD_RKC_ARGTYPES,
    "crd_fused_shard_rkc_step_f64": _FUSED_SHARD_RKC_ARGTYPES,
    "crd_fused_shard_imex_step_f32": _FUSED_SHARD_IMEX_ARGTYPES,
    "crd_fused_shard_imex_step_f64": _FUSED_SHARD_IMEX_ARGTYPES,
    "crd_fused_shard_divform_step_f32": _FUSED_SHARD_DIVFORM_ARGTYPES,
    "crd_fused_shard_divform_step_f64": _FUSED_SHARD_DIVFORM_ARGTYPES,
    "crd_fused_shard_box3d_step_f32": _FUSED_SHARD_BOX3D_ARGTYPES,
    "crd_fused_shard_box3d_step_f64": _FUSED_SHARD_BOX3D_ARGTYPES,
    "crd_fused_shard_box3d_rkc_step_f32": _FUSED_SHARD_BOX3D_RKC_ARGTYPES,
    "crd_fused_shard_box3d_rkc_step_f64": _FUSED_SHARD_BOX3D_RKC_ARGTYPES,
    "crd_fused_kstep_f32": _FUSED_KSTEP_ARGTYPES,
    "crd_fused_kstep_f64": _FUSED_KSTEP_ARGTYPES,
    # K1, K2 and K3 for the six families beyond the base three
    # (csrc/*_families.cu): the base launchers' arguments
    "crd_fused_erk_step_families_f32": _FUSED_STEP_ARGTYPES,
    "crd_fused_erk_step_families_f64": _FUSED_STEP_ARGTYPES,
    "crd_fused_rkc_step_families_f32": _FUSED_RKC_ARGTYPES,
    "crd_fused_rkc_step_families_f64": _FUSED_RKC_ARGTYPES,
    "crd_fused_imex_step_families_f32": _FUSED_IMEX_ARGTYPES,
    "crd_fused_imex_step_families_f64": _FUSED_IMEX_ARGTYPES,
    # K8, K9 and K10 for them (csrc/fused_shard_*_families.cu): the base
    # launchers' arguments
    "crd_fused_shard_step_families_f32": _FUSED_SHARD_STEP_ARGTYPES,
    "crd_fused_shard_step_families_f64": _FUSED_SHARD_STEP_ARGTYPES,
    "crd_fused_shard_rkc_step_families_f32": _FUSED_SHARD_RKC_ARGTYPES,
    "crd_fused_shard_rkc_step_families_f64": _FUSED_SHARD_RKC_ARGTYPES,
    "crd_fused_shard_imex_step_families_f32": _FUSED_SHARD_IMEX_ARGTYPES,
    "crd_fused_shard_imex_step_families_f64": _FUSED_SHARD_IMEX_ARGTYPES,
    # (f64, kinetics, n_stages, tile_y, out[3]), (f64, divform, kinetics,
    # out[3]), (f64, kinetics, out[3]), (f64, kinetics, tile_y, out[3]) and
    # (f64, mode, kinetics, out[3]): a kernel's blocks an SM, registers,
    # shared bytes
    "crd_fused_kstep_info": [_INT] * 4 + [_INTP],
    "crd_fused_rkc_info": [_INT] * 3 + [_INTP],
    "crd_fused_erk_step_info": [_INT] * 2 + [_INTP],
    "crd_fused_imex_info": [_INT] * 3 + [_INTP],
    "crd_fused_divform_info": [_INT] * 2 + [_INTP],
    "crd_fused_aniso_info": [_INT] * 2 + [_INTP],
    "crd_fused_shard_step_info": [_INT] * 2 + [_INTP],
    "crd_fused_shard_rkc_info": [_INT] * 2 + [_INTP],
    "crd_fused_shard_imex_info": [_INT] * 2 + [_INTP],
    "crd_fused_shard_divform_info": [_INT] * 3 + [_INTP],
    # (f64, mode, kinetics, out[3]): the box stream kernels
    "crd_fused_box3d_info": [_INT] * 3 + [_INTP],
    "crd_fused_shard_box3d_info": [_INT] * 3 + [_INTP],
    "crd_fused_box3d_rkc_info": [_INT] * 3 + [_INTP],
    "crd_fused_shard_box3d_rkc_info": [_INT] * 3 + [_INTP],
    # (f64, kinetics, out[3]), (f64, kinetics, out[3]) and (f64, kinetics,
    # tile_y, out[3]): the families' K1 (bs32), K2 and K3
    "crd_fused_erk_step_families_info": [_INT] * 2 + [_INTP],
    "crd_fused_rkc_families_info": [_INT] * 2 + [_INTP],
    "crd_fused_imex_families_info": [_INT] * 3 + [_INTP],
    # (f64, kinetics, out[3]) each: the families' K8 (bs32), K9 and K10
    "crd_fused_shard_step_families_info": [_INT] * 2 + [_INTP],
    "crd_fused_shard_rkc_families_info": [_INT] * 2 + [_INTP],
    "crd_fused_shard_imex_families_info": [_INT] * 2 + [_INTP],
}


def _sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from "
                       f"{CSRC_DIR} at first use")


def _out_dir() -> str:
    """The build directory of this version of the sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as fh:
            digest.update(os.path.basename(src).encode() + fh.read())
    return os.path.join(BUILD_DIR, digest.hexdigest()[:16])


def build_jobs() -> int:
    """The nvcc processes the build runs at once: one a CPU this process
    may use. More only share the CPUs, and the build takes longer
    (scripts/build_times.py --jobs times it at other counts)."""
    return len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else (os.cpu_count() or 1)


def library_path() -> str:
    """Build the library if this version of the sources has not been built
    yet; return its path. Raises RuntimeError with nvcc's output on failure."""
    sources = _sources()
    out_dir = _out_dir()
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        cus = [src for src in sources if src.endswith(".cu")]
        objects = [os.path.join(tmp_dir, os.path.basename(src) + ".o")
                   for src in cus]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                    for src, obj in zip(cus, objects)]
        with concurrent.futures.ThreadPoolExecutor(build_jobs()) as pool:
            procs = list(pool.map(
                lambda cmd: subprocess.run(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), compiles))
        for cmd, proc in zip(compiles, procs):
            output = proc.stdout
            _check_nvcc(cmd, proc.returncode, output)
            with open(os.path.join(out_dir, os.path.basename(cmd[-1])
                                   + ".log"), "w") as fh:
                fh.write(output)
        tmp_lib = os.path.join(tmp_dir, LIB_NAME)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib, *objects]
        proc = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, proc.returncode, proc.stdout + proc.stderr)
        os.replace(tmp_lib, lib)   # atomic: a loader sees all or nothing
    return lib


def _check_nvcc(cmd, returncode, output):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{output}")


def ptxas_report(source: str) -> list:
    """ptxas's lines on each kernel of csrc/<source> in the current build
    (registers, shared memory, spills), after library_path() has built it."""
    with open(os.path.join(_out_dir(), source + ".log")) as fh:
        return [line.strip() for line in fh
                if "ptxas" in line or "spill" in line]


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with every launcher's argtypes and restype set."""
    lib = ctypes.CDLL(library_path())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def kernel_info(name: str, *args) -> dict:
    """A launcher's kernel on the current card through its query
    crd_*_info(*args, out): resident blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's threads
    and dynamic shared memory), registers a thread and shared bytes a
    block. Raises if the query fails."""
    out = (ctypes.c_int * 3)()
    rc = getattr(load_library(), name)(*args, out)
    if rc != 0:
        raise RuntimeError(f"{name}{args}: CUDA error {rc}")
    return {"blocks_per_sm": out[0], "registers": out[1],
            "shared_bytes": out[2]}


def build() -> float:
    """Build and load the kernels; return the seconds it took."""
    t0 = time.perf_counter()
    load_library()
    return time.perf_counter() - t0
