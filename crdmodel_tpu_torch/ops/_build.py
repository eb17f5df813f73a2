"""Build and load the port's CUDA kernels (csrc/*.cu).

nvcc compiles every source into one shared library with a plain C
interface, at first use, into crdmodel_tpu_torch/_build/<hash of the
sources and flags>/libcrdtorch.so; ctypes loads it. Nothing here runs at
import, so the package imports on machines without CUDA.
"""

from __future__ import annotations

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
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_DOUBLE = ctypes.c_double
_DOUBLEP = ctypes.POINTER(ctypes.c_double)

# C signature of each exported launcher (csrc/fused_step.cu)
_FUSED_STEP_ARGTYPES = ([_VOIDP] * 8 + [_INT, _VOIDP, _INT, _VOIDP]
                        + [_INT] * 6 + [_DOUBLEP] * 3
                        + [_DOUBLE, _DOUBLE, _VOIDP])
SIGNATURES = {
    "crd_fused_erk_step_f32": _FUSED_STEP_ARGTYPES,
    "crd_fused_erk_step_f64": _FUSED_STEP_ARGTYPES,
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


def library_path() -> str:
    """Build the library if this version of the sources has not been built
    yet; return its path. Raises RuntimeError with nvcc's output on failure."""
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as fh:
            digest.update(os.path.basename(src).encode() + fh.read())
    out_dir = os.path.join(BUILD_DIR, digest.hexdigest()[:16])
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.isfile(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with every launcher's argtypes and restype set."""
    lib = ctypes.CDLL(library_path())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build() -> float:
    """Build and load the kernels; return the seconds it took."""
    t0 = time.perf_counter()
    load_library()
    return time.perf_counter() - t0
