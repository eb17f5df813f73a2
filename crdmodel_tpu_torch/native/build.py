"""Build at first use, and bind with ctypes, the host library that writes
reference-format text rows (native/trajio.cpp; the counterpart of
crdmodel_tpu/native/build.py).

g++ -O2 -shared -fPIC compiles the source into crdmodel_tpu_torch/_build/
trajio-<hash of the source>/libtrajio.so, beside the CUDA kernels' builds
(ops/_build.py), never next to the source. A process that finds no g++, or
whose build fails, gets None from load(), and io/trajectory.py writes with
numpy instead: this is host text IO, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "trajio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
LIB_NAME = "libtrajio.so"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Where the library of this source and these flags lives."""
    with open(SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"trajio-{digest.hexdigest()[:16]}",
                        LIB_NAME)


def _compile(so: str) -> bool:
    """g++ into a temporary file beside `so`, renamed into place, so that
    processes building at once never load a half-written library."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load():
    """The ctypes library, built if needed, or None where it cannot be."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not os.path.exists(so) and not _compile(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.trajio_write_rows.restype = ctypes.c_int
        lib.trajio_write_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64,
        ]
        _lib = lib
        return _lib
