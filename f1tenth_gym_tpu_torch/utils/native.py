"""Loader for the port's native C++ host library.

Port of ``f1tenth_gym_tpu/utils/native.py``. The sources in
``f1tenth_gym_tpu_torch/native/*.cpp`` (the exact Felzenszwalb EDT, the
wall-contour tracer and the umbra visibility sweep) are built with ``g++``
at first use into ``f1tenth_gym_tpu_torch/_build/`` and loaded with
``ctypes``. The build goes to a per-process temporary name and is renamed
into place, so parallel test workers never load a half-written library.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SO_PATH = os.path.join(BUILD_DIR, "libf1tenth_native.so")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _sources():
    return sorted(glob.glob(os.path.join(NATIVE_DIR, "*.cpp")))


def _needs_rebuild() -> bool:
    if not os.path.exists(SO_PATH):
        return True
    so_mtime = os.path.getmtime(SO_PATH)
    return any(os.path.getmtime(p) > so_mtime for p in _sources())


def build() -> str:
    """Compile the library (OpenMP when available); returns its path.
    Raises ``RuntimeError`` with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO_PATH}.tmp{os.getpid()}"
    errors = []
    for flags in (["-fopenmp"], []):  # openmp when available, else serial
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", *flags, "-o", tmp, *_sources()],
            capture_output=True, text=True, timeout=300)
        if proc.returncode == 0:
            os.replace(tmp, SO_PATH)
            return SO_PATH
        errors.append(proc.stderr)
    raise RuntimeError("building the native library failed:\n"
                       + "\n".join(errors))


def load() -> Optional[ctypes.CDLL]:
    """The shared library, built on first use; None if it cannot be built."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if _needs_rebuild():
        try:
            build()
        except (RuntimeError, OSError, subprocess.TimeoutExpired):
            if not os.path.exists(SO_PATH):
                return None
    try:
        lib = ctypes.CDLL(SO_PATH)
    except OSError:
        return None
    lib.edt_2d.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.edt_2d.restype = None
    lib.extract_wall_segments.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ]
    lib.extract_wall_segments.restype = ctypes.c_int
    lib.tile_blocked_mask.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.POINTER(ctypes.c_ubyte),
    ]
    lib.tile_blocked_mask.restype = None
    _LIB = lib
    return _LIB
