"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point. It is
compiled with ``nvcc`` for sm_90a (Hopper) at first use into
``f1tenth_gym_tpu_torch/_build/`` and loaded with ``ctypes``; importing a
kernel module builds nothing. The kernels are built with ``-fmad=false``
and without fast math, so that each equals its plain torch version bit for
bit: no multiply-add is contracted and division stays IEEE.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", os.path.join("/usr", "local", "cuda"))
    return os.path.join(home, "bin", "nvcc")


def build(src: str, so: str) -> str:
    """Compile ``src`` for sm_90a into the shared library ``so``.

    Returns the compiler's resource report (``-Xptxas -v``); raises
    ``RuntimeError`` with its output when the build fails. The library is
    written under a per-process name and renamed into place."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return proc.stdout + proc.stderr


def load(src: str, so: str) -> ctypes.CDLL:
    """The library built from ``src``, rebuilt when missing or older than
    its source."""
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        build(src, so)
    return ctypes.CDLL(so)
