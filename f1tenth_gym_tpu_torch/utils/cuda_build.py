"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface: a launch
entry that takes the kernel's arguments and then a CUDA stream and returns
a CUDA error code, and ``<entry>_occupancy``, which takes a launch's shape
and then a pointer for each number it gives of the grid, and returns the
resident blocks an SM (<= 0 on error). ``KERNELS`` declares each kernel
once (``Kernel``): its source, both entries with their ctypes argument
types, and the name of its ``__global__`` function, which a trace of the
card shows. The ops modules launch the kernels through their declarations;
the tools and chip_smoke.py find, build and count them by walking the list.

A kernel is compiled with ``nvcc`` for sm_90a (Hopper) at its first use
into ``f1tenth_gym_tpu_torch/_build/`` and loaded with ``ctypes``;
importing builds nothing. The kernels are built with ``-fmad=false`` and
without fast math, so that each equals its plain torch version bit for
bit: no multiply-add is contracted and division stays IEEE.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
from typing import Optional, Tuple

import torch

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


@dataclasses.dataclass(eq=False)
class Kernel:
    """One hand-written kernel.

    ``label`` is the port's name for it (K1, ...); ``stem`` names its
    source ``csrc/<stem>.cu`` and its library ``_build/<stem>.so``;
    ``trace_name`` is its ``__global__`` function, which a trace of the
    card shows inside a longer, mangled name; ``span`` is the span of the
    racing step whose host range launches it (None: the step does not).
    ``entry`` takes ``args`` and then the stream; ``<entry>_occupancy``
    takes ``occupancy_args`` and then an ``int*`` for each of
    ``occupancy_outs``, the first of them ``grid_blocks``."""

    label: str
    stem: str
    trace_name: str
    span: Optional[str]
    entry: str
    args: Tuple
    occupancy_args: Tuple
    occupancy_outs: Tuple[str, ...] = ("grid_blocks",)
    _lib: Optional[ctypes.CDLL] = dataclasses.field(
        default=None, init=False, repr=False)

    @property
    def src(self) -> str:
        return os.path.join(CSRC_DIR, f"{self.stem}.cu")

    @property
    def so(self) -> str:
        return os.path.join(BUILD_DIR, f"{self.stem}.so")

    @property
    def occupancy_entry(self) -> str:
        return f"{self.entry}_occupancy"

    def argtypes(self) -> dict:
        """{C entry: its ctypes argument types}: the launch's arguments
        and the stream, the query's shape and its outputs' pointers."""
        return {self.entry: [*self.args, ctypes.c_void_p],
                self.occupancy_entry: [*self.occupancy_args] + [
                    ctypes.POINTER(ctypes.c_int)] * len(self.occupancy_outs)}

    def build(self) -> str:
        """Compile the source into ``_build/``; returns the compiler's
        resource report."""
        return build(self.src, self.so)

    def _load_cuda(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.src, self.so)
            for name, types in self.argtypes().items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = types, ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, device, *args) -> None:
        """Launch with ``args`` on the current stream of ``device``;
        raises, naming the kernel, when the entry returns a CUDA error."""
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(self._load_cuda(), self.entry)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.label} ({self.trace_name}) launch "
                               f"failed: CUDA error {err}")

    def occupancy(self, *args) -> dict:
        """The launch at the shape ``args`` on the current device: its
        resident blocks an SM, each of ``occupancy_outs``, and waves (grid
        blocks over the resident blocks of all SMs)."""
        outs = [ctypes.c_int(0) for _ in self.occupancy_outs]
        per_sm = getattr(self._load_cuda(), self.occupancy_entry)(
            *args, *map(ctypes.byref, outs))
        if per_sm <= 0:
            raise RuntimeError(f"{self.label} ({self.trace_name}) occupancy "
                               "query failed")
        got = {name: o.value for name, o in zip(self.occupancy_outs, outs)}
        sms = torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
        return dict(blocks_per_sm=per_sm, **got,
                    waves=got["grid_blocks"] / (per_sm * sms))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# the ray/segment LiDAR sweep (ops/scan_kernel.py)
K1 = Kernel("K1", "scan_kernel", "scan_sweep_kernel", "scan.k1",
            entry="scan_sweep",
            args=(_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _F, _F,
                  _I, _I, _I, _F, _F, _F, _F, _I, _I),
            occupancy_args=(_I,) * 6)
# the opponent overlay, off the racing step (ops/overlay_kernel.py)
K2 = Kernel("K2", "overlay_kernel", "overlay_kernel", None,
            entry="overlay_clip", args=(_P,) * 5 + (_I,) * 4,
            occupancy_args=(_I,) * 2)
# the racing step's opponent clip (ops/opp_clip_kernel.py)
K3 = Kernel("K3", "opp_clip_kernel", "opp_clip_kernel", "sim.opp_clip",
            entry="opp_clip", args=(_P,) * 5 + (_I,) * 9,
            occupancy_args=(_I,) * 4,
            occupancy_outs=("grid_blocks", "scans_per_block"))
KERNELS = (K1, K2, K3)
