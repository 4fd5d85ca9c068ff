"""Wall-segment extraction: occupancy raster -> polygonal wall segments.

Port of the extraction half of ``f1tenth_gym_tpu/ops/segments.py``
(``_extract_segments_native``, ``extract_wall_segments``,
``segments_from_map``). Only the native exact-boundary tracer
(``native/contour.cpp``) exists here: the JAX package's cv2 fallback needs
a library the port does not depend on, so a failed native build raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from f1tenth_gym_tpu_torch.utils.native import load as _load_native


def _extract_segments_native(
    bitmap: np.ndarray,
    resolution: float,
    origin: Tuple[float, float, float],
    simplify_tol_cells: float,
) -> Optional[np.ndarray]:
    """Native C++ boundary tracer: exact raster boundary (grid-corner
    vertices). None when the trace is empty."""
    lib = _load_native()
    if lib is None:
        raise RuntimeError(
            "the native contour tracer (f1tenth_gym_tpu_torch/native/"
            "contour.cpp) could not be built with g++; wall segments need it")
    wall = np.ascontiguousarray((bitmap <= 0).astype(np.uint8))
    h, w = wall.shape
    # on overflow the library returns -(segments_written + 1024), NOT the
    # total needed — keep growing the buffer until the trace fits
    max_segs = 4 * (h + w) + 65536
    while True:
        out = np.empty((max_segs, 4), np.float64)
        n = lib.extract_wall_segments(
            wall.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int(h), ctypes.c_int(w),
            ctypes.c_double(simplify_tol_cells),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int(max_segs),
        )
        if n >= 0 or max_segs > 64 * (h * w + 1):
            break
        max_segs *= 4
    if n <= 0:
        return None
    segs = out[:n]
    # grid-corner pixel coords -> map frame -> world frame
    cx = segs[:, [0, 2]] * resolution
    cy = segs[:, [1, 3]] * resolution
    c, s = np.cos(origin[2]), np.sin(origin[2])
    wx = cx * c - cy * s + origin[0]
    wy = cx * s + cy * c + origin[1]
    return np.stack([wx[:, 0], wy[:, 0], wx[:, 1], wy[:, 1]], axis=1)


def extract_wall_segments(
    bitmap: np.ndarray,
    resolution: float,
    origin: Tuple[float, float, float],
    simplify_tol_cells: float = 0.5,
) -> np.ndarray:
    """Occupancy bitmap (0 = wall) -> (K, 4) world-frame [ax, ay, bx, by]
    segments, Douglas-Peucker simplified (tolerance in cells)."""
    segs = _extract_segments_native(bitmap, resolution, origin,
                                    simplify_tol_cells)
    if segs is None:
        raise ValueError("the map has no wall boundary to trace")
    return segs


def segments_from_map(
    bitmap: np.ndarray,
    resolution: float,
    origin,
    simplify_tol_cells: float = 0.5,
    pad_multiple: int = 128,
    dtype=np.float32,
) -> np.ndarray:
    """(K, 4) wall segments rounded to the sim dtype, padded to a multiple
    of ``pad_multiple`` rows with far-away segments that never meet a ray.

    The rounding matters: the kernel table and the culling pack are both
    built from these rounded values (as in the JAX package)."""
    segs = extract_wall_segments(bitmap, resolution, origin, simplify_tol_cells)
    n_pad = -len(segs) % pad_multiple
    pad = np.tile(np.array([[1e7, 1e7, 1e7 + 1.0, 1e7]]), (n_pad, 1))
    return np.concatenate([segs, pad], axis=0).astype(dtype)
