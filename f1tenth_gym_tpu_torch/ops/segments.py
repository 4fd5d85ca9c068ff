"""Wall segments: extraction from the raster, and the segments scan engine.

Port of ``f1tenth_gym_tpu/ops/segments.py``: the extraction half
(``_extract_segments_native``, ``extract_wall_segments``,
``segments_from_map``) and the ``"segments"`` engine ``get_scan_segments``
(:180-242). Only the native exact-boundary tracer (``native/contour.cpp``)
exists here: the JAX package's cv2 fallback needs a library the port does
not depend on, so a failed native build raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from f1tenth_gym_tpu_torch.ops.lidar import beam_theta_indices
from f1tenth_gym_tpu_torch.state import ScanTables
from f1tenth_gym_tpu_torch.utils.native import load as _load_native

# rows of one chunk of the segments engine; segment lists are padded to a
# multiple of it, so the chunks tile them
SEGMENT_CHUNK = 128


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
    dtype=np.float32,
) -> np.ndarray:
    """(K, 4) wall segments rounded to the sim dtype, padded to a multiple
    of ``SEGMENT_CHUNK`` rows with far-away segments that never meet a ray.

    The rounding matters: the kernel table and the culling pack are both
    built from these rounded values (as in the JAX package)."""
    segs = extract_wall_segments(bitmap, resolution, origin, simplify_tol_cells)
    n_pad = -len(segs) % SEGMENT_CHUNK
    pad = np.tile(np.array([[1e7, 1e7, 1e7 + 1.0, 1e7]]), (n_pad, 1))
    return np.concatenate([segs, pad], axis=0).astype(dtype)


def get_scan_segments(pose, segments: torch.Tensor, tables: ScanTables,
                      num_beams: int, theta_dis: int):
    """Batched scan against wall segments: pose (..., 3) -> (..., B).

    The beams are those of the marching engine (the theta-LUT directions
    of ``beam_theta_indices``); only the wall model differs. For ray
    o + t d and segment a + u e, with D = cross(d, e), t = cross(a - o, e)
    / D and u = cross(a - o, d) / D, a hit needs D != 0, t >= 0 and
    0 <= u <= 1, tested without division; the scan is the least t, then
    clamped to max_range. The segments, padded as ``segments_from_map``
    pads them, are taken ``SEGMENT_CHUNK`` rows at a time with a running
    min, so the temporaries are (..., B, SEGMENT_CHUNK).
    """
    idx = beam_theta_indices(pose[..., 2], tables, num_beams, theta_dis)
    dx = torch.take(tables.cosines, idx)[..., None]   # (..., B, 1)
    dy = torch.take(tables.sines, idx)[..., None]
    ox = pose[..., 0:1, None]                         # (..., 1, 1)
    oy = pose[..., 1:2, None]
    K = segments.shape[0]
    assert K % SEGMENT_CHUNK == 0, (
        f"segments length {K} is not a multiple of {SEGMENT_CHUNK}")
    best = torch.full(idx.shape, float("inf"), dtype=dx.dtype,
                      device=dx.device)
    for k0 in range(0, K, SEGMENT_CHUNK):
        seg = segments[k0:k0 + SEGMENT_CHUNK]
        ax, ay = seg[:, 0], seg[:, 1]
        ex = seg[:, 2] - ax
        ey = seg[:, 3] - ay
        rx = ax - ox                                  # (..., 1, Kc)
        ry = ay - oy
        D = dx * ey - dy * ex                         # (..., B, Kc)
        A = rx * ey - ry * ex                         # (..., 1, Kc)
        Bc = rx * dy - ry * dx                        # (..., B, Kc)
        # t = A/D >= 0 iff A and D agree in sign; u = Bc/D in [0, 1] iff
        # Bc agrees with D and |Bc| <= |D|
        pos = D > 0.0
        valid = (((A >= 0.0) == pos) & ((Bc >= 0.0) == pos)
                 & (torch.abs(Bc) <= torch.abs(D)) & (D != 0.0))
        t = torch.where(valid, A / D, float("inf"))
        best = torch.minimum(best, t.amin(-1))
    return torch.minimum(best, tables.max_range)
