"""Euclidean distance transform with a native C++ fast path.

Port of ``f1tenth_gym_tpu/utils/edt.py``: the native Felzenszwalb &
Huttenlocher EDT (``native/edt.cpp``), with scipy as the fallback when the
library cannot be built. Distances are in cell units.
"""

from __future__ import annotations

import ctypes

import numpy as np

from f1tenth_gym_tpu_torch.utils.native import load as _load_native


def euclidean_distance_transform(free_mask: np.ndarray) -> np.ndarray:
    """Exact EDT of a boolean mask: distance (in cells) from each True cell
    to the nearest False cell; 0 on False cells (scipy semantics)."""
    free_mask = np.ascontiguousarray(free_mask.astype(np.uint8))
    lib = _load_native()
    if lib is not None:
        h, w = free_mask.shape
        out = np.empty((h, w), dtype=np.float64)
        lib.edt_2d(
            free_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(h),
            ctypes.c_int64(w),
        )
        return out
    from scipy.ndimage import distance_transform_edt

    return distance_transform_edt(free_mask)
