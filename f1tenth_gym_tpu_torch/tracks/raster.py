"""Polygon fill on a raster, pixel for pixel as ``cv2.fillPoly``.

The JAX package rasterizes generated tracks with ``cv2.fillPoly``
(``tracks/trackgen.py:119``, ``:150-151``). The port's machine has no cv2,
and every byte downstream (the distance transform, the wall contours, the
culling pack) depends on the raster, so ``fill_poly`` reproduces OpenCV's
non-antialiased fill of one polygon with integer vertices exactly:

1. each edge's outline is drawn as an 8-connected Bresenham line, always
   from its left end: the major axis steps every pixel, and the minor axis
   steps where the error term, started at ``dx - 2 dy``, is negative;
2. the interior is filled scanline by scanline from the non-horizontal
   edges, with x in 16.16 fixed point: an edge from its top vertex
   (x0, y0) to (x1, y1) is active on the scanlines y0 <= y < y1, at
   ``(x0 << 16) + (y - y0) * dX`` with ``dX = trunc(((x1 - x0) << 16) /
   (y1 - y0))``; a scanline's active x's, sorted, pair up into spans
   ``[(xa + 65535) >> 16, xb >> 16]``, clipped to the raster.

Both passes are vectorised over all edges at once in numpy.
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16


def _ragged_arange(n: np.ndarray) -> np.ndarray:
    """0..n[0]-1, 0..n[1]-1, ... concatenated."""
    return np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)


def _outline(pts: np.ndarray):
    """(N, 2) int64 vertices -> the (x, y) pixels of the closed outline's
    8-connected lines, each drawn from its left end."""
    p0 = np.roll(pts, 1, axis=0)   # edge i runs from vertex i-1 to vertex i
    p1 = pts
    swap = p1[:, 0] < p0[:, 0]
    a = np.where(swap[:, None], p1, p0)
    b = np.where(swap[:, None], p0, p1)
    dx = b[:, 0] - a[:, 0]          # >= 0
    dy = b[:, 1] - a[:, 1]
    sy = np.where(dy < 0, -1, 1)
    ady = np.abs(dy)
    steep = ady > dx
    major = np.where(steep, ady, dx)
    minor = np.where(steep, dx, ady)
    count = major + 1
    edge = np.repeat(np.arange(len(pts)), count)
    k = _ragged_arange(count)
    M, m = major[edge], minor[edge]
    # minor steps taken after k major steps: the least j with
    # 2 M j >= 2 m k - M (the error term's closed form)
    j = np.where(M > 0, -((M - 2 * m * k) // np.maximum(2 * M, 1)), 0)
    st, sye = steep[edge], sy[edge]
    x = a[edge, 0] + np.where(st, j, k)
    y = a[edge, 1] + sye * np.where(st, k, j)
    return x, y


def _spans(pts: np.ndarray, height: int):
    """The fill's spans: (y, x_lo, x_hi) int64 arrays, inclusive, not yet
    clipped in x."""
    p0 = np.roll(pts, 1, axis=0)
    p1 = pts
    keep = p0[:, 1] != p1[:, 1]      # horizontal edges add no crossing
    p0, p1 = p0[keep], p1[keep]
    top_is_p0 = p0[:, 1] < p1[:, 1]
    top = np.where(top_is_p0[:, None], p0, p1)
    bot = np.where(top_is_p0[:, None], p1, p0)
    num = (p1[:, 0] - p0[:, 0]) << XY_SHIFT
    den = p1[:, 1] - p0[:, 1]
    dX = np.sign(num) * np.sign(den) * (np.abs(num) // np.abs(den))  # trunc
    y0 = np.maximum(top[:, 1], 0)
    y1 = np.minimum(bot[:, 1], height)
    n = np.maximum(y1 - y0, 0)
    edge = np.repeat(np.arange(len(top)), n)
    y = np.repeat(y0, n) + _ragged_arange(n)
    X = (top[edge, 0] << XY_SHIFT) + (y - top[edge, 1]) * dX[edge]
    # a closed polygon crosses each scanline an even number of times, so
    # the sorted crossings pair up within their scanline
    order = np.lexsort((X, y))
    y, X = y[order], X[order]
    lo = (X[0::2] + (1 << XY_SHIFT) - 1) >> XY_SHIFT
    return y[0::2], lo, X[1::2] >> XY_SHIFT


def fill_poly(img: np.ndarray, pts, color) -> np.ndarray:
    """Fill the polygon ``pts`` ((N, 2) or (N, 1, 2) integer vertices, x
    then y) on the 2-D array ``img`` in place with ``color``, as
    ``cv2.fillPoly(img, [pts], color)``. Returns ``img``. Exact for
    vertices inside the raster (OpenCV clips an outline that leaves it
    before drawing it, which moves the line's pixels)."""
    if img.ndim != 2:
        raise ValueError(f"fill_poly needs a 2-D raster, got {img.shape}")
    pts = np.asarray(pts)
    if not np.issubdtype(pts.dtype, np.integer):
        raise TypeError(f"fill_poly needs integer vertices, got {pts.dtype}")
    pts = pts.reshape(-1, 2).astype(np.int64)
    h, w = img.shape
    if len(pts) == 0:
        return img
    x, y = _outline(pts)
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    img[y[inside], x[inside]] = color
    ys, lo, hi = _spans(pts, h)
    lo, hi = np.maximum(lo, 0), np.minimum(hi, w - 1)
    ok = lo <= hi
    ys, lo, hi = ys[ok], lo[ok], hi[ok]
    n = hi - lo + 1
    rows = np.repeat(ys, n)
    cols = np.repeat(lo, n) + _ragged_arange(n)
    img[rows, cols] = color
    return img
