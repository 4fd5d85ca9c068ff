"""How far the program's wall segments lie from the map raster's walls.

The scan engine casts beams against (K, 4) wall segments that the program
traced from the raster and simplified (Douglas-Peucker, the
configuration's ``simplify_tol_cells``). The scan reference sweeps those
same segments, so this check holds the segments themselves to the raster:

* every corner of the raster's wall boundary (the edges between a wall
  cell and a free or outside cell) lies within the tolerance of some
  segment;
* every segment's end is such a corner;
* every segment's midpoint lies within the tolerance, plus half a cell,
  of a corner (the corners of a traced loop are a cell apart).

``wall_gap_cells`` is the largest of the three excesses over what each
allows, added to the tolerance, in cells: at most the tolerance when the
segments are sound.
"""

from __future__ import annotations

import numpy as np
import torch

FAR = 1e6
PAIRS = 1 << 22   # point pairs a block of the brute-force distances


def boundary_corners(free: np.ndarray) -> np.ndarray:
    """(N, 2) [x, y] corner-grid coordinates (cells) of the wall boundary:
    the ends of each edge between a wall cell and a non-wall 4-neighbour,
    outside the raster counting as free."""
    wall = np.pad(~free, 1, constant_values=False)
    core = wall[1:-1, 1:-1]
    r, c = np.nonzero(core & ~wall[:-2, 1:-1])     # free below: y = r
    pts = [np.stack([c, r], 1), np.stack([c + 1, r], 1)]
    r, c = np.nonzero(core & ~wall[2:, 1:-1])      # free above: y = r + 1
    pts += [np.stack([c, r + 1], 1), np.stack([c + 1, r + 1], 1)]
    r, c = np.nonzero(core & ~wall[1:-1, :-2])     # free left: x = c
    pts += [np.stack([c, r], 1), np.stack([c, r + 1], 1)]
    r, c = np.nonzero(core & ~wall[1:-1, 2:])      # free right: x = c + 1
    pts += [np.stack([c + 1, r], 1), np.stack([c + 1, r + 1], 1)]
    return np.unique(np.concatenate(pts, 0), axis=0).astype(np.float64)


def to_cells(segments: np.ndarray, resolution: float, origin) -> np.ndarray:
    """World-frame (K, 4) segments -> corner-grid cells, padding dropped."""
    segs = np.asarray(segments, np.float64)
    segs = segs[segs[:, 0] < FAR]
    ox, oy, th = (float(v) for v in origin)
    c, s = np.cos(th), np.sin(th)
    out = []
    for i in (0, 2):
        dx, dy = segs[:, i] - ox, segs[:, i + 1] - oy
        out += [(dx * c + dy * s) / resolution,
                (-dx * s + dy * c) / resolution]
    return np.stack(out, 1)


def _min_dist_to_segments(pts, segs):
    """(N,) distance from each point to its nearest segment."""
    a, b = segs[:, 0:2], segs[:, 2:4]
    e = b - a
    len2 = torch.clamp((e * e).sum(-1), min=1e-24)
    best = []
    block = max(1, PAIRS // segs.shape[0])
    for i in range(0, pts.shape[0], block):
        p = pts[i:i + block, None, :]
        u = torch.clamp(((p - a) * e).sum(-1) / len2, 0.0, 1.0)
        d = p - (a + u[..., None] * e)
        best.append((d * d).sum(-1).amin(-1))
    return torch.sqrt(torch.cat(best))


def _min_dist_to_points(q, pts):
    best = []
    block = max(1, PAIRS // pts.shape[0])
    for i in range(0, q.shape[0], block):
        d = q[i:i + block, None, :] - pts[None, :, :]
        best.append((d * d).sum(-1).amin(-1))
    return torch.sqrt(torch.cat(best))


def wall_gap_cells(free: np.ndarray, segments: np.ndarray, resolution: float,
                   origin, tol_cells: float, device="cpu") -> float:
    """The module docstring's number for ``segments`` against ``free``."""
    dev = torch.device(device)
    corners = torch.as_tensor(boundary_corners(free), device=dev)
    segs = torch.as_tensor(to_cells(segments, resolution, origin), device=dev)
    if segs.shape[0] == 0:
        return float("inf")
    cover = _min_dist_to_segments(corners, segs).max()
    ends = torch.cat([segs[:, 0:2], segs[:, 2:4]], 0)
    mids = 0.5 * (segs[:, 0:2] + segs[:, 2:4])
    end_off = _min_dist_to_points(ends, corners).max()
    mid_off = _min_dist_to_points(mids, corners).max() - 0.5
    return float(torch.stack([cover, end_off + tol_cells, mid_off]).max())
