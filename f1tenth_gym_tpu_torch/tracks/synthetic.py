"""Programmatic ring track for tests and probes.

Port of ``f1tenth_gym_tpu/tracks/synthetic.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from f1tenth_gym_tpu_torch.state import MapData
from f1tenth_gym_tpu_torch.utils.map_loader import make_map_data


def ring_track_bitmap(
    size: int = 512,
    resolution: float = 0.0625,
    track_width: float = 3.0,
    radius: Optional[float] = None,
) -> Tuple[np.ndarray, float, Tuple[float, float, float]]:
    """Annular track: free space between two concentric circles, world
    origin at the map center. Returns (bitmap, resolution, origin)."""
    if radius is None:
        radius = size * resolution / 4.0
    extent = size * resolution
    origin = (-extent / 2.0, -extent / 2.0, 0.0)
    ys, xs = np.mgrid[0:size, 0:size]
    wx = (xs + 0.5) * resolution + origin[0]
    wy = (ys + 0.5) * resolution + origin[1]
    r = np.sqrt(wx ** 2 + wy ** 2)
    free = np.abs(r - radius) < (track_width / 2.0)
    return np.where(free, 255.0, 0.0), resolution, origin


def ring_map_data(size: int = 512, resolution: float = 0.0625,
                  track_width: float = 3.0, radius: Optional[float] = None,
                  dtype=torch.float32, extract_segments: bool = False,
                  tile_culling: bool = False,
                  culling_tile_size: float = 2.5, device=None) -> MapData:
    bitmap, res, origin = ring_track_bitmap(size, resolution, track_width,
                                            radius)
    return make_map_data(bitmap, res, origin, dtype=dtype,
                         extract_segments=extract_segments,
                         tile_culling=tile_culling,
                         culling_tile_size=culling_tile_size, device=device)


def ring_start_poses(num_agents: int, radius: float, spacing: float = 1.0
                     ) -> np.ndarray:
    """Start poses at the ring's 3 o'clock position, staggered tangentially."""
    poses = np.zeros((num_agents, 3))
    for i in range(num_agents):
        ang = -i * spacing / radius
        poses[i, 0] = radius * np.cos(ang)
        poses[i, 1] = radius * np.sin(ang)
        poses[i, 2] = ang + np.pi / 2.0
    return poses
