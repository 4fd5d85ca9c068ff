"""Standalone ScanSimulator2D: the reference's scan-simulator object.

Port of ``f1tenth_gym_tpu/scan_sim.py``. The reference exposes
``ScanSimulator2D`` (laser_models.py:348-454) as a user-facing class:
construct it with a beam count and fov, ``set_map(path, ext)``, then
``scan(pose, rng)`` one pose at a time. ``scan_batch`` scans any batch of
poses at once, with any of the port's engines, on the card unless
``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from f1tenth_gym_tpu_torch.config import (
    DEFAULT_EPS,
    DEFAULT_FOV,
    DEFAULT_MAX_RANGE,
    DEFAULT_SCAN_STD,
    canonical_scan_engine,
    resolve_device,
)
from f1tenth_gym_tpu_torch.ops import lidar as lidar_ops
from f1tenth_gym_tpu_torch.ops import scan_kernel
from f1tenth_gym_tpu_torch.ops import segments as seg_ops
from f1tenth_gym_tpu_torch.state import MapData
from f1tenth_gym_tpu_torch.utils.map_loader import load_map


class ScanSimulator2D:
    """2D LiDAR simulator over a ROS-style occupancy map.

    Args (defaults mirror laser_models.py:360-381):
        num_beams, fov, eps, theta_dis, max_range, std_dev, engine
    engine: ``"march"`` (distance-field marching, exact against the
    reference), ``"segments"`` (ray/segment scan in torch ops) or
    ``"kernel"`` (the CUDA sweep; ``"pallas"`` is taken as ``"kernel"``).
    ``tile_culling=True`` builds the culled window pack for the kernel
    engine (ops/culling.py), worth it for large batches of clustered poses.
    """

    def __init__(
        self,
        num_beams: int = 1080,
        fov: float = DEFAULT_FOV,
        eps: float = DEFAULT_EPS,
        theta_dis: int = 2000,
        max_range: float = DEFAULT_MAX_RANGE,
        std_dev: float = DEFAULT_SCAN_STD,
        engine: str = "march",
        dtype=torch.float32,
        tile_culling: bool = False,
        device=None,
    ):
        self.num_beams = int(num_beams)
        self.fov = float(fov)
        self.eps = float(eps)
        self.theta_dis = int(theta_dis)
        self.max_range = float(max_range)
        self.std_dev = float(std_dev)
        self.engine = canonical_scan_engine(engine)
        if self.engine == "auto":
            raise ValueError("ScanSimulator2D needs an engine: 'march', "
                             "'segments' or 'kernel'")
        self.dtype = dtype
        self.tile_culling = bool(tile_culling)
        self.device = resolve_device(device)
        self.tables = lidar_ops.make_scan_tables(
            num_beams=self.num_beams, fov=self.fov, theta_dis=self.theta_dis,
            max_range=self.max_range, eps=self.eps, scan_std=self.std_dev,
            dtype=dtype, device=self.device)
        self.map_data: Optional[MapData] = None

    # -- reference API ------------------------------------------------------

    def set_map(self, map_path: str, map_ext: str = ".png") -> bool:
        """Load a map yaml/image pair (laser_models.py:383-427 semantics)."""
        return self.set_map_data(load_map(
            map_path, map_ext, dtype=self.dtype,
            extract_segments=self.engine != "march",
            tile_culling=self.tile_culling and self.engine == "kernel",
            max_range=self.max_range, device=self.device))

    def set_map_data(self, map_data: MapData) -> bool:
        """Use an already-built MapData (e.g. from tracks.synthetic) that
        lies on this simulator's device."""
        if map_data.device != self.device:
            raise ValueError(f"map tensors are on {map_data.device}, the "
                             f"simulator runs on {self.device}")
        if self.engine != "march" and map_data.segments is None:
            raise ValueError(f"engine '{self.engine}' needs MapData.segments: "
                             "build the map with extract_segments=True")
        self.map_data = map_data
        return True

    def scan(self, pose, rng: Optional[np.random.Generator] = None):
        """Single pose (3,) -> (num_beams,) numpy ranges, plus noise drawn
        from the NumPy Generator ``rng`` exactly as the reference draws it
        (laser_models.py:450-452), so fixed-seed sequences compare with
        it. For noise drawn on the device use ``scan_batch``."""
        pose = torch.as_tensor(np.asarray(pose), dtype=self.dtype)
        out = self.scan_batch(pose[None])[0].cpu().numpy()
        if rng is not None:
            out = out + rng.normal(0.0, self.std_dev, size=self.num_beams)
        return out

    def get_increment(self) -> float:
        return self.fov / (self.num_beams - 1)

    # -- batched extras -----------------------------------------------------

    def scan_batch(self, poses, generator: Optional[torch.Generator] = None):
        """(..., 3) poses -> (..., num_beams) ranges on the device; with
        ``generator`` (on that device), plus Gaussian noise drawn from it."""
        m = self.map_data
        if m is None:
            raise RuntimeError("call set_map() first")
        poses = torch.as_tensor(poses).to(device=self.device, dtype=self.dtype)
        if self.engine == "kernel":
            out = scan_kernel.scan(poses, m, self.tables, self.num_beams,
                                   self.theta_dis, device=self.device)
        elif self.engine == "segments":
            out = seg_ops.get_scan_segments(poses, m.segments, self.tables,
                                            self.num_beams, self.theta_dis)
        else:
            out = lidar_ops.get_scan(poses, m, self.tables, self.num_beams,
                                     self.theta_dis)
        if generator is not None:
            out = lidar_ops.add_scan_noise(out, self.tables.scan_std,
                                           generator)
        return out
