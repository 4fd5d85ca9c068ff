"""Host-side map pipeline: ROS map yaml + image -> MapData on a device.

Port of ``f1tenth_gym_tpu/utils/map_loader.py``, same arguments, mirroring
ScanSimulator2D.set_map (laser_models.py:383-427): read the image, flip it
top-bottom, binarize at 128, read resolution/origin, take the Euclidean
distance transform scaled by the resolution. With ``extract_segments``
the wall contours become the kernel's segment table, and with
``tile_culling`` the culled window pack is built (disk-cached).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.state import MapData
from f1tenth_gym_tpu_torch.utils.edt import euclidean_distance_transform
from f1tenth_gym_tpu_torch.utils.image_io import read_map_yaml, read_png


def load_map_image(map_img_path: str) -> np.ndarray:
    """Image file -> binarized float64 occupancy bitmap (0 obstacle, 255
    free), flipped so row 0 is the map's bottom edge."""
    img = read_png(map_img_path)[::-1].astype(np.float64)
    if img.ndim == 3:  # first channel, as the JAX loader does
        img = img[..., 0]
    return np.where(img <= 128.0, 0.0, 255.0)


def load_map_yaml(map_path: str) -> Tuple[float, Tuple[float, float, float], str]:
    meta = read_map_yaml(map_path)
    resolution = float(meta["resolution"])
    origin = tuple(float(v) for v in meta["origin"])
    return resolution, origin, meta.get("image", None)


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def make_map_data(
    bitmap: np.ndarray,
    resolution: float,
    origin: Tuple[float, float, float],
    dtype=torch.float32,
    extract_segments: bool = False,
    simplify_tol_cells: float = 1.5,
    tile_culling: bool = False,
    max_range: float = 30.0,
    culling_tile_size: float = 2.5,
    culling_neighborhood: int = 1,
    culling_split_cap: int = 0,
    culling_window_cap: int = None,
    culling_erosion: bool = True,
    culling_component_seed=None,
    device=None,
) -> MapData:
    """Occupancy bitmap (0 = obstacle) + metadata -> MapData on ``device``
    (default: the card). ``max_range`` must match the ScanTables the
    kernel runs with."""
    dev = resolve_device(device)

    def t(v, dt=dtype):
        return torch.as_tensor(v, dtype=dt, device=dev)

    dt = resolution * euclidean_distance_transform(bitmap > 0)
    extra = {}
    if extract_segments:
        from f1tenth_gym_tpu_torch.ops.scan_kernel import build_seg_table
        from f1tenth_gym_tpu_torch.ops.segments import segments_from_map

        segments = segments_from_map(bitmap, resolution, origin,
                                     simplify_tol_cells,
                                     dtype=_np_dtype(dtype))
        extra["segments"] = t(segments)
        extra["seg_table"] = t(build_seg_table(segments), torch.float32)
        if tile_culling:
            from f1tenth_gym_tpu_torch.ops.culling import build_tile_tables_cached

            tt = build_tile_tables_cached(
                segments, max_range,
                tile_size=culling_tile_size,
                neighborhood=culling_neighborhood,
                split_cap_groups=culling_split_cap,
                window_cap_groups=culling_window_cap,
                bitmap=(bitmap if culling_erosion else None),
                resolution=resolution,
                origin=origin,
                component_seed=culling_component_seed,
            )
            meta = np.asarray([tt.x0, tt.y0, 1.0 / tt.tile_size, tt.nx, tt.ny,
                               tt.neighborhood], np.float32)
            extra.update(
                tile_tables=t(tt.tables, torch.float32),
                tile_ngroups=t(tt.ngroups, torch.int32),
                tile_blockmap=t(tt.blockmap, torch.int32),
                tile_meta=t(meta, torch.float32),
                tile_meta_host=tuple(float(v) for v in meta),
            )
            # ext rides only when the pack HAS split blocks: a None tells
            # the kernel to skip the per-scan extras sweep
            if (tt.ext % 256).any():
                extra["tile_ext"] = t(tt.ext, torch.int32)
            if tt.eligible is not None:
                extra["cull_eligible"] = t(tt.eligible, torch.uint8)
    return MapData(
        dt=t(dt),
        orig_x=t(origin[0]),
        orig_y=t(origin[1]),
        orig_c=t(np.cos(origin[2])),
        orig_s=t(np.sin(origin[2])),
        resolution=t(resolution),
        **extra,
    )


def load_map(map_path: str, map_ext: str = ".png", dtype=torch.float32,
             extract_segments: bool = False,
             simplify_tol_cells: float = 1.5,
             tile_culling: bool = False,
             max_range: float = 30.0,
             culling_tile_size: float = 2.5,
             culling_neighborhood: int = 1,
             culling_split_cap: int = 0,
             culling_window_cap: int = None,
             culling_erosion: bool = True,
             culling_component_seed=None,
             device=None) -> MapData:
    """Load a ROS map yaml + PNG pair into a MapData on ``device``
    (default: the card). map_path: the .yaml, with or without extension."""
    if not map_path.endswith(".yaml"):
        map_path = map_path + ".yaml"
    resolution, origin, _ = load_map_yaml(map_path)
    bitmap = load_map_image(os.path.splitext(map_path)[0] + map_ext)
    return make_map_data(bitmap, resolution, origin, dtype=dtype,
                         extract_segments=extract_segments,
                         simplify_tol_cells=simplify_tol_cells,
                         tile_culling=tile_culling, max_range=max_range,
                         culling_tile_size=culling_tile_size,
                         culling_neighborhood=culling_neighborhood,
                         culling_split_cap=culling_split_cap,
                         culling_window_cap=culling_window_cap,
                         culling_erosion=culling_erosion,
                         culling_component_seed=culling_component_seed,
                         device=device)
