"""Track builders: a ring, random generated tracks, multi-track worlds.

The exports of ``f1tenth_gym_tpu/tracks/__init__.py``; the multi-track
world is in ``tracks.multi``, as there.
"""

from f1tenth_gym_tpu_torch.tracks.synthetic import (
    ring_map_data,
    ring_start_poses,
    ring_track_bitmap,
)
from f1tenth_gym_tpu_torch.tracks.trackgen import (
    generate_centerline,
    random_track_map_data,
    rasterize_track,
    save_track,
)

__all__ = [
    "ring_map_data",
    "ring_start_poses",
    "ring_track_bitmap",
    "generate_centerline",
    "rasterize_track",
    "save_track",
    "random_track_map_data",
]
