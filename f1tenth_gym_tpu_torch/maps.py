"""Paths of the bundled map assets.

The maps are data files of the ``f1tenth_gym_tpu`` source tree
(``f1tenth_gym_tpu/maps/*.{png,yaml}``). The port reads them by path and
never imports that package.
"""

from __future__ import annotations

import os

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "f1tenth_gym_tpu", "maps")


def available_maps():
    """Names of all bundled maps."""
    return sorted(
        os.path.splitext(f)[0] for f in os.listdir(_DIR) if f.endswith(".yaml"))


def map_path(name: str) -> str:
    """Absolute path to a bundled map's yaml (pass to ``load_map``)."""
    path = os.path.join(_DIR, f"{name}.yaml")
    if not os.path.exists(path):
        raise KeyError(f"unknown bundled map {name!r}; have {available_maps()}")
    return path


def centerline_path(name: str) -> str:
    """Absolute path to a bundled map's raceline csv."""
    for suffix in ("_centerline.csv", "_waypoints.csv"):
        path = os.path.join(_DIR, f"{name}{suffix}")
        if os.path.exists(path):
            return path
    raise KeyError(f"no centerline for map {name!r}")
