"""Raceline/waypoint CSV loading (reference: waypoint_follow.py:158-162 and
examples/config_example_map.yaml column schema).

Port of ``f1tenth_gym_tpu/utils/waypoints.py`` (numpy only, as there).
"""

from __future__ import annotations

import numpy as np


def load_waypoints(
    path: str,
    delimiter: str = ";",
    skiprows: int = 3,
    x_ind: int = 1,
    y_ind: int = 2,
    v_ind: int = 5,
) -> np.ndarray:
    """Load a raceline CSV -> (N, 3) array of [x, y, target_speed].

    Defaults match the example_waypoints.csv schema:
    ``s_m; x_m; y_m; psi_rad; kappa_radpm; vx_mps; ax_mps2`` with a 3-line
    header.
    """
    raw = np.loadtxt(path, delimiter=delimiter, skiprows=skiprows)
    return raw[:, [x_ind, y_ind, v_ind]]


def ring_waypoints(radius: float, speed: float = 4.0, n: int = 200) -> np.ndarray:
    """Synthetic circular raceline for generated ring tracks."""
    ang = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    return np.stack(
        [radius * np.cos(ang), radius * np.sin(ang), np.full(n, speed)], axis=1
    )
