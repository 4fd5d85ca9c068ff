"""Experiment-config channel: a flat yaml file -> argparse Namespace.

Port of ``f1tenth_gym_tpu/utils/experiment.py``: the reference's
experiment yaml (examples/waypoint_follow.py:248-250; schema in
examples/config_example_map.yaml) holds map paths, the start pose, the
raceline csv with its column indices, controller gains, parameter bounds,
the optimization budget and a seed. Every key becomes a Namespace
attribute as it is, relative paths resolve against the yaml's directory,
and the raceline the wpt_* keys describe loads with one call. The file is
read with ``utils/image_io.py::read_flat_yaml``, which resolves values as
``yaml.safe_load`` does; a nested mapping raises.
"""

from __future__ import annotations

import os
from argparse import Namespace

import numpy as np

from f1tenth_gym_tpu_torch.utils.image_io import read_flat_yaml


def load_experiment_config(path: str) -> Namespace:
    """Load an experiment yaml into a Namespace (reference convention).

    Adds ``_config_dir`` (the yaml's directory) so relative ``map_path`` /
    ``wpt_path`` entries can be resolved with :func:`resolve_path`.
    """
    ns = Namespace(**read_flat_yaml(path))
    ns._config_dir = os.path.dirname(os.path.abspath(path))
    return ns


def resolve_path(conf: Namespace, p: str) -> str:
    """Resolve a config-relative path against the yaml's directory."""
    if os.path.isabs(p):
        return p
    return os.path.normpath(os.path.join(conf._config_dir, p))


def load_config_waypoints(conf: Namespace) -> np.ndarray:
    """Raceline described by the config's wpt_* keys -> (N, 3) [x, y, v].

    Honors wpt_path, wpt_delim, wpt_rowskip, wpt_xind, wpt_yind, wpt_vind
    (missing keys fall back to the example_waypoints.csv schema).
    """
    from f1tenth_gym_tpu_torch.utils.waypoints import load_waypoints

    return load_waypoints(
        resolve_path(conf, conf.wpt_path),
        delimiter=getattr(conf, "wpt_delim", ";"),
        skiprows=getattr(conf, "wpt_rowskip", 3),
        x_ind=getattr(conf, "wpt_xind", 1),
        y_ind=getattr(conf, "wpt_yind", 2),
        v_ind=getattr(conf, "wpt_vind", 5),
    )


def start_pose(conf: Namespace) -> np.ndarray:
    """(1, 3) start pose from the config's sx/sy/stheta keys."""
    return np.array([[conf.sx, conf.sy, conf.stheta]])
