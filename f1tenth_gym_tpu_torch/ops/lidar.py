"""Batched 2D LiDAR: sphere marching against a distance field, iTTC, noise.

Port of ``f1tenth_gym_tpu/ops/lidar.py`` (``make_scan_tables``,
``dt_lookup``, ``beam_theta_indices``, ``get_scan``, ``add_scan_noise``,
``check_ttc``); reference semantics of laser_models.py:55-217 and
:450-452. The marching engine is exact against the reference and is the
oracle the kernel engine is gated against.

Quirk kept on purpose: an out-of-bounds lookup reads ``dt[H-1, W-1]``,
the cell the reference's (-1, -1) index wraps to (laser_models.py:79-84).
``torch.remainder`` stands wherever JAX uses ``jnp.mod``: both take the
sign of the divisor, which the negative-angle cases depend on.
"""

from __future__ import annotations

import numpy as np
import torch

from f1tenth_gym_tpu_torch.config import (
    DEFAULT_EPS,
    DEFAULT_FOV,
    DEFAULT_MAX_RANGE,
    DEFAULT_SCAN_STD,
    DEFAULT_TTC_THRESH,
    resolve_device,
)
from f1tenth_gym_tpu_torch.state import MapData, ScanTables

TWO_PI = 2.0 * np.pi
# the marching loop reads whether any beam is still active (a host sync)
# once per this many steps; extra steps past convergence change nothing,
# since every update is masked by activity
_ANY_CHECK_PERIOD = 8


def make_scan_tables(
    num_beams: int = 1080,
    fov: float = DEFAULT_FOV,
    theta_dis: int = 2000,
    max_range: float = DEFAULT_MAX_RANGE,
    eps: float = DEFAULT_EPS,
    scan_std: float = DEFAULT_SCAN_STD,
    ttc_thresh: float = DEFAULT_TTC_THRESH,
    lidar_dist: float = 0.0,
    width: float = 0.31,
    lf: float = 0.15875,
    lr: float = 0.17145,
    dtype=torch.float32,
    device=None,
) -> ScanTables:
    """LiDAR LUTs + per-beam body geometry (laser_models.py:360-381,
    base_classes.py:122-158), computed in float64 on the host and cast."""
    dev = resolve_device(device)
    theta_arr = np.linspace(0.0, TWO_PI, num=theta_dis)
    angle_increment = fov / (num_beams - 1)
    theta_index_increment = theta_dis * angle_increment / TWO_PI
    scan_angles = -fov / 2.0 + np.arange(num_beams) * angle_increment

    # distance from the lidar to the edge of the car body along each beam
    dist_sides = width / 2.0
    dist_fr = (lf + lr) / 2.0
    sd = np.empty((num_beams,))
    for i in range(num_beams):
        ang = scan_angles[i]
        if ang > 0:
            if ang < np.pi / 2:
                sd[i] = min(dist_sides / np.sin(ang), dist_fr / np.cos(ang))
            else:
                sd[i] = min(dist_sides / np.cos(ang - np.pi / 2.0),
                            dist_fr / np.sin(ang - np.pi / 2.0))
        else:
            if ang > -np.pi / 2:
                sd[i] = min(dist_sides / np.sin(-ang), dist_fr / np.cos(-ang))
            else:
                sd[i] = min(dist_sides / np.cos(-ang - np.pi / 2.0),
                            dist_fr / np.sin(-ang - np.pi / 2.0))

    def as_t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=dev)

    return ScanTables(
        sines=as_t(np.sin(theta_arr)),
        cosines=as_t(np.cos(theta_arr)),
        scan_angles=as_t(scan_angles),
        beam_cosines=as_t(np.cos(scan_angles)),
        side_distances=as_t(sd),
        fov=as_t(fov),
        theta_index_increment=as_t(theta_index_increment),
        max_range=as_t(max_range),
        eps=as_t(eps),
        scan_std=as_t(scan_std),
        ttc_thresh=as_t(ttc_thresh),
        lidar_dist=as_t(lidar_dist),
    )


def dt_lookup(x, y, m: MapData):
    """Distance-field lookup (laser_models.py:55-104) at world (x, y);
    out-of-bounds positions read dt[H-1, W-1]."""
    h, w = m.dt.shape
    x_trans = x - m.orig_x
    y_trans = y - m.orig_y
    x_rot = x_trans * m.orig_c + y_trans * m.orig_s
    y_rot = -x_trans * m.orig_s + y_trans * m.orig_c
    # truncation toward zero, as the reference's int() and JAX's astype
    c = (x_rot / m.resolution).to(torch.int64)
    r = (y_rot / m.resolution).to(torch.int64)
    oob = ((x_rot < 0) | (x_rot >= w * m.resolution)
           | (y_rot < 0) | (y_rot >= h * m.resolution))
    r = torch.where(oob, h - 1, torch.clamp(r, 0, h - 1))
    c = torch.where(oob, w - 1, torch.clamp(c, 0, w - 1))
    return torch.take(m.dt, r * w + c)


def beam_theta_indices(pose_theta, tables: ScanTables, num_beams: int,
                       theta_dis: int):
    """Integer LUT index of every beam (laser_models.py:164-184)."""
    ti0 = theta_dis * (pose_theta - tables.fov / 2.0) / TWO_PI
    ti0 = torch.remainder(torch.remainder(ti0, theta_dis) + theta_dis,
                          theta_dis)
    i = torch.arange(num_beams, dtype=tables.theta_index_increment.dtype,
                     device=pose_theta.device)
    ti = torch.remainder(ti0[..., None] + i * tables.theta_index_increment,
                         theta_dis)
    return ti.to(torch.int64)


def get_scan(pose, m: MapData, tables: ScanTables, num_beams: int,
             theta_dis: int, max_iters: int = 1024):
    """Batched marching scan: pose (..., 3) -> ranges (..., num_beams).

    All beams march in lockstep. The loop stops when no beam is active
    (read every ``_ANY_CHECK_PERIOD`` steps) or after ``max_iters`` steps.
    """
    idx = beam_theta_indices(pose[..., 2], tables, num_beams, theta_dis)
    s = torch.take(tables.sines, idx)
    c = torch.take(tables.cosines, idx)
    x = pose[..., 0:1].expand(idx.shape)
    y = pose[..., 1:2].expand(idx.shape)
    dist = dt_lookup(x, y, m)
    total = dist
    i = 0
    while i < max_iters:
        for _ in range(min(_ANY_CHECK_PERIOD, max_iters - i)):
            active = (dist > tables.eps) & (total <= tables.max_range)
            x_new = x + dist * c
            y_new = y + dist * s
            d_new = dt_lookup(x_new, y_new, m)
            x = torch.where(active, x_new, x)
            y = torch.where(active, y_new, y)
            total = torch.where(active, total + d_new, total)
            dist = torch.where(active, d_new, dist)
            i += 1
        active = (dist > tables.eps) & (total <= tables.max_range)
        if not bool(active.any()):
            break
    return torch.minimum(total, tables.max_range)


def add_scan_noise(scan, scan_std, generator: torch.Generator):
    """Additive Gaussian beam noise (laser_models.py:450-452)."""
    noise = torch.randn(scan.shape, generator=generator, dtype=scan.dtype,
                        device=scan.device)
    return scan + scan_std * noise


def check_ttc(scan, vel, tables: ScanTables):
    """iTTC vs environment (laser_models.py:188-217): scan (..., B), vel
    (...,) -> (...,) bool. A zero projected velocity gives an inf/nan ttc
    that never satisfies 0 <= ttc < thresh, as in the reference."""
    proj_vel = vel[..., None] * tables.beam_cosines
    ttc = (scan - tables.side_distances) / proj_vel
    hit = (ttc < tables.ttc_thresh) & (ttc >= 0.0)
    return torch.where(vel != 0.0, hit.any(-1), False)
