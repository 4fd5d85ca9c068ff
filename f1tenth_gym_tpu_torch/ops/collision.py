"""Batched collision geometry: body vertices, all-pairs overlap, opponent
ray cast.

Port of ``f1tenth_gym_tpu/ops/collision.py`` (``get_vertices``,
``collision_pairwise``, ``collision_multiple``, ``ray_cast_opponents``);
reference kernels collision_models.py:113-260 and laser_models.py:249-346.
The GJK loop of the reference is the branchless separating-axis test over
all vertex-pair axes (exact for 4-point hulls), and ``ray_cast_opponents``
works on any leading batch axes (envs, agents) at once.
"""

from __future__ import annotations

import numpy as np
import torch

from f1tenth_gym_tpu_torch.state import ScanTables


def get_vertices(pose, length, width):
    """Pose (..., 3) -> body corners (..., 4, 2) in the order [rear-left,
    rear-right, front-right, front-left] (collision_models.py:251-259)."""
    c = torch.cos(pose[..., 2])
    s = torch.sin(pose[..., 2])
    half_l = length / 2.0
    half_w = width / 2.0
    ones = torch.ones_like(c)
    bx = torch.stack([-half_l * ones, -half_l * ones, half_l * ones,
                      half_l * ones], -1)
    by = torch.stack([half_w * ones, -half_w * ones, -half_w * ones,
                      half_w * ones], -1)
    wx = pose[..., 0:1] + bx * c[..., None] - by * s[..., None]
    wy = pose[..., 1:2] + bx * s[..., None] + by * c[..., None]
    return torch.stack([wx, wy], -1)


def _project_minmax(vertices, axes):
    """vertices (..., V, 2), axes (..., K, 2) -> (min, max) each (..., K).

    Written as products and one sum per axis, the two-term dot product of
    ``jnp.einsum`` on the CPU."""
    proj = (axes[..., :, None, 0] * vertices[..., None, :, 0]
            + axes[..., :, None, 1] * vertices[..., None, :, 1])
    return proj.amin(-1), proj.amax(-1)


def collision_pairwise(vertices1, vertices2):
    """Exact convex-hull overlap test of two 4-point bodies (..., 4, 2) ->
    (...,) bool; touching hulls count as colliding, as in GJK."""
    # the 6 vertex pairs of a body, made on its device: numpy index arrays
    # would be copied to the card, and waited for, on every call
    ii, jj = torch.triu_indices(4, 4, 1, device=vertices1.device)

    def pair_axes(v):
        d = v[..., jj, :] - v[..., ii, :]  # (..., 6, 2)
        return torch.stack([-d[..., 1], d[..., 0]], -1)

    axes = torch.cat([pair_axes(vertices1), pair_axes(vertices2)], -2)
    min1, max1 = _project_minmax(vertices1, axes)
    min2, max2 = _project_minmax(vertices2, axes)
    separated = (max1 < min2) | (max2 < min1)
    return ~separated.any(-1)


def collision_multiple(vertices):
    """All-pairs agent collision (collision_models.py:184-212).

    vertices (..., A, 4, 2) -> collisions (..., A) float 0/1 and
    collision_idx (..., A) float, partner index or -1. The reference's
    pair loop overwrites collision_idx[k] while it iterates (i ascending,
    then j ascending), so the last value is the largest colliding j > k if
    any, else the largest colliding i < k.
    """
    A = vertices.shape[-3]
    ii, jj = torch.triu_indices(A, A, 1, device=vertices.device)
    colpair = collision_pairwise(vertices[..., ii, :, :],
                                 vertices[..., jj, :, :])  # (..., P)
    colmat = torch.zeros(vertices.shape[:-3] + (A, A), dtype=torch.bool,
                         device=vertices.device)
    colmat[..., ii, jj] = colpair
    colmat[..., jj, ii] = colpair

    idx = torch.arange(A, device=vertices.device)
    upper = colmat & (idx[None, :] > idx[:, None])  # j > k
    lower = colmat & (idx[None, :] < idx[:, None])  # j < k
    last_upper = torch.where(upper, idx, -1).amax(-1)
    last_lower = torch.where(lower, idx, -1).amax(-1)
    collision_idx = torch.where(last_upper >= 0, last_upper, last_lower)
    collisions = colmat.any(-1)
    dtype = vertices.dtype
    return collisions.to(dtype), collision_idx.to(dtype)


def _cross2(ax, ay, bx, by):
    return ax * by - ay * bx


def ray_cast_opponents(pose, scan, opp_vertices, tables: ScanTables):
    """Clip scans by the opponents' car boxes (laser_models.py:318-346).

    pose (..., 3); scan (..., B); opp_vertices (..., O, 4, 2). Beams inside
    each opponent's blocked-view window (laser_models.py:282-315) take the
    nearest ray/edge hit (``get_range``, laser_models.py:249-280).
    """
    B = scan.shape[-1]
    ox = pose[..., 0, None, None]   # (..., 1, 1)
    oy = pose[..., 1, None, None]
    theta = pose[..., 2]

    # --- blocked view window per opponent
    vecs_x = opp_vertices[..., 0] - ox  # (..., O, 4)
    vecs_y = opp_vertices[..., 1] - oy
    vert_angles = torch.atan2(vecs_y, vecs_x)
    ego_angle = torch.atan2(torch.sin(theta), torch.cos(theta))
    diff = ego_angle[..., None, None] - vert_angles
    diff = torch.where(diff > np.pi, diff - 2 * np.pi, diff)
    diff = torch.where(diff < -np.pi, diff + 2 * np.pi, diff)
    angles_with_x = -diff

    # nearest beam per vertex angle over the uniform scan_angles grid, in
    # closed form; np.argmin takes the LOWER index on exact half-bin ties,
    # so round half DOWN via ceil(x - 1/2). The increment is taken from
    # scan_angles in the sim dtype, as the JAX package does.
    angle0 = tables.scan_angles[0]
    inc_b = tables.scan_angles[1] - tables.scan_angles[0]
    inds = torch.clamp(torch.ceil((angles_with_x - angle0) / inc_b - 0.5),
                       0, B - 1)  # (..., O, 4)
    min_ind = inds.amin(-1)  # (..., O)
    max_ind = inds.amax(-1)
    beam_ids = torch.arange(B, device=scan.device, dtype=inds.dtype)
    in_window = ((beam_ids >= min_ind[..., None])
                 & (beam_ids <= max_ind[..., None]))  # (..., O, B)

    # --- ray/edge intersections: v3 = beam normal by angle addition
    ca_b = torch.cos(tables.scan_angles + np.pi / 2.0)  # (B,)
    sa_b = torch.sin(tables.scan_angles + np.pi / 2.0)
    ct = torch.cos(theta)[..., None]
    st = torch.sin(theta)[..., None]
    v3x = (ct * ca_b - st * sa_b)[..., None, None, :]  # (..., 1, 1, B)
    v3y = (st * ca_b + ct * sa_b)[..., None, None, :]

    va = opp_vertices                               # (..., O, 4, 2)
    vb = torch.roll(opp_vertices, shifts=-1, dims=-2)
    v1x = ox - va[..., 0]                           # (..., O, 4)
    v1y = oy - va[..., 1]
    v2x = vb[..., 0] - va[..., 0]
    v2y = vb[..., 1] - va[..., 1]

    denom = v2x[..., None] * v3x + v2y[..., None] * v3y   # (..., O, 4, B)
    d1 = (v2x * v1y - v2y * v1x)[..., None] / denom
    d2 = (v1x[..., None] * v3x + v1y[..., None] * v3y) / denom
    valid = (torch.abs(denom) > 0.0) & (d1 >= 0.0) & (d2 >= 0.0) & (d2 <= 1.0)
    inf = float("inf")
    dist = torch.where(valid, d1, inf)

    # collinear fallback (laser_models.py:275-278): denom == 0 and o, va,
    # vb collinear -> distance min(|va - o|, |vb - o|)
    ca_x = va[..., 0] - ox
    ca_y = va[..., 1] - oy
    collinear = torch.abs(_cross2(v2x, v2y, ca_x, ca_y)) < 1e-8  # (..., O, 4)
    da = torch.sqrt(v1x ** 2 + v1y ** 2)
    db = torch.sqrt((vb[..., 0] - ox) ** 2 + (vb[..., 1] - oy) ** 2)
    col_dist = torch.minimum(da, db)
    dist = torch.where((torch.abs(denom) <= 0.0) & collinear[..., None],
                       col_dist[..., None], dist)

    closest = dist.amin(-2)                               # (..., O, B)
    closest = torch.where(in_window, closest, inf)
    return torch.minimum(scan, closest.amin(-2))
