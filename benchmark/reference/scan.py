"""Plain reference of the LiDAR scan against wall segments, in torch ops.

The configuration's scan engine casts every beam against the map's wall
segments and keeps the nearest hit (the theta-LUT beam directions of
``laser_models.py:164-184``, clamped at max_range). This is that sweep
over the whole segment list, with no culling, no row skip and no kernel:
the table of unit normals and scaled tangents is worked out again here in
float64 from the (K, 4) segments, and the beam directions and the hit test
follow the float32 order of the configuration's engine, so that a sound
program reads the same bits. Computed in another dtype (the benchmark's
lower-precision control) every step runs in that dtype.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = 2.0 * np.pi
GROUP = 8       # rows a group of the table
FAR = 1e6       # padding segments lie beyond this (never meet a ray)


def seg_table(segments: np.ndarray, dtype=torch.float32,
              device="cpu") -> torch.Tensor:
    """(K, 4) [ax, ay, bx, by] -> (Kp, 8) rows [nx, ny, c, txn, tyn, -w0n,
    0, 0]: n the unit normal (c - n.o is a signed distance), the tangent
    scaled by 1/|e|^2. Degenerate and padding rows never match."""
    segs = np.asarray(segments, np.float64)
    segs = segs[segs[:, 0] < FAR]
    ax, ay, bx, by = segs.T
    ex, ey = bx - ax, by - ay
    len2 = ex * ex + ey * ey
    ok = len2 > 0
    len2 = np.where(ok, len2, 1.0)
    ln = np.sqrt(len2)
    nx, ny = -ey / ln, ex / ln
    c = nx * ax + ny * ay
    w0n = (ax * ex + ay * ey) / len2
    out = np.stack([nx, ny, c, ex / len2, ey / len2, -w0n,
                    np.zeros_like(c), np.zeros_like(c)], 1)
    out[~ok] = 0.0
    out[~ok, 2] = 1.0
    out[~ok, 5] = 10.0
    pad = -len(out) % GROUP
    if pad:
        rows = np.zeros((pad, 8))
        rows[:, 2] = 1.0
        rows[:, 5] = 10.0
        out = np.concatenate([out, rows], 0)
    return torch.as_tensor(out.astype(np.float32), device=device).to(dtype)


def scan(pose: torch.Tensor, table: torch.Tensor, t: dict, num_beams: int,
         theta_dis: int) -> torch.Tensor:
    """Ranges (..., B) of the scans at ``pose`` (..., 3) against ``table``;
    computed in the table's dtype."""
    dt = table.dtype
    batch = pose.shape[:-1]
    p = pose.reshape(-1, 3).to(dt)
    dev = p.device
    fov = t["fov"].to(dt)
    angle_inc = fov / (num_beams - 1)
    two_pi = torch.tensor(TWO_PI, dtype=dt)
    ti0 = theta_dis * (p[:, 2] - fov / 2.0) / two_pi
    ti0 = torch.remainder(torch.remainder(ti0, theta_dis) + theta_dis,
                          theta_dis)
    bin_to_rad = float(torch.tensor(TWO_PI / (theta_dis - 1), dtype=dt))
    inv_td = float(torch.tensor(1.0 / theta_dis, dtype=dt))
    inc = torch.tensor(theta_dis, dtype=dt) * angle_inc / two_pi
    alpha = ti0 * bin_to_rad
    beta = inc * bin_to_rad
    n_idx = torch.arange(num_beams, dtype=dt, device=dev)
    cnb, snb = torch.cos(n_idx * beta), torch.sin(n_idx * beta)
    ca, sa = torch.cos(alpha)[:, None], torch.sin(alpha)[:, None]

    # beam directions: the LUT angle's residual g by its Taylor pair
    tt = ti0[:, None] + n_idx * inc
    k = torch.floor(tt * inv_td)
    g = (tt - torch.floor(tt) + k) * bin_to_rad
    cg = 1.0 - 0.5 * g * g
    cos_t = ca * cnb - sa * snb
    sin_t = sa * cnb + ca * snb
    dx = cos_t * cg + sin_t * g
    dy = sin_t * cg - cos_t * g

    ox, oy = p[:, 0:1], p[:, 1:2]
    n = p.shape[0]
    acc = torch.zeros((n, num_beams), dtype=dt, device=dev)
    chunk = max(GROUP, (1 << 25) // max(1, n * num_beams) // GROUP * GROUP)
    for r0 in range(0, table.shape[0], chunk):
        rows = table[r0:r0 + chunk]
        nx, ny, c, tx, ty, wn = (rows[:, i] for i in range(6))
        num = c - ox * nx - oy * ny                       # (n, R)
        num = torch.where(torch.abs(num) < 1e-12, 1e-12, num)
        inv = 1.0 / num
        uo = ox * tx + oy * ty + wn
        dxe, dye = dx[:, :, None], dy[:, :, None]
        den = nx * dxe + ny * dye                         # (n, B, R)
        s = den * inv[:, None, :]
        ud = tx * dxe + ty * dye
        b = uo[:, None, :] * s + ud
        q = torch.minimum(b, s - b)
        acc = torch.maximum(acc, torch.where(q >= 0, s, 0.0).amax(-1))
    maxr = t["max_range"].to(dt)
    out = torch.minimum(1.0 / torch.clamp(acc, min=1e-9), maxr)
    return out.reshape(*batch, num_beams)
