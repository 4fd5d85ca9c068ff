"""The opponent clip's fuzz ensemble, and an exact comparison.

Inputs for ``ops/opp_clip_kernel.py::opp_clip`` that reach every case the
clip treats apart (exactly collinear edges with and without the
reference's fallback, half-bin ties at both ends of a blocked-view window,
windows over the whole scan, inf and NaN scans), drawn with numpy from a
seed. The CPU tests hold the plain clip and a transcription of K3 to them,
and ``chip_smoke.py`` holds K3 itself to them on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from f1tenth_gym_tpu_torch.ops.lidar import make_scan_tables


def opp_clip_tables(beams, dtype, dev):
    """Scan tables whose increment is a power of two (fov 3.3-4.7 rad), so
    that every scan angle is exact: a vertex straight ahead of an ego at
    yaw 0 then lies exactly half-way between beams B/2 - 1 and B/2 when B
    is even, a tie that the clip's half-down rounding breaks downwards."""
    inc = 2.0 ** -round(-np.log2(4.7 / (beams - 1)))
    return make_scan_tables(num_beams=beams, fov=inc * (beams - 1),
                            dtype=dtype, device=dev)


def fuzz_opp_clip_inputs(envs, agents, tables, seed=0):
    """The opponent clip's fuzz ensemble, drawn with numpy from ``seed``:
    (x (envs, agents, 7), scans (envs, agents, B), vertices (envs, agents,
    4, 2)) in the tables' dtype and on their device. Agent 0 of an env
    lies anywhere, the others 0.5-12 m from it in every direction; 1 % of
    the beams are inf and 1 % NaN. Agent 0 of the first envs, in turn,
    sees agent 1's box (vertices given as they are, not from a pose):
    0, an edge exactly parallel to beam b and on its line (denom == 0,
    cross == 0: the collinear fallback); 1, the same edge 0.5 m off the
    line (denom == 0 without the fallback); 2 and 3, from yaw 0, a vertex
    straight ahead at either end of the window (a half-bin tie with
    ``opp_clip_tables``); 4, right behind it (the window wraps to the whole
    scan)."""
    angles = tables.scan_angles
    dt, dev = angles.dtype, angles.device
    np_dt = np.float32 if dt == torch.float32 else np.float64
    B = angles.shape[0]
    rng = np.random.default_rng(seed)
    E, A = envs, agents
    c0 = rng.uniform(-6, 6, (E, 1, 2))
    ang = rng.uniform(0, 2 * np.pi, (E, A, 1))
    dist = rng.uniform(0.5, 12.0, (E, A, 1))
    xy = c0 + dist * np.concatenate([np.cos(ang), np.sin(ang)], -1)
    xy[:, 0] = c0[:, 0]
    x = rng.normal(0.0, 1.0, (E, A, 7))
    x[..., 0:2] = xy
    x[..., 4] = rng.uniform(0, 2 * np.pi, (E, A))
    yaw = x[..., 4]
    half_l, half_w = 0.58 / 2, 0.31 / 2
    bx = np.array([-half_l, -half_l, half_l, half_l])
    by = np.array([half_w, -half_w, -half_w, half_w])
    c, s = np.cos(yaw)[..., None], np.sin(yaw)[..., None]
    verts = np.stack([xy[..., 0:1] + bx * c - by * s,
                      xy[..., 1:2] + bx * s + by * c], -1)   # (E, A, 4, 2)
    scans = rng.uniform(0.5, 30.0, (E, A, B))
    scans[rng.random((E, A, B)) < 0.01] = np.inf
    scans[rng.random((E, A, B)) < 0.01] = np.nan
    x, verts = x.astype(np_dt), verts.astype(np_dt)

    # the beam normals as the clip computes them, on the tables' device
    norm = torch.stack([torch.cos(angles + np.pi / 2.0),
                        torch.sin(angles + np.pi / 2.0)], -1).cpu().numpy()
    for e in range(min(E, 5 * max(1, E // 20))):
        kind = e % 5
        o = x[e, 0, 0:2].copy()
        x[e, 0, 4] = 0.0
        if kind < 2:
            # the edge va -> vb along beam b, the box on the normal's side
            cb, sb = norm[rng.integers(B // 4, 3 * B // 4)]
            va, d, n = (np.zeros(2, np_dt), np.array([sb, -cb], np_dt),
                        np.array([cb, sb], np_dt))
            box = [va, va + d, va + d + n, va + n]
            o = -2 * d if kind == 0 else -2 * d + np_dt(0.5) * n
            x[e, 0, 0:2] = o
        else:
            sign = np_dt(1.0 if kind == 2 else -1.0)
            near, far = o[0] + np_dt(3.0), o[0] + np_dt(3.5)
            side = o[1] + sign * np_dt(0.3)
            box = [(near, o[1]), (near, side), (far, side), (far, o[1])]
            if kind == 4:
                box = [(o[0] - np_dt(1.5), o[1] + np_dt(0.4)),
                       (o[0] - np_dt(1.5), o[1] - np_dt(0.4)),
                       (o[0] - np_dt(2.0), o[1] - np_dt(0.4)),
                       (o[0] - np_dt(2.0), o[1] + np_dt(0.4))]
        verts[e, 1] = np.array(box, np_dt)

    def dev_t(a):
        return torch.as_tensor(a.astype(np_dt), device=dev)

    return dev_t(x), dev_t(scans), dev_t(verts)


def same_bits(a, b):
    """Equal bit for bit, any two NaNs counting as equal."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype not in ints:
        return torch.equal(a, b)
    nan = torch.isnan(a) & torch.isnan(b)
    return bool(((a.view(ints[a.dtype]) == b.view(ints[a.dtype])) | nan).all())
