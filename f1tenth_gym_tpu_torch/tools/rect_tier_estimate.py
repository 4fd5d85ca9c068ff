"""One-off estimate: would 2x1 / 1x2 rectangular window tiers beat 2x2?

Port of ``tools/rect_tier_estimate.py``. For the bench workload's
``sub``-scan subgroups, computes the mean swept group count under (a) the
shipped square tiers (1x1/2x2/4x4/8x8) and (b) the square tiers plus
rectangular 2x1/1x2 tiers for single-axis straddles, from the per-tile
visibility masks of ``ops/culling.py::tile_visibility`` and its window
union. Host-only: it runs on the CPU unless given ``--device``.

    BENCH_CULL_TS=0.85 python -m f1tenth_gym_tpu_torch.tools.rect_tier_estimate --sub 2

Knobs: BENCH_CULL_TS (0.85), BENCH_ENVS (4096); ``--sub`` (8, the JAX
probe's ``F1TENTH_PALLAS_SUB``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from f1tenth_gym_tpu_torch.ops.culling import _window_union, tile_visibility
from f1tenth_gym_tpu_torch.ops.scan_kernel import GROUP, SUB
from f1tenth_gym_tpu_torch.tools import common


def rect_union(v, wx, wy):
    """(ny, nx, K) per-tile masks -> the union over the wx x wy tile
    window [i, i+wx) x [j, j+wy), clamped at the grid edge."""
    ny, nx, K = v.shape
    vp = np.zeros((ny + wy - 1, nx + wx - 1, K), bool)
    vp[:ny, :nx] = v
    u = np.zeros_like(v)
    for dj in range(wy):
        for di in range(wx):
            u |= vp[dj:dj + ny, di:di + nx]
    return u


def estimate(md, poses, ts: float, sub: int = SUB) -> dict:
    """Mean swept groups a subgroup under the square tiers (``square``)
    and with the 2x1/1x2 tiers too (``rect``), for the map's segments at
    ``ts`` m tiles and ``poses`` (E, 2, 3) as the sampler drew them (they
    are sorted here by the JAX probe's own tile-snake key, and padded to
    ``sub`` scans with the last pose)."""
    segs = md.segments.cpu().numpy().astype(np.float64)
    segs = segs[segs[:, 0] < 1e6]
    xs = np.concatenate([segs[:, 0], segs[:, 2]])
    ys = np.concatenate([segs[:, 1], segs[:, 3]])
    bbox = (xs.min() - 1e-6, ys.min() - 1e-6, xs.max() + 1e-6,
            ys.max() + 1e-6)
    vis, nx, ny, x0, y0 = tile_visibility(segs, 30.0, ts, bbox)
    v = vis.reshape(ny, nx, -1)

    def gcount(m):  # padded group count per flattened tile, sentinel->full
        c = m.reshape(-1, m.shape[-1]).sum(-1)
        return np.ceil(np.maximum(c, 1) / GROUP)

    full_ng = np.ceil(len(segs) / GROUP)
    g1 = gcount(v)
    g2 = gcount(_window_union(v, 2))
    g21 = gcount(rect_union(v, 2, 1))
    g12 = gcount(rect_union(v, 1, 2))
    g4 = gcount(_window_union(v, 4))
    g8 = gcount(_window_union(v, 8))

    poses = np.asarray(poses, np.float32)
    tx = (poses[:, :, 0].mean(1) - x0) / ts
    ty = (poses[:, :, 1].mean(1) - y0) / ts
    ti_, tj_ = np.floor(tx), np.floor(ty)
    snake = np.where(tj_ % 2 == 0, ti_, 4095.0 - ti_)
    fx, fy = np.floor((tx - ti_) * 2), np.floor((ty - tj_) * 2)
    fxs = np.where(fy % 2 == 0, fx, 1.0 - fx)
    key = (tj_ * 4096.0 + snake) * 4.0 + fy * 2.0 + fxs
    p = poses[np.argsort(key, kind="stable")].reshape(-1, 3)

    n_pad = -(-len(p) // sub) * sub
    p = np.concatenate([p, np.repeat(p[-1:], n_pad - len(p), 0)])
    ti = np.floor((p[:, 0] - x0) / ts).astype(int).reshape(-1, sub)
    tj = np.floor((p[:, 1] - y0) / ts).astype(int).reshape(-1, sub)
    lo_i, hi_i = ti.min(1), ti.max(1)
    lo_j, hi_j = tj.min(1), tj.max(1)
    sx, sy = hi_i - lo_i, hi_j - lo_j
    ok = (lo_i >= 0) & (lo_j >= 0) & (hi_i < nx) & (hi_j < ny)
    t = np.clip(lo_j * nx + lo_i, 0, nx * ny - 1)

    def pick(use_rect):
        ng = np.full(len(t), full_ng)
        sel8 = ok & (sx <= 7) & (sy <= 7)
        ng[sel8] = g8[t[sel8]]
        sel4 = ok & (sx <= 3) & (sy <= 3)
        ng[sel4] = g4[t[sel4]]
        sel2 = ok & (sx <= 1) & (sy <= 1)
        ng[sel2] = g2[t[sel2]]
        if use_rect:
            s21 = ok & (sx <= 1) & (sy == 0)
            ng[s21] = g21[t[s21]]
            s12 = ok & (sx == 0) & (sy <= 1)
            ng[s12] = g12[t[s12]]
        sel1 = ok & (sx == 0) & (sy == 0)
        ng[sel1] = g1[t[sel1]]
        return ng

    return dict(ts=ts, sub=sub, grid=[nx, ny], subgroups=len(t),
                square=float(pick(False).mean()),
                rect=float(pick(True).mean()))


def run(ts: float = 0.85, envs: int = 4096, sub: int = SUB,
        device="cpu") -> dict:
    """``estimate`` on example_map with the bench sampler's poses
    (generator seed 7, the corridor of the start pose)."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.maps import map_path

    md = P.load_map(map_path("example_map"), extract_segments=True,
                    device=device)
    sampler = P.uniform_pose_sampler(md, clearance=0.6,
                                     component_seed=common.EXAMPLE_SEED_XY,
                                     grouped=True, align_theta=True)
    poses = sampler(P.make_generator(md.device, 7), (envs, 2))
    return estimate(md, poses.cpu().numpy(), ts, sub)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sub", type=int, default=SUB)
    common.device_arg(ap, default="cpu")
    args = ap.parse_args(argv)
    r = run(float(os.environ.get("BENCH_CULL_TS", 0.85)),
            int(os.environ.get("BENCH_ENVS", 4096)), args.sub, args.device)
    print(f"ts={r['ts']} SUB={r['sub']} grid={r['grid'][0]}x{r['grid'][1]} "
          f"subgroups={r['subgroups']}")
    print(f"square tiers : mean ng = {r['square']:.2f}")
    print(f"+2x1/1x2     : mean ng = {r['rect']:.2f}")
    print(json.dumps(r), flush=True)
    return r


if __name__ == "__main__":
    main()
