"""The traffic generator: start poses, seeds and the driving policy.

One general generator for every traffic mix of the benchmark. A mix is a
data file under ``benchmark/traffic/`` (``envs``, ``policy``, the check's
sample sizes, the traced steps); a configuration says how its cars spawn
(``pose_sampler``). Everything random comes from ``--seed`` through
``seeds``: the same seed gives the same poses, scan noise and check
sample.

The samplers are frozen copies of the f1tenth_gym_tpu_torch samplers the
port's examples spawn with (``parallel/vector.py::uniform_pose_sampler``,
``tracks/multi.py::multi_track_pose_sampler``), and the policy is the
gap follower of the port's bench (``bench.py::gap_follow``), kept here so
that the traffic does not move when the program does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def seeds(seed: int, n: int = 4):
    """``n`` independent 32-bit seeds drawn from ``seed`` (any size):
    [poses, scan noise, check sample, ...]."""
    return [int(v) for v in np.random.SeedSequence(int(seed)).generate_state(n)]


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def gap_follow(scans: torch.Tensor) -> torch.Tensor:
    """Steer to the farthest beam of the middle fifth, speed from the
    nearest one there: (..., B) scans -> (..., 2) [steer, speed]."""
    B = scans.shape[-1]
    lo, hi = 2 * B // 5, 3 * B // 5
    best = torch.argmax(scans[..., lo:hi], -1) + lo
    angle = (best.to(scans.dtype) / (B - 1) - 0.5) * 4.7
    steer = torch.clamp(0.6 * angle, -0.4, 0.4)
    speed = torch.clamp(0.8 * scans[..., lo:hi].amin(-1), 1.0, 4.0)
    return torch.stack([steer, speed], -1)


POLICIES = {"gap_follow": gap_follow}
MAX_CANDIDATES = 65536   # start cells kept, a fixed subsample of the free ones
DTYPE = torch.float32


def uniform_sampler(free: np.ndarray, resolution: float, origin, device,
                    clearance: float = 0.6, component_seed=None,
                    grouped: bool = False, align_theta: bool = False):
    """``sample(generator, (E, A)) -> (E, A, 3)`` poses on the free cells
    of ``free`` (H, W) farther than ``clearance`` m from a wall; with
    ``component_seed`` only on that point's free component; ``grouped``
    puts an env's agents on a 16-slot start grid around agent 0; with
    ``grouped`` or ``align_theta`` the cars face along the corridor."""
    from scipy import ndimage

    dt = resolution * ndimage.distance_transform_edt(free)
    res = float(resolution)
    ox, oy, oth = (float(v) for v in origin)
    orig_c, orig_s = np.cos(oth), np.sin(oth)
    ok = dt > clearance
    if component_seed is not None:
        sx, sy = component_seed
        mx = (sx - ox) * orig_c + (sy - oy) * orig_s
        my = -(sx - ox) * orig_s + (sy - oy) * orig_c
        r0, c0 = int(my / res), int(mx / res)
        labels, _ = ndimage.label(ok)
        if (not (0 <= r0 < ok.shape[0] and 0 <= c0 < ok.shape[1])
                or not ok[r0, c0]):
            raise ValueError(f"component_seed {component_seed} is not free")
        ok = labels == labels[r0, c0]
    rows, cols = np.nonzero(ok)
    if len(rows) > MAX_CANDIDATES:
        sel = np.random.default_rng(0).choice(len(rows), MAX_CANDIDATES,
                                              replace=False)
        rows, cols = rows[sel], cols[sel]
    xs_m, ys_m = (cols + 0.5) * res, (rows + 0.5) * res
    xs_w = xs_m * orig_c - ys_m * orig_s + ox
    ys_w = xs_m * orig_s + ys_m * orig_c + oy
    tangents = None
    if align_theta or grouped:
        gy, gx = np.gradient(dt)
        gxc, gyc = gx[rows, cols], gy[rows, cols]
        # the distance field's gradient turned by -90 degrees
        tangents = np.arctan2(gxc * orig_c - gyc * orig_s,
                              -(gxc * orig_s + gyc * orig_c))
    slot_xy = slot_counts = None
    if grouped:
        k_off = np.array([1, -1] * 4 + [2, -2] * 4, np.float64)
        rot = np.array([0.0, 0.0, 0.25, 0.25, 0.5, 0.5, 0.75, 0.75] * 2,
                       np.float64) * np.pi
        ang = tangents[:, None] + rot[None, :]
        dxw = 0.9 * k_off[None, :] * np.cos(ang)
        dyw = 0.9 * k_off[None, :] * np.sin(ang)
        dxm = dxw * orig_c + dyw * orig_s
        dym = -dxw * orig_s + dyw * orig_c
        pc = (cols + 0.5)[:, None] + dxm / res
        pr = (rows + 0.5)[:, None] + dym / res
        inb = (pr >= 0) & (pr < dt.shape[0]) & (pc >= 0) & (pc < dt.shape[1])
        rr = np.clip(pr.astype(np.int64), 0, dt.shape[0] - 1)
        cc = np.clip(pc.astype(np.int64), 0, dt.shape[1] - 1)
        valid = inb & ok[rr, cc]
        counts = valid.sum(1)
        order = np.argsort(~valid, axis=1, kind="stable")
        sx = xs_w[:, None] + np.take_along_axis(dxw, order, 1)
        sy = ys_w[:, None] + np.take_along_axis(dyw, order, 1)
        none = counts == 0
        sx[none] = xs_w[none, None]
        sy[none] = ys_w[none, None]
        slot_xy = torch.as_tensor(np.stack([sx, sy], -1), dtype=DTYPE,
                                  device=device)
        slot_counts = torch.as_tensor(counts, dtype=torch.int64, device=device)
    cand = torch.as_tensor(np.stack([xs_w, ys_w], 1), dtype=DTYPE,
                           device=device)
    if tangents is not None:
        tangents = torch.as_tensor(tangents, dtype=DTYPE, device=device)

    def sample(gen: torch.Generator, shape: Tuple[int, int]):
        E, A = shape
        n = E * A
        idx = torch.randint(0, cand.shape[0], (n,), generator=gen,
                            device=device)
        group = grouped and A > 1
        xy = cand[idx]
        if group:
            idx = idx.view(E, A)
            cnt = slot_counts[idx[:, 0]]
            max_shift = torch.clamp(torch.clamp(cnt, max=8) - (A - 2), min=1)
            shift = torch.randint(0, 1 << 30, (E,), generator=gen,
                                  device=device) % max_shift
            slots = ((shift[:, None] + torch.arange(A - 1, device=device))
                     % torch.clamp(cnt, min=1)[:, None])
            xy = xy.view(E, A, 2).clone()
            xy[:, 1:] = slot_xy[idx[:, :1], slots]
            xy = xy.view(n, 2)
            idx = idx.reshape(-1)
        if align_theta:
            u = torch.rand((2, n), generator=gen, dtype=DTYPE, device=device)
            theta = tangents[idx] + torch.where(u[0] < 0.5, np.pi, 0.0) \
                + (u[1] * 0.6 - 0.3)
            if group:
                theta = theta.view(E, A)[:, :1].expand(E, A).reshape(-1)
            theta = torch.remainder(theta, 2.0 * np.pi)[:, None]
        else:
            theta = torch.rand((n, 1), generator=gen, dtype=DTYPE,
                               device=device) * (2.0 * np.pi)
        return torch.cat([xy, theta], 1).view(E, A, 3)

    return sample


def track_sampler(waypoints, device, agent_gap: float = 1.5,
                  theta_jitter: float = 0.15):
    """``sample(generator, (E, A))`` over a world of tracks, ``waypoints``
    a list of (N, >=2) racing lines in the world frame: env e races on
    track e * M // E; agent j starts ``agent_gap`` m behind agent 0 along
    the line, facing along it, with a uniform heading jitter."""
    M = len(waypoints)
    n_wp = min(len(w) for w in waypoints)
    wp = torch.as_tensor(np.stack([np.asarray(w)[:n_wp, :2]
                                   for w in waypoints]),
                         dtype=DTYPE, device=device)
    seglen = np.stack([np.linalg.norm(np.diff(np.asarray(w)[:n_wp, :2],
                                              axis=0), axis=1).mean()
                       for w in waypoints])
    back = torch.as_tensor(
        np.maximum(1, np.round(agent_gap / seglen).astype(np.int64)),
        device=device)

    def sample(gen: torch.Generator, shape: Tuple[int, int]):
        E, A = shape
        idx0 = torch.randint(0, n_wp, (E,), generator=gen, device=device)
        jitter = (torch.rand((E, A), generator=gen, dtype=DTYPE,
                             device=device) * (2 * theta_jitter)
                  - theta_jitter)
        track = (torch.arange(E, device=device) * M) // E
        offs = torch.arange(A, device=device) * back[track][:, None]
        idx = torch.remainder(idx0[:, None] - offs, n_wp)
        p = wp[track[:, None], idx]
        q = wp[track[:, None], torch.remainder(idx + 1, n_wp)]
        theta = torch.atan2(q[..., 1] - p[..., 1], q[..., 0] - p[..., 0])
        theta = torch.remainder(theta + jitter, 2 * np.pi)
        return torch.cat([p, theta[..., None]], -1)

    return sample
