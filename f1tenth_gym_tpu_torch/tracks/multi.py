"""Multi-track worlds: many generated tracks in one map for domain
randomization.

Port of ``f1tenth_gym_tpu/tracks/multi.py``. M generated tracks are pasted
into a grid of one world raster, so one ``MapData`` (one segment table,
one culling pack) serves them all: each track's closed outer wall occludes
every other track, so a scan inside track k equals the scan on track k's
standalone map. Envs assigned to different tracks then step in one batch.

The pack's windows are local to each track, and its erosion gate (the
eligibility raster) certifies each track's corridor with a certificate of
its own: ``multi_track_map_data`` seeds the culling with every track's
start point, so the scans on a track take their windows and sweep about
that track's walls, not the world's whole table. Here the port parts from
the JAX package on purpose: its gate certifies one free component, the
open space around the tracks, so every scan on a track sweeps the full
table there.

``multi_track_pose_sampler`` spawns each env's agents as a start grid on
its track's racing line; ``multi_track_locality_sort`` orders the env
batch by (track, arc position), so that a kernel subgroup of 8 scans
shares one culling window.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.state import MapData, SimState
from f1tenth_gym_tpu_torch.utils.profiling import annotate


class TrackInfo(NamedTuple):
    """Per-track placement inside a composed multi-track world."""

    index: int
    waypoints: np.ndarray   # (N, 3) [x, y, v] racing line, world frame
    start_pose: np.ndarray  # (3,) first waypoint + tangent heading
    bbox: Tuple[float, float, float, float]  # world-frame x0, y0, x1, y1


def multi_track_map_data(
    n_tracks: int,
    seed: int = 0,
    track_width: float = 3.2,
    spacing: float = 6.0,
    resolution: float = 0.0625,
    dtype=torch.float32,
    extract_segments: bool = True,
    tile_culling: bool = True,
    culling_neighborhood: int = 2,
    culling_tile_size: float = 2.5,
    culling_window_cap: int = 64,
    device=None,
    **gen_kwargs,
):
    """Generate n_tracks random tracks (track k from seed + k) and compose
    them into one MapData on ``device`` (default: the card).

    Returns (map_data, [TrackInfo, ...]). gen_kwargs forward to
    ``trackgen.generate_centerline``. The culling defaults are the JAX
    package's: neighborhood 2 (a track holds few envs, so a subgroup needs
    a wider window than on one dense map) and windows capped at 64 groups
    (every block is padded to the pack's tallest). Each track's start
    point seeds the culling, so each corridor gets its own erosion
    certificate (``ops/culling.py::erosion_refine``).
    """
    from f1tenth_gym_tpu_torch.tracks.trackgen import (
        _curvature,
        generate_centerline,
        rasterize_track,
        speed_profile,
    )
    from f1tenth_gym_tpu_torch.utils.map_loader import make_map_data

    rasters = []
    centers = []
    for k in range(n_tracks):
        rng = np.random.default_rng(seed + k)
        center = generate_centerline(rng, track_width=track_width,
                                     **gen_kwargs)
        bitmap, res, origin = rasterize_track(center, track_width,
                                              resolution=resolution)
        rasters.append((bitmap, origin))
        centers.append(center)

    # uniform grid cells sized for the largest track raster
    cell_h = max(b.shape[0] for b, _ in rasters)
    cell_w = max(b.shape[1] for b, _ in rasters)
    pad = int(round(spacing / resolution))
    cell_h += pad
    cell_w += pad
    g = int(np.ceil(np.sqrt(n_tracks)))
    world = np.full((g * cell_h, g * cell_w), 255.0)

    infos: List[TrackInfo] = []
    for k, ((bitmap, origin), center) in enumerate(zip(rasters, centers)):
        gi, gj = divmod(k, g)
        r0 = gi * cell_h + (cell_h - bitmap.shape[0]) // 2
        c0 = gj * cell_w + (cell_w - bitmap.shape[1]) // 2
        world[r0:r0 + bitmap.shape[0], c0:c0 + bitmap.shape[1]] = np.minimum(
            world[r0:r0 + bitmap.shape[0], c0:c0 + bitmap.shape[1]], bitmap)
        # the track's local origin lands at the paste position (the world
        # origin is (0, 0, 0))
        off = np.array([c0 * resolution - origin[0],
                        r0 * resolution - origin[1]])
        wpts_xy = center + off
        _, kappa, _ = _curvature(center)
        v = speed_profile(kappa)
        wpts = np.concatenate([wpts_xy, v[:, None]], axis=1)
        d0 = wpts_xy[1] - wpts_xy[0]
        start = np.array([wpts_xy[0, 0], wpts_xy[0, 1],
                          np.arctan2(d0[1], d0[0])])
        infos.append(TrackInfo(
            index=k, waypoints=wpts, start_pose=start,
            bbox=(c0 * resolution, r0 * resolution,
                  (c0 + bitmap.shape[1]) * resolution,
                  (r0 + bitmap.shape[0]) * resolution),
        ))

    md = make_map_data(
        world, resolution, (0.0, 0.0, 0.0), dtype=dtype,
        extract_segments=extract_segments, tile_culling=tile_culling,
        culling_neighborhood=culling_neighborhood,
        culling_tile_size=culling_tile_size,
        culling_window_cap=culling_window_cap,
        culling_component_seed=[i.start_pose[:2] for i in infos],
        device=device)
    return md, infos


def multi_track_pose_sampler(infos: List[TrackInfo], agent_gap: float = 1.5,
                             theta_jitter: float = 0.15, device=None,
                             dtype=torch.float32):
    """Start-pose sampler over a multi-track world.

    Env e races on track e * n_tracks // E (contiguous blocks of the batch
    a track, so a kernel subgroup stays on one track). Each env's agents
    spawn as a start grid on the racing line: agent j sits ``agent_gap``
    meters behind agent 0 along the centerline, facing along it, with a
    heading jitter uniform in [-theta_jitter, theta_jitter).

    Returns ``sample(generator, (E, A)) -> (E, A, 3)`` poses in ``dtype``
    on ``device`` (default: the card). ``dtype`` stands for the JAX
    package's x64 switch: float32 there without it, float64 with it.
    ``sample.from_draws(idx0, jitter)`` gives the poses of the draws
    ``idx0`` (E,) (agent 0's waypoint) and ``jitter`` (E, A).
    """
    dev = resolve_device(device)
    n = len(infos)
    n_wp = min(len(i.waypoints) for i in infos)
    wp = torch.as_tensor(np.stack([i.waypoints[:n_wp, :2] for i in infos]),
                         dtype=dtype, device=dev)
    # arc length per waypoint step (uniformly resampled centerlines)
    seglen = np.stack([
        np.linalg.norm(np.diff(i.waypoints[:n_wp, :2], axis=0), axis=1).mean()
        for i in infos])
    back = np.maximum(1, np.round(agent_gap / seglen).astype(np.int32))
    back = torch.as_tensor(back, dtype=torch.int64, device=dev)

    def from_draws(idx0: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
        E, A = jitter.shape
        track = (torch.arange(E, device=dev) * n) // E
        offs = torch.arange(A, device=dev) * back[track][:, None]   # (E, A)
        idx = torch.remainder(idx0.to(dev, torch.int64)[:, None] - offs, n_wp)
        nxt = torch.remainder(idx + 1, n_wp)
        p = wp[track[:, None], idx]                                 # (E, A, 2)
        q = wp[track[:, None], nxt]
        theta = torch.atan2(q[..., 1] - p[..., 1], q[..., 0] - p[..., 0])
        theta = theta + jitter.to(dev, dtype)
        return torch.cat([p, torch.remainder(theta, 2 * np.pi)[..., None]], -1)

    def sample(generator: torch.Generator, shape: Tuple[int, ...]):
        E, A = (tuple(shape) + (1,))[:2]
        idx0 = torch.randint(0, n_wp, (E,), generator=generator, device=dev)
        jitter = (torch.rand((E, A), generator=generator, dtype=dtype,
                             device=dev) * (2 * theta_jitter) - theta_jitter)
        return from_draws(idx0, jitter)

    sample.from_draws = from_draws
    return sample


def multi_track_locality_sort(map_data: MapData, infos: List[TrackInfo]):
    """The locality sort for a multi-track env batch: ``sort(states) ->
    states`` relabels the envs in the order of (track cell, nearest
    centerline waypoint) of agent 0.

    Square spatial blocks (``parallel.vector.sort_envs_for_locality``)
    rarely put 8 scans of a sparse multi-track batch into one culling
    window; arc position along each track does, and since every corridor
    is certified (see the module docstring) the subgroups then take their
    windows. The keys are computed in float32 and the sort is stable, as
    in the JAX package.
    """
    dev = map_data.device
    n = len(infos)
    g = int(np.ceil(np.sqrt(n)))
    res = float(map_data.resolution)
    h, w = map_data.dt.shape
    # the cell sizes as float32 tensors on the device: a division by a
    # Python scalar may become a multiplication by its reciprocal
    cell_w = torch.tensor(w * res / g, dtype=torch.float32, device=dev)
    cell_h = torch.tensor(h * res / g, dtype=torch.float32, device=dev)
    n_wp = min(len(i.waypoints) for i in infos)
    wp = torch.as_tensor(np.stack([i.waypoints[:n_wp, :2] for i in infos]),
                         dtype=torch.float32, device=dev)

    def sort(states: SimState) -> SimState:
        with annotate("vector.sort"):
            x = states.x[:, 0, 0].to(torch.float32)
            y = states.x[:, 0, 1].to(torch.float32)
            cell = torch.clamp(
                (torch.floor(y / cell_h) * g + torch.floor(x / cell_w)).to(
                    torch.int32), 0, n - 1).to(torch.int64)
            d = wp[cell] - torch.stack([x, y], -1)[:, None, :]
            sidx = torch.argmin(d[..., 0] * d[..., 0]
                                + d[..., 1] * d[..., 1], -1)
            order = torch.argsort(cell * (2 ** 20) + sidx, stable=True)
            return states.map(lambda leaf: leaf[order])

    return sort
