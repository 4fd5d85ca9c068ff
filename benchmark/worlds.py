"""The system under test, built from a configuration through the port's
public API: its map or world, its vehicle and LiDAR, its auto-reset step
and its locality sort; beside them what the benchmark's traffic and
reference need of the world (its free cells, its frame, its racing lines).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch

from benchmark import generator
from benchmark.reference import png


@dataclasses.dataclass
class World:
    map_data: object        # the port's MapData
    free: np.ndarray        # (H, W) bool free cells, row 0 at the bottom
    resolution: float
    origin: tuple           # (x, y, theta) of the raster's corner
    sampler: Callable       # sample(generator, (E, A)) -> (E, A, 3)
    sort: Callable          # the port's locality sort, states -> states


def build(cfg: dict, device) -> World:
    """The configuration's world on ``device``."""
    import f1tenth_gym_tpu_torch as P

    w = cfg["world"]
    ps = dict(cfg["pose_sampler"])
    kind = ps.pop("kind")
    if w["kind"] == "map":
        ts = cfg.get("culling_tile_size")
        m = P.load_map(os.path.join(cfg["_dir"], w["yaml"]),
                       extract_segments=True,
                       simplify_tol_cells=cfg["simplify_tol_cells"],
                       tile_culling=ts is not None, max_range=cfg["max_range"],
                       culling_tile_size=ts or 2.5, device=device)
        free = png.free_space(os.path.join(cfg["_dir"], w["image"]))
        res, origin = float(w["resolution"]), tuple(w["origin"])
        tm = m.tile_meta_host
        grid = dict(tile_size=1.0 / tm[2], origin=(tm[0], tm[1])) if tm \
            else {}

        def sort(s):
            return P.sort_envs_for_locality(s, **grid)
    elif w["kind"] == "tracks":
        from f1tenth_gym_tpu_torch.tracks.multi import (
            multi_track_locality_sort, multi_track_map_data)

        m, infos = multi_track_map_data(
            w["tracks"], seed=w["track_seed"], track_width=w["track_width"],
            spacing=w["spacing"], resolution=w["resolution"],
            tile_culling=cfg.get("culling_tile_size") is not None,
            culling_neighborhood=w["culling_neighborhood"],
            culling_tile_size=cfg.get("culling_tile_size") or 2.5,
            culling_window_cap=w["culling_window_cap"], device=device)
        # the world's raster as its generator made it: free where the
        # distance to a wall is positive
        free = (m.dt > 0).cpu().numpy()
        res, origin = float(w["resolution"]), (0.0, 0.0, 0.0)
        ps["waypoints"] = [i.waypoints for i in infos]
        sort = multi_track_locality_sort(m, infos)
    else:
        raise ValueError(f"unknown world kind {w['kind']!r}")
    if kind == "uniform":
        sampler = generator.uniform_sampler(free, res, origin, device, **ps)
    elif kind == "tracks":
        sampler = generator.track_sampler(device=device, **ps)
    else:
        raise ValueError(f"unknown pose sampler {kind!r}")
    return World(m, free, res, origin, sampler, sort)


def system(cfg: dict, world: World, device, noise_gen: torch.Generator):
    """The port's racing env of the configuration on the world:
    (sim config, params, tables, auto-reset step)."""
    import f1tenth_gym_tpu_torch as P

    sim = P.SimConfig(num_agents=cfg["num_agents"],
                      num_beams=cfg["num_beams"], theta_dis=cfg["theta_dis"],
                      dtype=cfg["dtype"], scan_engine=cfg["scan_engine"],
                      model=cfg["model"], integrator=cfg["integrator"],
                      scan_noise=True, shared_agent_noise=True)
    params = P.VehicleParams.create(cfg["vehicle_params"], device=device)
    tables = P.make_scan_tables(
        num_beams=cfg["num_beams"], fov=cfg["fov"],
        theta_dis=cfg["theta_dis"], max_range=cfg["max_range"],
        scan_std=cfg["scan_std"], ttc_thresh=cfg["ttc_thresh"],
        lidar_dist=cfg["lidar_dist"], width=cfg["vehicle_params"]["width"],
        lf=cfg["vehicle_params"]["lf"], lr=cfg["vehicle_params"]["lr"],
        device=device)
    step = P.make_autoreset_step(params, world.map_data, tables, sim,
                                 cfg["timestep"], reset_to_start=True,
                                 generator=noise_gen, device=device)
    return sim, params, tables, step
