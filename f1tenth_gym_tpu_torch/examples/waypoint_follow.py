"""Closed-loop pure-pursuit demo (reference: examples/waypoint_follow.py).

Port of ``examples/waypoint_follow.py``: drives one car around a track
with the pure-pursuit planner through the reference-compatible F110Env
API, optionally rendering to a window or to PNG frames.

  python -m f1tenth_gym_tpu_torch.examples.waypoint_follow          # a generated track
  python -m f1tenth_gym_tpu_torch.examples.waypoint_follow --map /path/map --waypoints wp.csv
  python -m f1tenth_gym_tpu_torch.examples.waypoint_follow --render rgb --frames-out frames
  python -m f1tenth_gym_tpu_torch.examples.waypoint_follow --config examples/config_example_map.yaml

With --config the whole experiment (map, start pose, raceline csv and its
column indices, controller gains) comes from one yaml in the reference's
schema. The flags are the JAX example's, with ``--device`` (default: the
card) in place of ``--platform`` and ``--beams`` (default 1080) added;
the generated track and the frames go under the temp directory unless
``--track-dir`` / ``--frames-out`` say otherwise.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from f1tenth_gym_tpu_torch.core.env import env_step
from f1tenth_gym_tpu_torch.envs import F110Env
from f1tenth_gym_tpu_torch.planning import PurePursuitPlanner
from f1tenth_gym_tpu_torch.utils.image_io import write_png
from f1tenth_gym_tpu_torch.utils.waypoints import load_waypoints


def _start_on(wpts: np.ndarray) -> np.ndarray:
    """(1, 3): the first waypoint, facing the second."""
    d = wpts[1, :2] - wpts[0, :2]
    return np.array([[wpts[0, 0], wpts[0, 1], np.arctan2(d[1], d[0])]])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default="",
                   help="experiment yaml (reference config_example_map.yaml "
                        "schema); supplies map, start pose, raceline and "
                        "gains")
    p.add_argument("--map", type=str, default="",
                   help="map yaml path (default: generate a random track)")
    p.add_argument("--map-ext", type=str, default=".png")
    p.add_argument("--waypoints", type=str, default="",
                   help="raceline csv (reference schema)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--render", choices=["none", "human", "rgb"], default="none")
    p.add_argument("--frames-out", type=str, default=os.path.join(
        tempfile.gettempdir(), "f1tenth_frames"))
    p.add_argument("--track-dir", type=str, default=os.path.join(
        tempfile.gettempdir(), "f1tenth_generated_track"),
        help="where the generated track is written")
    p.add_argument("--tlad", type=float, default=0.82461887897713965)
    p.add_argument("--vgain", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--beams", type=int, default=1080)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--fused", action="store_true",
                   help="plan and step in one call per frame from the state "
                        "on the device; the obs comes to the host only on "
                        "render frames")
    args = p.parse_args(argv)

    if args.config:
        from f1tenth_gym_tpu_torch.utils.experiment import (
            load_config_waypoints,
            load_experiment_config,
            resolve_path,
            start_pose,
        )

        conf = load_experiment_config(args.config)
        map_path = resolve_path(conf, conf.map_path)
        args.map_ext = getattr(conf, "map_ext", args.map_ext)
        wpts = load_config_waypoints(conf)
        start = start_pose(conf)
        args.tlad = getattr(conf, "tlad", args.tlad)
        args.vgain = getattr(conf, "vgain", args.vgain)
    elif args.map:
        map_path = args.map
        wpts = load_waypoints(args.waypoints)
        start = _start_on(wpts)
    else:
        from f1tenth_gym_tpu_torch.tracks.trackgen import (
            generate_centerline,
            save_track,
        )

        rng = np.random.default_rng(args.seed)
        center = generate_centerline(rng)
        csv = save_track(args.track_dir, "demo", center, 3.2)
        map_path = os.path.join(args.track_dir, "demo.yaml")
        wpts = load_waypoints(csv)
        start = _start_on(wpts)
        print(f"generated track -> {map_path}")

    env = F110Env(map=map_path, map_ext=args.map_ext, num_agents=1,
                  num_beams=args.beams, timestep=0.01, integrator="rk4",
                  device=args.device)
    planner = PurePursuitPlanner(wpts, device=env.device)

    obs, _, done, _ = env.reset(start)
    if args.render == "rgb":
        os.makedirs(args.frames_out, exist_ok=True)

    def render(i):
        if args.render == "human":
            env.render("human")
        elif args.render == "rgb":
            write_png(os.path.join(args.frames_out, f"f{i:05d}.png"),
                      env.render("rgb_array"))

    lap_time = 0.0
    t0 = time.time()
    if args.fused:
        # one call per frame: plan from the state's pose on the device and
        # step; `done` comes to the host every 20 frames
        plan_step = planner.fused_plan_step(
            lambda s, a: env_step(s, a, env.params, env.map_data, env.tables,
                                  env.cfg, env._timestep, env._generator),
            args.tlad, args.vgain)
        state = env.state
        out = None
        for i in range(args.steps):
            out = plan_step(state)
            state = out[0]
            if args.render != "none" and i % 20 == 0:
                obs = env._finish(out)[0]   # the renderer reads env's obs
                render(i)
            if i % 20 == 19 and bool(out[3][0]):
                break
        obs, _, done, _ = env._finish(out)
        lap_time = env.current_time
    else:
        for i in range(args.steps):
            speed, steer = planner.plan(
                obs["poses_x"][0], obs["poses_y"][0], obs["poses_theta"][0],
                args.tlad, args.vgain,
            )
            obs, r, done, info = env.step(np.array([[steer, speed]]))
            lap_time += r
            if args.render == "human" or (args.render == "rgb"
                                          and i % 20 == 0):
                render(i)
            if done:
                break
    wall = time.time() - t0
    print(
        f"steps={i+1} sim_time={lap_time:.2f}s wall={wall:.2f}s "
        f"laps={obs['lap_counts'].tolist()} collisions={obs['collisions'].tolist()} "
        f"final=({obs['poses_x'][0]:.2f},{obs['poses_y'][0]:.2f})"
    )
    env.close()
    return dict(steps=i + 1, sim_time=lap_time, seconds=wall,
                laps=obs["lap_counts"].tolist(),
                collisions=obs["collisions"].tolist(),
                final=(float(obs["poses_x"][0]), float(obs["poses_y"][0])),
                map=map_path)


if __name__ == "__main__":
    main()
