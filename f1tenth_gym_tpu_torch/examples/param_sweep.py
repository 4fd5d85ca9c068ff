"""Vectorized controller/vehicle parameter sweep: the reference's
experiment-yaml use case (config_example_map.yaml: mass/lf/tlad/vgain
bounds, budget) run as one batched rollout.

Port of ``examples/param_sweep.py``. Every candidate is an env of the
batch, with its own vehicle mass and lf (per-env ``VehicleParams`` leaves
of shape (E, 1), what ``vmap`` over params gives in the JAX package) and
its own pure-pursuit gains; the fitness is the simulated 2-lap race time
from the env's lap bookkeeping. The steps run in chunks of 512 (the last
one shorter where ``--steps`` is no multiple of 512; the JAX example runs
it whole).

    python -m f1tenth_gym_tpu_torch.examples.param_sweep            # uses the yaml
    python -m f1tenth_gym_tpu_torch.examples.param_sweep --budget 2048 --steps 6000

The flags are the JAX example's, with ``--device`` (default: the card) in
place of ``--platform``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.core.env import env_step, init_state
from f1tenth_gym_tpu_torch.planning.pure_pursuit import pure_pursuit_plan
from f1tenth_gym_tpu_torch.utils.experiment import (
    load_config_waypoints,
    load_experiment_config,
    resolve_path,
    start_pose,
)

CHUNK = 512
WHEELBASE = 0.17145 + 0.15875  # reference waypoint_follow.py:252
DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "examples", "config_example_map.yaml")


def per_env_params(base: P.VehicleParams, E: int, **leaves) -> P.VehicleParams:
    """``base`` with every leaf an (E, 1) tensor, ``leaves`` (name -> (E,)
    values) replacing theirs."""
    out = {}
    for k, v in vars(base).items():
        v = leaves.get(k, v)
        out[k] = torch.as_tensor(v, dtype=base.m.dtype,
                                 device=base.m.device).expand(E).reshape(E, 1)
    return P.VehicleParams(**out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=DEFAULT_CONFIG)
    ap.add_argument("--budget", type=int, default=0,
                    help="candidate count (default: the yaml's budget)")
    ap.add_argument("--steps", type=int, default=6000,
                    help="sim steps per candidate (60 s at 100 Hz)")
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    conf = load_experiment_config(args.config)
    E = args.budget or int(getattr(conf, "budget", 1000))
    wpts = torch.as_tensor(load_config_waypoints(conf), dtype=torch.float32,
                           device=dev)
    m = P.load_map(resolve_path(conf, conf.map_path),
                   getattr(conf, "map_ext", ".png"), extract_segments=True,
                   tile_culling=True, device=dev)
    cfg = P.SimConfig(num_agents=1, num_beams=args.beams, dtype="float32",
                      scan_engine="pallas")
    tables = P.make_scan_tables(num_beams=args.beams, device=dev)

    # candidate parameters, uniform in the yaml's bounds
    rng = np.random.default_rng(int(getattr(conf, "seed", 12345)))
    mass = rng.uniform(conf.mass_min, conf.mass_max, E)
    lf = rng.uniform(conf.lf_min, conf.lf_max, E)
    tlad = rng.uniform(conf.tlad_min, conf.tlad_max, E)
    vgain = rng.uniform(conf.vgain_min, conf.vgain_max, E)

    params = per_env_params(P.VehicleParams.create(device=dev), E,
                            m=mass, lf=lf)
    tlad_e = torch.as_tensor(tlad, dtype=torch.float32, device=dev)[:, None]
    vgain_e = torch.as_tensor(vgain, dtype=torch.float32, device=dev)[:, None]

    sp = np.repeat(start_pose(conf)[None], E, axis=0)  # (E, 1, 3)
    states = init_state(torch.as_tensor(sp, dtype=torch.float32, device=dev),
                        cfg)
    gen = P.make_generator(dev, 0)
    timestep = torch.as_tensor(0.01, dtype=torch.float32, device=dev)

    def step(states):
        x = states.x
        speed, steer = pure_pursuit_plan(x[..., 0], x[..., 1], x[..., 4],
                                         wpts, tlad_e, vgain_e, WHEELBASE)
        return env_step(states, torch.stack([steer, speed], -1), params, m,
                        tables, cfg, timestep, gen)[0]

    def sweep_chunk(states, finish_t, crashed, t0: int, n: int):
        # the sim time after each step of the chunk, in float32
        times = torch.arange(t0 + 1, t0 + n + 1, dtype=torch.float32,
                             device=dev) * 0.01
        for i in range(n):
            states = step(states)
            t = times[i]
            crash_now = states.collisions[:, 0] > 0
            lap2 = states.toggle_list[:, 0] >= 4
            unfinished = finish_t == float("inf")
            finish_t = torch.where(lap2 & ~crashed & unfinished, t, finish_t)
            crashed = crashed | (crash_now & (finish_t == float("inf")))
        return states, finish_t, crashed

    finish_t = torch.full((E,), float("inf"), dtype=torch.float32, device=dev)
    crashed = torch.zeros((E,), dtype=torch.bool, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    for c in range(0, args.steps, CHUNK):
        states, finish_t, crashed = sweep_chunk(
            states, finish_t, crashed, c, min(CHUNK, args.steps - c))
    finish = finish_t.cpu().numpy()
    crash = crashed.cpu().numpy()
    wall = time.time() - t0

    total_steps = E * args.steps
    ok = np.isfinite(finish) & ~crash
    print(f"# {E} candidates x {args.steps} steps "
          f"({total_steps:,} env-steps) in {wall:.1f}s wall "
          f"= {total_steps/wall:,.0f} env-steps/s; "
          f"{ok.sum()} finished 2 laps, {crash.sum()} crashed")
    order = np.argsort(np.where(ok, finish, np.inf))
    print("# best 5 (2-lap time | mass lf tlad vgain):")
    for i in order[:5]:
        print(f"  {finish[i]:6.2f}s | mass={mass[i]:.3f} lf={lf[i]:.4f} "
              f"tlad={tlad[i]:.3f} vgain={vgain[i]:.3f}")
    if ok.any():
        b = order[0]
        print(f"best: {finish[b]:.2f}s sim 2-lap time "
              f"(the reference runs these {E} evaluations sequentially)")
    return dict(candidates=E, steps=args.steps,
                seconds=wall, env_steps_per_s=total_steps / wall,
                finished=int(ok.sum()), crashed=int(crash.sum()),
                poses_finite=bool(torch.isfinite(states.x).all()),
                states=states)


if __name__ == "__main__":
    main()
