"""Massive vectorized rollout: thousands of racing envs on one card.

Port of ``examples/massive_rollout.py``: E envs of racing cars step in
lockstep with full LiDAR and auto-reset to each env's start grid, start
poses from the grouped, corridor-aligned sampler, and the batch re-sorted
for locality every 32 steps.

    python -m f1tenth_gym_tpu_torch.examples.massive_rollout --envs 4096 --steps 512

The flags are the JAX example's, plus ``--device`` (default: the card)
and ``--beams`` (default 1080, the JAX example's fixed count).
"""

from __future__ import annotations

import argparse
import time

import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.maps import map_path

SORT_PERIOD = 32


def policy(scans: torch.Tensor) -> torch.Tensor:
    """Steer toward the more open side at 3 m/s. (..., B) -> (..., 2)."""
    B = scans.shape[-1]
    left = scans[..., : B // 2].mean(-1)
    right = scans[..., B // 2:].mean(-1)
    steer = torch.clamp(0.25 * (right - left) / 30.0, -0.4, 0.4)
    return torch.stack([steer, torch.full_like(steer, 3.0)], -1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", default="twisty")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--engine", default="pallas")
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = P.SimConfig(num_agents=args.agents, num_beams=args.beams,
                      dtype="float32", scan_engine=args.engine)
    params = P.VehicleParams.create(device=dev)
    tables = P.make_scan_tables(num_beams=args.beams, device=dev)
    m = P.load_map(map_path(args.map), ".png", extract_segments=True,
                   tile_culling=(cfg.scan_engine == "kernel"), device=dev)

    # racing spawn: adjacent start-grid groups facing down the corridor
    sampler = P.uniform_pose_sampler(m, clearance=0.8, grouped=True,
                                     align_theta=True)
    poses = sampler(P.make_generator(dev, 7), (args.envs, args.agents))
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               generator=P.make_generator(dev, 0), device=dev)
    astep = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                  reset_to_start=True, device=dev)

    def policy_step(s):
        return astep(s, policy(s.scans))[0]

    s = policy_step(states)
    s = P.sort_envs_for_locality(s)   # keep kernel subgroups tile-local
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    for i in range(args.steps):
        if i % SORT_PERIOD == 0:
            s = P.sort_envs_for_locality(s)
        s = policy_step(s)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    rate = args.envs * args.steps / dt
    print(f"{args.envs} envs x {args.steps} steps in {dt:.2f}s "
          f"-> {rate:,.0f} env-steps/s "
          f"({rate/100:,.0f}x realtime at the 100 Hz physics rate)")
    return dict(seconds=dt, env_steps_per_s=rate,
                poses_finite=bool(torch.isfinite(s.x).all()))


if __name__ == "__main__":
    main()
