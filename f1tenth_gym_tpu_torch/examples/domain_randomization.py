"""Track domain randomization: one batch of envs racing many tracks.

Port of ``examples/domain_randomization.py``. M generated tracks compose
into one world map (``tracks/multi.py``); envs are assigned to tracks in
contiguous blocks of the batch and start on a start grid on their track's
racing line; each step sweeps every scan with the scan kernel on the
world's culling pack, and the batch is re-sorted by arc position every 32
steps so that a kernel subgroup stays in one culling window (each track's
corridor is certified on its own: see ``tracks/multi.py``). ``--train``
sorts the same way once an iteration, before each 32-step rollout.

    python -m f1tenth_gym_tpu_torch.examples.domain_randomization             # rollout
    python -m f1tenth_gym_tpu_torch.examples.domain_randomization --train --iters 40

The flags are the JAX example's, with ``--device`` (default: the card) in
place of ``--platform``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, List

import numpy as np
import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.config import SimConfig, resolve_device
from f1tenth_gym_tpu_torch.state import MapData, ScanTables, SimState
from f1tenth_gym_tpu_torch.tracks.multi import (
    TrackInfo,
    multi_track_locality_sort,
    multi_track_map_data,
    multi_track_pose_sampler,
)

SORT_PERIOD = 32


@dataclasses.dataclass
class World:
    """What the rollout and the learner run on."""

    map_data: MapData
    infos: List[TrackInfo]
    cfg: SimConfig
    params: P.VehicleParams
    tables: ScanTables
    states: SimState          # the reset batch
    step: Callable            # make_autoreset_step(reset_to_start=True)
    sort: Callable            # multi_track_locality_sort
    build_seconds: float


def make_world(tracks: int = 16, envs: int = 4096, agents: int = 2,
               beams: int = 1080, seed: int = 0, device=None) -> World:
    """The example's world: ``tracks`` generated tracks from ``seed``
    (culled pack at 2.5 m tiles), float32, engine "pallas", start poses
    from the multi-track sampler (generator seed 7), the reset's scan
    noise from seed 1, auto-reset to each env's start grid."""
    dev = resolve_device(device)
    t0 = time.time()
    m, infos = multi_track_map_data(tracks, seed=seed, tile_culling=True,
                                    device=dev)
    build_s = time.time() - t0
    cfg = P.SimConfig(num_agents=agents, num_beams=beams, dtype="float32",
                      scan_engine="pallas")
    params = P.VehicleParams.create(device=dev)
    tables = P.make_scan_tables(num_beams=beams, device=dev)
    sampler = multi_track_pose_sampler(infos, device=dev)
    poses = sampler(P.make_generator(dev, 7), (envs, agents))
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               generator=P.make_generator(dev, 1), device=dev)
    step = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                 reset_to_start=True, device=dev)
    return World(m, infos, cfg, params, tables, states, step,
                 multi_track_locality_sort(m, infos), build_s)


def policy(scans: torch.Tensor) -> torch.Tensor:
    """Gap follow: steer to the farthest beam of the middle fifth, speed
    from the nearest one there. (..., B) -> (..., 2)."""
    B = scans.shape[-1]
    lo, hi = 2 * B // 5, 3 * B // 5
    best = torch.argmax(scans[..., lo:hi], -1) + lo
    ang = (best.to(scans.dtype) / (B - 1) - 0.5) * 4.7
    steer = torch.clamp(0.6 * ang, -0.4, 0.4)
    speed = torch.clamp(0.8 * scans[..., lo:hi].amin(-1), 1.0, 4.0)
    return torch.stack([steer, speed], -1)


def drive(world: World, s: SimState, steps: int):
    """``steps`` policy steps from ``s``, re-sorting the batch before
    every SORT_PERIOD-th. Returns (states, dones summed over the steps,
    dones of the last step), the counts as 0-d tensors."""
    dones = last = torch.zeros((), dtype=torch.int64, device=s.x.device)
    for i in range(steps):
        if i % SORT_PERIOD == 0:
            s = world.sort(s)
        s, _, _, done, _ = world.step(s, policy(s.scans))
        last = done.sum()
        dones = dones + last
    return s, dones, last


def progress_per_track(s: SimState, infos: List[TrackInfo]) -> List[float]:
    """Mean distance of agent 0 from its start grid, per track; a track is
    known by the start position (the sort relabels the envs)."""
    px = s.x[:, 0, 0].cpu().numpy()
    py = s.x[:, 0, 1].cpu().numpy()
    sx = s.start_xs[:, 0].cpu().numpy()
    sy = s.start_ys[:, 0].cpu().numpy()
    dist = np.hypot(px - sx, py - sy)
    out = []
    for info in infos:
        x0, y0, x1, y1 = info.bbox
        sel = (sx >= x0) & (sx <= x1) & (sy >= y0) & (sy <= y1)
        out.append(float(dist[sel].mean()) if sel.any() else float("nan"))
    return out


def make_learner(world: World):
    """PPO across all tracks on the world's auto-reset step:
    ``PPOConfig(rollout_steps=32, obs_beams=64)``, the net from generator
    seed 2, the batch re-sorted by ``world.sort`` before every rollout (a
    rollout is one SORT_PERIOD). Returns (ppo, ts)."""
    from f1tenth_gym_tpu_torch.parallel.ppo import PPO, PPOConfig

    dev = world.map_data.device
    ppo = PPO(world.params, world.map_data, world.tables, world.cfg, 0.01,
              PPOConfig(rollout_steps=SORT_PERIOD, obs_beams=64),
              step_fn=world.step, device=dev, sort_fn=world.sort)
    return ppo, ppo.init(world.states, P.make_generator(dev, 2))


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tracks", type=int, default=16)
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="train PPO across all tracks instead of rolling out")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    w = make_world(args.tracks, args.envs, args.agents, args.beams, args.seed,
                   args.device)
    dev = w.map_data.device
    print(f"# composed {args.tracks} tracks into one "
          f"{w.map_data.dt.shape[0]}x{w.map_data.dt.shape[1]} world "
          f"({w.map_data.seg_table.shape[0]} wall segments) in "
          f"{w.build_seconds:.1f}s")

    if args.train:
        ppo, ts = make_learner(w)
        per = args.envs * ppo.pc.rollout_steps
        results = []
        for it in range(args.iters):
            t0 = time.time()
            ts, metrics = ppo.train_step(ts)
            loss, reward = float(metrics["loss"]), float(metrics["mean_reward"])
            rate = per / (time.time() - t0)
            results.append(dict(loss=loss, mean_reward=reward,
                                env_steps_per_s=rate))
            print(f"iter {it:3d}  loss {loss:8.4f}  reward {reward:8.4f}  "
                  f"{rate:,.0f} env-steps/s (x{args.tracks} tracks)",
                  flush=True)
        return dict(iterations=results)

    s, _, _ = drive(w, w.states, 1)
    s = w.sort(s)   # scans of a subgroup must share a culling window
    _sync(dev)
    t0 = time.time()
    s, dones, last = drive(w, s, args.steps)
    _sync(dev)
    dt = time.time() - t0
    rate = args.envs * args.steps / dt
    per_track = progress_per_track(s, w.infos)
    print(f"{args.envs} envs x {args.steps} steps over {args.tracks} tracks "
          f"in {dt:.2f}s -> {rate:,.0f} env-steps/s; dones(last)={int(last)}")
    print("# mean displacement from start grid per track: "
          + " ".join(f"{v:.1f}" for v in per_track))
    return dict(seconds=dt, env_steps_per_s=rate, dones=int(dones),
                dones_last=int(last), progress_per_track=per_track)


if __name__ == "__main__":
    main()
