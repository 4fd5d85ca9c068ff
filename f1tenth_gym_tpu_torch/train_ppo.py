"""Train a PPO driving policy on a bundled track, over a mesh of ranks.

Port of ``examples/train_ppo.py``, with the same flags and defaults: E
envs of one agent step in lockstep inside each PPO iteration, the LiDAR
sweep running as the hand-written kernel on the card (engine "pallas",
the port's "kernel"). As there, the learner always goes through
``PPO(mesh=make_mesh())``:

    python -m f1tenth_gym_tpu_torch.train_ppo --envs 1024 --iters 50
    torchrun --nproc_per_node N -m f1tenth_gym_tpu_torch.train_ppo

A plain ``python`` run is world size 1 and equals the learner without a
mesh bit for bit; under ``torchrun`` the ``--envs`` split over the N ranks
(each on its own card, NCCL; or gloo on the CPU with ``--device cpu``).
Rank 0 prints and saves.

``--save`` writes the policy's parameters in the layout of the JAX
package's ``save_pytree(path, ts.net_params)``; ``--restore`` reads such a
file, written by either package. ``--device cpu`` runs on the CPU.
"""

import argparse
import time

import torch.distributed as dist

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.maps import map_path
from f1tenth_gym_tpu_torch.parallel import multihost
from f1tenth_gym_tpu_torch.parallel.ppo import PPO, PPOConfig
from f1tenth_gym_tpu_torch.parallel.sharding import (
    env_shard,
    local_device,
    make_mesh,
    shard_env_pytree,
)
from f1tenth_gym_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from f1tenth_gym_tpu_torch.utils.convert import (
    actor_critic_from_flax,
    actor_critic_to_numpy,
)
from f1tenth_gym_tpu_torch.utils.metrics import MetricsLogger


def make_learner(map_name: str = "compact", envs: int = 1024,
                 beams: int = 1080, engine: str = "pallas", device=None,
                 mesh=None, scan_noise: bool = True):
    """The learner ``main`` trains: ``envs`` one-agent envs on the bundled
    map ``map_name`` in float32, with scan noise unless ``scan_noise`` is
    False, start poses from the free-space sampler (clearance 0.8 m,
    generator seed 1), the reset's scan noise from seed 0, the net from
    seed 2, ``PPOConfig(rollout_steps=32, obs_beams=64)``; the steps' scan
    noise comes from the learner's own env generator. Returns (ppo, ts).

    Under ``mesh`` every rank draws the global poses, resets its own rows
    (``shard_env_pytree``; the reset's noise from seed 0 plus the rank's 'env'
    index) and learns with ``PPO(mesh=mesh)``; ``device`` is then the
    rank's."""
    dev = local_device(mesh) if mesh is not None else resolve_device(device)
    cfg = P.SimConfig(num_agents=1, num_beams=beams, dtype="float32",
                      scan_engine=engine, scan_noise=scan_noise)
    params = P.VehicleParams.create(device=dev)
    tables = P.make_scan_tables(num_beams=beams, device=dev)
    m = P.load_map(map_path(map_name), ".png",
                   extract_segments=cfg.scan_engine in ("segments", "kernel"),
                   tile_culling=cfg.scan_engine == "kernel", device=dev)

    sampler = P.uniform_pose_sampler(m, clearance=0.8)
    poses = sampler(P.make_generator(dev, 1), (envs, 1))
    index, _ = env_shard(mesh)
    if mesh is not None:
        poses = shard_env_pytree(poses, mesh)
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               generator=P.make_generator(dev, index),
                               device=dev)

    ppo = PPO(params, m, tables, cfg, 0.01,
              PPOConfig(rollout_steps=32, obs_beams=64), device=dev,
              mesh=mesh)
    return ppo, ppo.init(states, P.make_generator(dev, 2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", default="compact")
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--engine", default="pallas")
    ap.add_argument("--save", default="", help="save policy params to this path")
    ap.add_argument("--restore", default="", help="resume policy params from this path")
    ap.add_argument("--metrics-out", default="",
                    help="append per-iteration metrics to this JSONL file")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    had_group = dist.is_initialized()
    multihost.initialize(devices=args.device)
    mesh = make_mesh(devices=args.device)
    try:
        _train(args, mesh)
    finally:
        if not had_group:   # the group this call started, local or not
            dist.destroy_process_group()


def _train(args, mesh):
    lead = dist.get_rank() == 0
    ppo, ts = make_learner(args.map, args.envs, args.beams, args.engine,
                           mesh=mesh)
    if args.restore:
        flax_params = load_pytree(args.restore,
                                  target=actor_critic_to_numpy(ts.net))
        ts.net.load_state_dict(actor_critic_from_flax(
            flax_params, device=ppo.device, mesh=mesh).state_dict())
        if lead:
            print(f"restored policy from {args.restore}")

    logger = (MetricsLogger(args.metrics_out)
              if args.metrics_out and lead else None)

    steps_per_iter = args.envs * ppo.pc.rollout_steps
    for it in range(args.iters):
        t0 = time.time()
        ts, metrics = ppo.train_step(ts)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if lead:
            print(f"iter {it:4d}  loss {loss:9.4f}  "
                  f"reward {float(metrics['mean_reward']):8.4f}  "
                  f"{steps_per_iter/dt:,.0f} env-steps/s", flush=True)
        if logger is not None:
            logger.log(iter=it, loss=loss,
                       mean_reward=float(metrics["mean_reward"]),
                       crash_rate=float(metrics["crash_rate"]),
                       env_steps_per_sec=steps_per_iter / dt)
    if logger is not None:
        logger.close()

    if args.save:
        net_params = actor_critic_to_numpy(ts.net)  # every rank gathers
        if lead:
            path = save_pytree(args.save, net_params)
            print(f"saved policy to {path}")


if __name__ == "__main__":
    main()
