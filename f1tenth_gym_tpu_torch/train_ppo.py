"""Train a PPO driving policy on a bundled track, on one device.

Port of ``examples/train_ppo.py``, with the same flags and defaults: E
envs of one agent step in lockstep inside each PPO iteration, the LiDAR
sweep running as the hand-written kernel on the card (engine "pallas",
the port's "kernel").

    python -m f1tenth_gym_tpu_torch.train_ppo --envs 1024 --iters 50

``--save`` writes the policy's parameters in the layout of the JAX
package's ``save_pytree(path, ts.net_params)``; ``--restore`` reads such a
file, written by either package. ``--device cpu`` runs on the CPU.
"""

import argparse
import time

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.maps import map_path
from f1tenth_gym_tpu_torch.parallel.ppo import PPO, PPOConfig
from f1tenth_gym_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from f1tenth_gym_tpu_torch.utils.convert import (
    actor_critic_from_flax,
    actor_critic_to_numpy,
)
from f1tenth_gym_tpu_torch.utils.metrics import MetricsLogger


def make_learner(map_name: str = "compact", envs: int = 1024,
                 beams: int = 1080, engine: str = "pallas", device=None):
    """The learner ``main`` trains: ``envs`` one-agent envs on the bundled
    map ``map_name`` in float32 with scan noise, start poses from the
    free-space sampler (clearance 0.8 m, generator seed 1), the reset's
    scan noise from seed 0, the net from seed 2, ``PPOConfig(
    rollout_steps=32, obs_beams=64)``; the steps' scan noise comes from
    the learner's own env generator. Returns (ppo, ts)."""
    dev = resolve_device(device)
    cfg = P.SimConfig(num_agents=1, num_beams=beams, dtype="float32",
                      scan_engine=engine)
    params = P.VehicleParams.create(device=dev)
    tables = P.make_scan_tables(num_beams=beams, device=dev)
    m = P.load_map(map_path(map_name), ".png",
                   extract_segments=cfg.scan_engine in ("segments", "kernel"),
                   tile_culling=cfg.scan_engine == "kernel", device=dev)

    sampler = P.uniform_pose_sampler(m, clearance=0.8)
    poses = sampler(P.make_generator(dev, 1), (envs, 1))
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               generator=P.make_generator(dev, 0), device=dev)

    ppo = PPO(params, m, tables, cfg, 0.01,
              PPOConfig(rollout_steps=32, obs_beams=64), device=dev)
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

    ppo, ts = make_learner(args.map, args.envs, args.beams, args.engine,
                           args.device)
    if args.restore:
        flax_params = load_pytree(args.restore,
                                  target=actor_critic_to_numpy(ts.net))
        ts.net.load_state_dict(
            actor_critic_from_flax(flax_params, device=ppo.device).state_dict())
        print(f"restored policy from {args.restore}")

    logger = MetricsLogger(args.metrics_out) if args.metrics_out else None

    steps_per_iter = args.envs * ppo.pc.rollout_steps
    for it in range(args.iters):
        t0 = time.time()
        ts, metrics = ppo.train_step(ts)
        loss = float(metrics["loss"])
        dt = time.time() - t0
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
        path = save_pytree(args.save, actor_critic_to_numpy(ts.net))
        print(f"saved policy to {path}")


if __name__ == "__main__":
    main()
