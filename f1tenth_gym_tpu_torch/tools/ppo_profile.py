"""Busy share of a PPO iteration, and the collectives' share over ranks.

Port of ``tools/ppo_profile.py``, at its configuration: 512 envs x 2
agents x 108 beams on example_map, engine "segments", ``PPOConfig(
obs_beams=32, hidden=128, rollout_steps=16, epochs=2, minibatches=4)``;
one warm-up iteration, then 3 under ``torch.profiler``. The JAX probe
runs the sharded train step on 8 virtual CPU devices and reports the XLA
collectives' share of device time. This one runs it two ways:

* at world size 1 on ``--device`` (default: the card): the iteration's
  busy share (device time over the profiled wall time) and its top
  kernels;
* with ``--ranks N`` (8 in the JAX probe), as N gloo processes on
  ``--device`` (the CPU, or all on the one card: NCCL refuses two ranks on
  one device), 512 / N envs each under ``PPO(mesh=...)``: the share of
  each rank's profiled op time spent in ``torch.distributed``
  collectives, printed as ``ppo_collective_share_<N>rank_<device>``.

A collective is counted by its process group's work span, the profiler
events named ``gloo:<op>`` or ``nccl:<op>`` (``COLLECTIVE_SPANS``; their
time is the span from enqueue to completion, with no self time); where a
torch build records none, by its dispatcher op ``c10d::<op>``
(``COLLECTIVE_OPS``). A rank's op time is the self time of every other
profiled CPU op plus those spans; the ranks trace CPU activity only. A
profile without a collective raises: a share of 0 would pass for a
measurement.

    python -m f1tenth_gym_tpu_torch.tools.ppo_profile              # world size 1
    python -m f1tenth_gym_tpu_torch.tools.ppo_profile --ranks 8 --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.tools import common

ENVS, BEAMS, ITERS = 512, 108, 3
COLLECTIVE_SPANS = ("gloo:", "nccl:")
COLLECTIVE_OPS = ("c10d::",)


def ppo_config():
    from f1tenth_gym_tpu_torch.parallel.ppo import PPOConfig

    return PPOConfig(obs_beams=32, hidden=128, rollout_steps=16, epochs=2,
                     minibatches=4)


def build_learner(envs: int = ENVS, num_beams: int = BEAMS, device=None,
                  mesh=None):
    """(ppo, ts) at the JAX probe's configuration (module docstring): the
    bench sampler's poses (generator seed 7), the reset's noise from seed
    0 plus the rank's 'env' index, the net from seed 1. Under ``mesh``
    the ranks draw the global poses and each resets its own rows."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.maps import map_path
    from f1tenth_gym_tpu_torch.parallel.ppo import PPO
    from f1tenth_gym_tpu_torch.parallel.sharding import (
        env_shard,
        local_device,
        shard_env_pytree,
    )

    dev = local_device(mesh) if mesh is not None else resolve_device(device)
    cfg = P.SimConfig(num_agents=2, num_beams=num_beams, dtype="float32",
                      scan_engine="segments")
    params = P.VehicleParams.create(device=dev)
    tables = P.make_scan_tables(num_beams=num_beams, device=dev)
    m = P.load_map(map_path("example_map"), extract_segments=True, device=dev)
    sampler = P.uniform_pose_sampler(m, clearance=0.6,
                                     component_seed=common.EXAMPLE_SEED_XY,
                                     grouped=True, align_theta=True)
    poses = sampler(P.make_generator(dev, 7), (envs, 2))
    index, _ = env_shard(mesh)
    if mesh is not None:
        poses = shard_env_pytree(poses, mesh)
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               generator=P.make_generator(dev, index),
                               device=dev)
    ppo = PPO(params, m, tables, cfg, 0.01, ppo_config(), device=dev,
              mesh=mesh)
    return ppo, ppo.init(states, P.make_generator(dev, 1))


def _profile_iterations(ppo, ts, iters: int, device_activity: bool = True):
    dev = ppo.device
    ts, _ = ppo.train_step(ts)   # warm-up
    common.sync(dev)
    box = [ts]

    def one():
        box[0], _ = ppo.train_step(box[0])

    return common.profile(one, iters, dev, device_activity)


def profile_world1(envs: int = ENVS, num_beams: int = BEAMS,
                   iters: int = ITERS, device=None) -> dict:
    """The iteration at world size 1 on ``device``: its busy share and
    time by name (``common.device_time_by_name``), a step of the dict
    being one PPO iteration."""
    dev = resolve_device(device)
    ppo, ts = build_learner(envs, num_beams, dev)
    prof = _profile_iterations(ppo, ts, iters)
    t = common.device_time_by_name(prof, iters)
    return dict(envs=envs, beams=num_beams, iterations=iters,
                device=common.device_name(dev),
                env_steps_per_s=envs * ppo.pc.rollout_steps
                / (t["wall_ms_per_step"] / 1e3), **t)


def collective_share(prof) -> dict:
    """The collectives' share of a rank's profiled op time (module
    docstring): ``share``, ``collective_ms``, ``op_ms`` and ``events``
    ({name: ms}, the events counted)."""
    from torch.autograd import DeviceType

    spans, ops, self_ms = {}, {}, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU:
            continue
        if e.key.startswith(COLLECTIVE_SPANS):
            spans[e.key] = e.cpu_time_total / 1e3
        else:
            if e.key.startswith(COLLECTIVE_OPS):
                ops[e.key] = e.cpu_time_total / 1e3
            self_ms += e.self_cpu_time_total / 1e3
    events = spans or ops
    coll = sum(events.values())
    if coll <= 0:
        raise RuntimeError("no collective in the profile: looked for events "
                           f"named {COLLECTIVE_SPANS + COLLECTIVE_OPS}")
    total = self_ms + (coll if spans else 0.0)
    return dict(share=coll / total, collective_ms=coll, op_ms=total,
                events=events)


def collective_rank(rank, nprocs, port, device_type, envs, num_beams, iters):
    """One of ``nprocs`` gloo ranks: its PPO iterations under the profiler
    and ``collective_share``, as plain numbers (a tensor would cross the
    result queue as a handle that dies with the rank)."""
    from f1tenth_gym_tpu_torch.parallel import multihost

    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=nprocs, process_id=rank,
                         backend="gloo", devices=device_type)
    mesh = multihost.global_mesh(devices=device_type)
    ppo, ts = build_learner(envs, num_beams, mesh=mesh)
    # the share is of CPU op time: the card's kernels are not traced
    prof = _profile_iterations(ppo, ts, iters, device_activity=False)
    r = collective_share(prof)
    return dict(r, device=str(ppo.device), envs=ts.env_states.num_envs,
                events={k: float(v) for k, v in r["events"].items()})


def profile_ranks(nprocs: int = 8, envs: int = ENVS, num_beams: int = BEAMS,
                  iters: int = ITERS, device=None,
                  timeout_s: float = 600.0) -> dict:
    """``nprocs`` gloo ranks on ``device`` (the CPU, or all on the one
    card), ``envs`` split between them: each rank's collective share, and
    their mean under ``metric``."""
    from f1tenth_gym_tpu_torch.parallel.multihost import spawn

    dev = resolve_device(device)
    env = {"CUDA_VISIBLE_DEVICES": ""} if dev.type == "cpu" else None
    outs = spawn(collective_rank, nprocs,
                 (dev.type, envs, num_beams, iters), timeout_s=timeout_s,
                 env=env)
    shares = [o["share"] for o in outs]
    return dict(metric=f"ppo_collective_share_{nprocs}rank_{dev.type}",
                value=float(np.mean(shares)), unit="fraction_of_op_time",
                ranks=nprocs, shares=shares,
                collective_ms=[o["collective_ms"] for o in outs],
                op_ms=[o["op_ms"] for o in outs],
                events=outs[0]["events"], devices=[o["device"] for o in outs],
                iterations=iters)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=0,
                    help="gloo processes (the JAX probe's 8); 0: world size 1")
    ap.add_argument("--envs", type=int, default=ENVS)
    ap.add_argument("--beams", type=int, default=BEAMS)
    ap.add_argument("--iters", type=int, default=ITERS)
    common.device_arg(ap)
    args = ap.parse_args(argv)
    if args.ranks:
        r = profile_ranks(args.ranks, args.envs, args.beams, args.iters,
                          args.device)
        print("| component | share of op time (rank 0) |")
        print("|---|---|")
        print(f"| torch.distributed collectives | {100 * r['shares'][0]:.2f}% |")
        print(f"| everything else | {100 * (1 - r['shares'][0]):.2f}% |")
        print(json.dumps(r), flush=True)
        return r
    r = profile_world1(args.envs, args.beams, args.iters, args.device)
    common.print_top(f"PPO iteration ({r['envs']} envs) on {r['device']}", r)
    print(json.dumps({k: v for k, v in r.items() if k != "by_name"}),
          flush=True)
    return r


if __name__ == "__main__":
    main()
