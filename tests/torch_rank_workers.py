"""Rank functions of the port's multi-process tests (not collected).

Each runs in a process of ``multihost.spawn`` as ``fn(rank, nprocs, port,
*args)``, joins a gloo group on the CPU through ``multihost.initialize``
and returns numpy arrays to the test, which holds them to one process.
They import neither JAX nor the JAX package.
"""

import numpy as np
import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.maps import map_path
from f1tenth_gym_tpu_torch.parallel import multihost
from f1tenth_gym_tpu_torch.parallel.ppo import PPO, PPOConfig
from f1tenth_gym_tpu_torch.parallel.sharding import (
    all_gather_cat,
    all_reduce_sum,
    axis_group,
    make_mesh,
    shard_states,
)
from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data, ring_start_poses
from f1tenth_gym_tpu_torch.utils import checkpoint, convert

def _join(rank, nprocs, port):
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=nprocs, process_id=rank,
                         devices="cpu")
    assert multihost.is_initialized()


def compact_kernel_env(num_beams):
    """compact culled at 2.0 m, the kernel engine, no scan noise."""
    cfg = P.SimConfig(num_agents=2, num_beams=num_beams, dtype="float32",
                      scan_engine="kernel", scan_noise=False)
    params = P.VehicleParams.create(device="cpu")
    tables = P.make_scan_tables(num_beams=num_beams, device="cpu")
    m = P.load_map(map_path("compact"), extract_segments=True,
                   tile_culling=True, culling_tile_size=2.0, device="cpu")
    return cfg, params, tables, m


def sharded_kernel_steps(rank, nprocs, port, poses, actions, num_beams):
    """The global batch reset at ``poses``, this rank's rows stepped with
    each of ``actions`` (global (E, A, 2) arrays): the rank's scans and
    states after each step."""
    _join(rank, nprocs, port)
    mesh = make_mesh(devices="cpu")
    cfg, params, tables, m = compact_kernel_env(num_beams)
    states, *_ = P.batch_reset(torch.as_tensor(poses), params, m, tables,
                               cfg, 0.01, device="cpu")
    states = shard_states(states, mesh)
    E = states.num_envs
    out = []
    for a in actions:
        a = torch.as_tensor(a)[rank * E:(rank + 1) * E]
        states, obs, *_ = P.batch_step(states, a, params, m, tables, cfg,
                                       0.01)
        out.append(dict(scans=obs["scans"].numpy(), x=states.x.numpy()))
    return out


def ring_env(num_agents, num_beams, size=64, radius=1.5, dtype="float64"):
    cfg = P.SimConfig(num_agents=num_agents, num_beams=num_beams,
                      dtype=dtype, scan_noise=False)
    tdtype = getattr(torch, dtype)
    params = P.VehicleParams.create(dtype=tdtype, device="cpu")
    tables = P.make_scan_tables(num_beams=num_beams, dtype=tdtype,
                                device="cpu")
    m = ring_map_data(size=size, radius=radius, dtype=tdtype, device="cpu")
    return cfg, params, tables, m


def multihost_stitch(rank, nprocs, port):
    """tests/multihost_worker.py: host-local batches, 3 steps, the global
    mean speed through an all-reduce."""
    _join(rank, nprocs, port)
    mesh = multihost.global_mesh(devices="cpu")
    assert mesh.size() == nprocs
    cfg, params, tables, m = ring_env(1, 32, dtype="float32")

    def make_local(envs):
        poses = torch.as_tensor(np.stack([ring_start_poses(1, 1.5)] * envs))
        states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                                   device="cpu")
        return states

    states = multihost.host_local_states(make_local, mesh, envs_per_host=4)
    assert states.x.shape == (4, 1, 7), states.x.shape
    actions = torch.tensor([[[0.0, 2.0]]]).expand(4, 1, 2)
    for _ in range(3):
        states, *_ = P.batch_step(states, actions, params, m, tables, cfg,
                                  0.01)
    total = all_reduce_sum(states.x[:, :, 3].sum().double(),
                           axis_group(mesh, "env"))
    return float(total) / (4 * nprocs)


def ppo_ring(E, dtype="float64"):
    """The learner of tests/test_ppo.py (ring, one agent, 64 beams, no
    scan noise) on E envs: (cfg, params, tables, map, global states)."""
    cfg, params, tables, m = ring_env(1, 64, size=128, radius=2.0,
                                      dtype=dtype)
    poses = torch.as_tensor(np.stack([ring_start_poses(1, 2.0)] * E),
                            dtype=getattr(torch, dtype))
    # spread the envs round the ring, so their rollouts differ
    ang = torch.linspace(0.0, 2 * np.pi, E + 1, dtype=poses.dtype)[:-1]
    r = torch.hypot(poses[:, 0, 0], poses[:, 0, 1])
    poses[:, 0, 0], poses[:, 0, 1] = r * torch.cos(ang), r * torch.sin(ang)
    poses[:, 0, 2] = ang + np.pi / 2
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               device="cpu")
    return cfg, params, tables, m, states


PPO_CFG = PPOConfig(obs_beams=16, hidden=32, rollout_steps=3, epochs=2,
                    minibatches=2)


def ppo_parts(ppo, ts, metrics):
    net = convert.actor_critic_to_numpy(ts.net)
    return dict(net=net, metrics={k: float(v) for k, v in metrics.items()},
                x=ts.env_states.x.numpy())


def sharded_ppo(rank, nprocs, port, E, feats, flax_params):
    """One PPO iteration over an ('env',) mesh of the ranks and one over a
    ('model',) mesh (forward, gradients of the loss on ``feats`` and the
    iteration), and ``actor_critic_from_flax`` over the 'model' mesh on
    ``feats``."""
    _join(rank, nprocs, port)
    out = {}
    cfg, params, tables, m, states = ppo_ring(E)

    env_mesh = make_mesh(devices="cpu")
    ppo = PPO(params, m, tables, cfg, 0.01, PPO_CFG, mesh=env_mesh)
    ts = ppo.init(shard_states(states, env_mesh),
                  P.make_generator("cpu", 1))
    before = [p.detach().clone() for p in ts.net.parameters()]
    ts, metrics = ppo.train_step(ts)
    out["env"] = ppo_parts(ppo, ts, metrics)
    out["env"]["changed"] = all(not torch.equal(a, b) for a, b in
                                zip(before, ts.net.parameters()))

    model_mesh = make_mesh(1, nprocs, devices="cpu")
    ppo = PPO(params, m, tables, cfg, 0.01, PPO_CFG, mesh=model_mesh)
    ts = ppo.init(states, P.make_generator("cpu", 1))
    x = torch.as_tensor(feats)
    mean, log_std, value = ts.net(x)
    (mean.square().sum() + value.square().sum() + log_std.sum()).backward()
    whole = {"fc1.weight": 0, "fc1.bias": 0, "fc2.weight": 1}
    grads = {k: all_gather_cat(p.grad, ts.net.model_group, whole[k]).numpy()
             if k in whole else p.grad.numpy().copy()
             for k, p in ts.net.named_parameters()}
    ts.opt.zero_grad()
    out["model_forward"] = [t.detach().numpy().copy()
                            for t in (mean, log_std, value)]
    out["model_grads"] = grads
    ts, metrics = ppo.train_step(ts)
    out["model"] = ppo_parts(ppo, ts, metrics)
    out["model_shapes"] = {k: tuple(p.shape)
                           for k, p in ts.net.named_parameters()}

    net = convert.actor_critic_from_flax(flax_params, mesh=model_mesh)
    out["from_flax"] = [t.detach().numpy().copy() for t in net(x)]
    return out


def sharded_checkpoint(rank, nprocs, port, E, path_in, path_out):
    """Load ``path_in`` (written at world size 1) at this world size, then
    write this rank's shard of the ring batch to ``path_out``."""
    _join(rank, nprocs, port)
    mesh = make_mesh(devices="cpu")
    cfg, params, tables, m, states = ppo_ring(E)
    local = shard_states(states, mesh)
    blank = {"env_states": local.map(torch.zeros_like), "step": 0,
             "generator": P.make_generator("cpu", 0)}
    got = checkpoint.load_orbax(path_in, blank, mesh)
    checkpoint.save_orbax(path_out, {"env_states": local, "step": 7}, mesh)
    return dict(x=got["env_states"].x.numpy(), step=got["step"],
                generator=got["generator"].get_state().numpy())


def failing_weak_child(rank, nprocs, port, *args):
    raise RuntimeError(f"weak-scaling rank {rank} fails on purpose")
