"""PyTorch port: the env batch sharded over a mesh of ranks
(parallel/sharding.py, parallel/multihost.py) against one process.

Mirrors tests/test_env.py::test_sharded_batch_step (world size 1, scans
exact), tests/test_pallas_sharded.py (compact culled at 2.0 m, 64 envs x
2 agents x 108 beams, the kernel engine: here its plain version on the
CPU, over 2 gloo ranks, bit for bit with one process, which is itself
held to the JAX package's Pallas engine), tests/test_misc.py::
test_multihost_single_process and tests/test_multihost.py (2 processes:
explicit initialize, host-local batches, 3 steps, an all-reduce equal on
both). The ranks run the functions of tests/torch_rank_workers.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
import torch_rank_workers as W
from f1tenth_gym_tpu.maps import map_path
from f1tenth_gym_tpu.parallel import vector as jvec
from f1tenth_gym_tpu_torch.parallel import multihost
from f1tenth_gym_tpu_torch.parallel.sharding import (
    env_batch_sharding,
    make_mesh,
    replicate,
    shard_env_pytree,
    shard_states,
)
from f1tenth_gym_tpu_torch.tracks.synthetic import ring_start_poses

NB = 108
RANK_TIMEOUT_S = 120.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def local_mesh():
    """A world-size-1 mesh on the CPU; its one-rank group is taken down
    after the test, so no later test of this process finds one."""
    assert not dist.is_initialized()
    yield make_mesh(devices="cpu")
    dist.destroy_process_group()


def test_sharded_batch_step_world1(local_mesh):
    """tests/test_env.py:142-169: 16 envs on the ring, the batch sharded
    over a world-size-1 mesh: scans exact against the unsharded step."""
    cfg, params, tables, m = W.ring_env(2, NB, size=256, radius=4.0)
    poses = torch.as_tensor(np.stack([ring_start_poses(2, 4.0)] * 16))
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               device="cpu")
    sharded = shard_states(states, local_mesh)
    params_r, m_r, tables_r = replicate((params, m, tables), local_mesh)
    actions = torch.tensor([[0.01, 3.0], [0.0, 2.0]],
                           dtype=torch.float64).expand(16, 2, 2)
    out_sh, obs_sh, *_ = P.batch_step(sharded, actions, params_r, m_r,
                                      tables_r, cfg, 0.01)
    out_lo, obs_lo, *_ = P.batch_step(states, actions, params, m, tables,
                                      cfg, 0.01)
    assert torch.equal(obs_sh["scans"], obs_lo["scans"])
    assert torch.equal(out_sh.x, out_lo.x)
    assert out_sh.num_envs == 16


def test_shard_and_replicate_layouts(local_mesh):
    """shard_states' 8-scan subgroup rule, the per-env VehicleParams leaf
    sharded by replicate, and the DTensor view of the env layout."""
    cfg, params, tables, m = W.ring_env(1, 32)
    poses = torch.as_tensor(np.stack([ring_start_poses(1, 1.5)] * 12))
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               device="cpu")
    with pytest.raises(ValueError, match="subgroups"):
        shard_states(states, local_mesh)     # 12 x 1 scans
    per_env = dataclasses.replace(params, m=torch.arange(16.0)[:, None])
    rep = replicate(per_env, local_mesh)
    assert torch.equal(rep.m, per_env.m) and rep.mu.dim() == 0
    rows = shard_env_pytree({"a": torch.arange(8.0)}, local_mesh)
    assert torch.equal(rows["a"], torch.arange(8.0))
    view = env_batch_sharding(local_mesh).global_view(torch.ones(4, 3))
    assert view.shape == (4, 3)


@pytest.fixture(scope="module")
def compact_run():
    """compact culled at 2.0 m, 64 envs x 2 agents x 108 beams of the
    grouped sampler, the kernel engine, no scan noise: the one-process
    steps, the same steps over 2 gloo ranks, and JAX's first step."""
    cfg, params, tables, m = W.compact_kernel_env(NB)
    sampler = P.uniform_pose_sampler(m, clearance=0.45, grouped=True,
                                     align_theta=True)
    poses = sampler(P.make_generator("cpu", 3), (64, 2)).numpy()
    first = np.tile(np.float32([[0.05, 3.0], [-0.02, 2.5]]), (64, 1, 1))
    then = np.tile(np.float32([[0.1, 2.0], [-0.1, 2.0]]), (64, 1, 1))
    actions = [first, then, then, then]
    states, *_ = P.batch_reset(torch.as_tensor(poses), params, m, tables,
                               cfg, 0.01, device="cpu")
    reset = states
    one = []
    for a in actions:
        states, obs, *_ = P.batch_step(states, torch.as_tensor(a), params, m,
                                       tables, cfg, 0.01)
        one.append(dict(scans=obs["scans"].numpy(), x=states.x.numpy(),
                        states=states))
    ranks = multihost.spawn(W.sharded_kernel_steps, 2,
                            (poses, actions, NB), timeout_s=RANK_TIMEOUT_S)
    return dict(poses=poses, actions=actions, reset=reset, one=one,
                ranks=ranks, m=m)


def test_sharded_kernel_step_two_ranks(compact_run):
    """tests/test_pallas_sharded.py, one step and three more: the ranks'
    stitched scans and states are the one process's, bit for bit."""
    one, ranks = compact_run["one"], compact_run["ranks"]
    for t in range(len(one)):
        for k in ("scans", "x"):
            stitched = np.concatenate([r[t][k] for r in ranks])
            np.testing.assert_array_equal(stitched, one[t][k],
                                          err_msg=f"step {t} {k}")
    assert ranks[0][0]["scans"].shape == (32, 2, NB)
    # culled windows were selected on this pack
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    x = one[0]["states"].x
    w = sk.prepare_map(torch.stack([x[..., 0], x[..., 1], x[..., 4]],
                                   -1).reshape(-1, 3), compact_run["m"],
                       P.make_scan_tables(num_beams=NB, device="cpu"), NB,
                       2000)
    assert int((w.bid > 0).sum()) >= 2


def test_one_process_step_matches_jax_pallas(compact_run):
    """The one-process port step that the ranks are held to, against the
    JAX package's batch_step with the Pallas engine (interpret mode) on
    the same poses, at the kernel tolerance of test_torch_env.py. The
    first 16 envs stand for the batch: they are whole 8-scan subgroups, so
    they select the same culled windows as in the full batch."""
    jcfg = J.SimConfig(num_agents=2, num_beams=NB, dtype="float32",
                       scan_engine="pallas", scan_noise=False)
    jp = J.VehicleParams.create(dtype=jnp.float32)
    jt = J.make_scan_tables(num_beams=NB, dtype=jnp.float32)
    jm = J.load_map(map_path("compact"), ".png", dtype=jnp.float32,
                    extract_segments=True, tile_culling=True,
                    culling_tile_size=2.0)
    n = 16
    # JAX starts from the port's reset states (held to JAX's reset by
    # test_torch_env.py), so that only the step runs in interpret mode
    reset = {f.name: jnp.asarray(getattr(compact_run["reset"], f.name)[:n]
                                 .numpy())
             for f in dataclasses.fields(compact_run["reset"])}
    js = J.SimState(**reset, key=jax.random.split(jax.random.PRNGKey(0), n))
    js, jobs, *_ = jax.jit(lambda s, a: jvec.batch_step(
        s, a, jp, jm, jt, jcfg, 0.01))(js, jnp.asarray(
            compact_run["actions"][0][:n]))
    got = compact_run["one"][0]
    err = np.abs(got["scans"][:n] - np.asarray(jobs["scans"]))
    assert np.median(err) < 1e-5 and np.percentile(err, 99.9) < 1e-3
    np.testing.assert_allclose(got["x"][:n], np.asarray(js.x), rtol=1e-5,
                               atol=1e-5)


def test_multihost_single_process():
    """tests/test_misc.py::test_multihost_single_process: without cluster
    variables initialize() stays local, and the helpers work at world
    size 1."""
    assert not dist.is_initialized()
    multihost.initialize()      # no-op in a lone process
    assert not multihost.is_initialized()
    mesh = multihost.global_mesh(devices="cpu")
    try:
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("env", "model")
        cfg, params, tables, m = W.ring_env(2, NB, size=256, radius=4.0)

        def make_local(n):
            poses = torch.tensor([[4.0, 0.0, 1.57], [4.0, 1.0, 1.57]],
                                 dtype=torch.float64).expand(n, 2, 3)
            states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                                       generator=P.make_generator("cpu", 0),
                                       device="cpu")
            return states

        states = multihost.host_local_states(make_local, mesh,
                                             envs_per_host=16)
        assert states.x.shape == (16, 2, 7)
        multihost.initialize()      # a second call is a no-op too
    finally:
        dist.destroy_process_group()


def test_initialize_after_local_mesh_raises(local_mesh, monkeypatch):
    """Once make_mesh() has started its one-rank group, an initialize that
    would join ranks (explicit, or from torchrun's variables) raises
    instead of leaving each rank to train alone; without either it stays
    a no-op."""
    multihost.initialize()
    with pytest.raises(RuntimeError, match="before make_mesh"):
        multihost.initialize(coordinator_address="127.0.0.1:1",
                             num_processes=2, process_id=0, devices="cpu")
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT="1", RANK="0",
                     WORLD_SIZE="2").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="before make_mesh"):
        multihost.initialize(devices="cpu")
    assert dist.get_world_size() == 1


@pytest.mark.parametrize("devices,backend", [("cpu", "gloo"),
                                             ("cuda", "nccl")])
def test_initialize_backend_follows_device(devices, backend, monkeypatch):
    """On a host with a card for every rank, CPU ranks still get gloo and
    card ranks NCCL (the group itself is not started here)."""
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: seen.setdefault("card", i))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.setdefault("backend",
                                                              backend))
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    multihost.initialize(coordinator_address="127.0.0.1:1", num_processes=2,
                         process_id=1, devices=devices)
    assert seen["backend"] == backend
    assert seen.get("card") == (1 if devices == "cuda" else None)


def test_two_process_stitch_and_allreduce():
    """tests/test_multihost.py: 2 coordinated processes, each a 4-env
    host-local batch; after 3 steps the all-reduced global mean speed is
    the same on both, and equals one process's on the 8 envs."""
    vals = multihost.spawn(W.multihost_stitch, 2, timeout_s=RANK_TIMEOUT_S)
    assert vals[0] == vals[1], vals
    cfg, params, tables, m = W.ring_env(1, 32, dtype="float32")
    poses = torch.as_tensor(np.stack([ring_start_poses(1, 1.5)] * 8))
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               device="cpu")
    actions = torch.tensor([[[0.0, 2.0]]]).expand(8, 1, 2)
    for _ in range(3):
        states, *_ = P.batch_step(states, actions, params, m, tables, cfg,
                                  0.01)
    want = float(states.x[:, :, 3].double().mean())
    assert vals[0] > 0.1
    np.testing.assert_allclose(vals[0], want, rtol=1e-12)


def test_spawn_reports_a_failed_rank():
    """A rank that raises fails the whole launch with its traceback."""
    with pytest.raises(RuntimeError, match="on purpose"):
        multihost.spawn(W.failing_weak_child, 2, timeout_s=RANK_TIMEOUT_S)


def test_train_ppo_learner_world1_equals_unsharded(local_mesh):
    """train_ppo's learner through PPO(mesh=make_mesh()) in a lone process
    is the learner without a mesh, bit for bit after an iteration (scan
    noise on: at world size 1 its stream is the one-process one)."""
    from f1tenth_gym_tpu_torch.train_ppo import make_learner

    kw = dict(map_name="compact", envs=16, beams=NB, engine="segments")
    ppo_a, ts_a = make_learner(device="cpu", **kw)
    ppo_b, ts_b = make_learner(mesh=local_mesh, **kw)
    assert ppo_b.mesh is local_mesh and ts_b.env_states.num_envs == 16
    ts_a, met_a = ppo_a.train_step(ts_a)
    ts_b, met_b = ppo_b.train_step(ts_b)
    for a, b in zip(ts_a.net.parameters(), ts_b.net.parameters()):
        assert torch.equal(a, b)
    for f in dataclasses.fields(ts_a.env_states):
        assert torch.equal(getattr(ts_a.env_states, f.name),
                           getattr(ts_b.env_states, f.name)), f.name
    assert {k: float(v) for k, v in met_a.items()} == \
        {k: float(v) for k, v in met_b.items()}
