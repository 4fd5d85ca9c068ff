"""PyTorch port: utils/checkpoint.py, utils/metrics.py, utils/profiling.py
and the model registry, against the JAX package where it has them.

A JAX ``save_pytree(net_params)`` file loads into the port (flax keypaths,
no unpickling) and gives the flax net's forward; the port's ``.npz`` loads
back into the JAX package; a learner's checkpoint resumes bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu import models as jmodels
from f1tenth_gym_tpu.parallel import ppo as jppo
from f1tenth_gym_tpu.tracks.synthetic import ring_start_poses
from f1tenth_gym_tpu.utils import checkpoint as jckpt
from f1tenth_gym_tpu_torch import models as pmodels
from f1tenth_gym_tpu_torch.parallel import ppo as pppo
from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data
from f1tenth_gym_tpu_torch.utils import checkpoint as ckpt
from f1tenth_gym_tpu_torch.utils import convert, profiling
from f1tenth_gym_tpu_torch.utils.metrics import MetricsLogger, read_jsonl


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flax(hidden, obs_dim, seed=0):
    net = jppo.ActorCritic(hidden=hidden)
    return net, net.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)))


def test_jax_policy_file_loads_into_port(tmp_path):
    """The JAX package's save_pytree of a flax ``net_params`` (its pickled
    treedef included) loads into a target made from the port's module and
    gives flax's forward; nothing is unpickled."""
    jnet, params = _flax(32, 18, seed=4)
    path = jckpt.save_pytree(str(tmp_path / "jax_policy"), params)
    net = pppo.ActorCritic(18, 32, dtype=torch.float64, device="cpu")
    loaded = ckpt.load_pytree(path, target=convert.actor_critic_to_numpy(net))
    port = convert.actor_critic_from_flax(loaded, device="cpu")
    x = np.random.default_rng(0).normal(size=(6, 2, 18))
    for g, w in zip(port(torch.as_tensor(x)), jnet.apply(params,
                                                         jnp.asarray(x))):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
    # without a target: a flat dict by flax keypath, the treedef unread
    flat = ckpt.load_pytree(path)
    assert "['params']['fc1']['kernel']" in flat
    np.testing.assert_array_equal(flat["['params']['fc1']['kernel']"],
                                  np.asarray(params["params"]["fc1"]["kernel"]))


def test_port_policy_file_loads_into_jax(tmp_path):
    """And back: a file the port wrote restores into the flax params with
    the JAX package's target form."""
    jnet, params = _flax(32, 18, seed=5)
    net = convert.actor_critic_from_flax(jax.tree.map(np.asarray, params),
                                         device="cpu")
    with torch.no_grad():
        net.fc2.weight.mul_(1.5)
    path = ckpt.save_pytree(str(tmp_path / "port_policy"),
                            convert.actor_critic_to_numpy(net))
    back = jckpt.load_pytree(path, target=params)
    x = np.random.default_rng(1).normal(size=(4, 18))
    for g, w in zip(net(torch.as_tensor(x)), jnet.apply(back, jnp.asarray(x))):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def _learner(gen_seed):
    """A fresh PPO learner on the ring, scan noise on, auto-reset: the
    process a resumed run builds before it loads its checkpoint."""
    m = ring_map_data(size=128, radius=2.0, dtype=torch.float64, device="cpu")
    cfg = P.SimConfig(num_agents=2, num_beams=64, dtype="float64")
    params = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    tables = P.make_scan_tables(num_beams=64, dtype=torch.float64,
                                device="cpu")
    poses = torch.as_tensor(np.stack([ring_start_poses(2, 2.0)] * 6))
    poses[1, :, 2] += 0.8  # crashes, so the auto-reset draws noise too
    gen = P.make_generator("cpu", gen_seed)
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               generator=gen, device="cpu")
    astep = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                  reset_poses=poses, generator=gen,
                                  device="cpu")
    ppo = pppo.PPO(params, m, tables, cfg, 0.01,
                   pppo.PPOConfig(obs_beams=16, hidden=32, rollout_steps=4,
                                  epochs=2, minibatches=2),
                   step_fn=astep, device="cpu")
    return ppo, ppo.init(states, P.make_generator("cpu", gen_seed + 100))


def _assert_same(a, b):
    for (k, x), (_, y) in zip(a.net.named_parameters(),
                              b.net.named_parameters()):
        assert torch.equal(x, y), k
    for k in ("x", "scans", "collisions", "steer_buf", "lap_times"):
        assert torch.equal(getattr(a.env_states, k),
                           getattr(b.env_states, k)), k


def test_train_state_resumes_bit_for_bit(tmp_path):
    """Save a TrainState after one iteration, load it into a learner built
    from other seeds, and take the next iteration from both: the same
    parameters, Adam state and env states, bit for bit (the generators'
    states are part of the checkpoint)."""
    ppo_a, ts_a = _learner(1)
    ts_a, _ = ppo_a.train_step(ts_a)
    path = ckpt.save_pytree(str(tmp_path / "ts"), ts_a)
    ppo_b, ts_b = _learner(7)
    ts_b = ckpt.load_pytree(path, target=ts_b)
    assert ts_b.env_generator is ppo_b.env_generator
    _assert_same(ts_a, ts_b)
    ts_a, met_a = ppo_a.train_step(ts_a)
    ts_b, met_b = ppo_b.train_step(ts_b)
    _assert_same(ts_a, ts_b)
    for k in met_a:
        assert torch.equal(met_a[k], met_b[k]), k
    assert int(ts_a.opt.count) == int(ts_b.opt.count) == 8
    for k in ts_a.opt.mu:
        assert torch.equal(ts_a.opt.mu[k], ts_b.opt.mu[k]), k
        assert torch.equal(ts_a.opt.nu[k], ts_b.opt.nu[k]), k
    # the file lists every generator: the learner's and the env step's
    flat = ckpt.load_pytree(path)
    assert ".generator" in flat and ".env_generator" in flat
    assert flat[".env_states.x"].dtype == np.float64


def test_sim_state_roundtrip_resumes(tmp_path):
    """tests/test_components.py::test_checkpoint_roundtrip_simstate on the
    port: a resumed step is bit-identical to the uninterrupted one."""
    m = ring_map_data(size=128, radius=2.0, dtype=torch.float64, device="cpu")
    cfg = P.SimConfig(num_agents=2, num_beams=64, dtype="float64")
    params = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    tables = P.make_scan_tables(num_beams=64, dtype=torch.float64,
                                device="cpu")
    gen = P.make_generator("cpu", 3)
    s, *_ = P.env_reset(torch.as_tensor(ring_start_poses(2, 2.0))[None],
                        params, m, tables, cfg, 0.01, gen)
    a = torch.tensor([[[0.1, 2.0], [0.0, 1.0]]], dtype=torch.float64)
    for _ in range(3):
        s, *_ = P.env_step(s, a, params, m, tables, cfg, 0.01, gen)
    path = ckpt.save_pytree(str(tmp_path / "sim"), {"state": s, "gen": gen})
    fresh = {"state": s.replace(x=torch.zeros_like(s.x)),
             "gen": P.make_generator("cpu", 99)}
    back = ckpt.load_pytree(path, target=fresh)
    assert torch.equal(back["state"].x, s.x)
    s_cont, o_cont, *_ = P.env_step(s, a, params, m, tables, cfg, 0.01, gen)
    s_res, o_res, *_ = P.env_step(back["state"], a, params, m, tables, cfg,
                                  0.01, back["gen"])
    assert torch.equal(o_cont["scans"], o_res["scans"])
    assert torch.equal(s_cont.x, s_res.x)


def test_target_form_refuses_a_mismatched_tree(tmp_path):
    tree = {"a": torch.zeros(3), "b": {"c": np.arange(4, dtype=np.int32)},
            "n": 2.5}
    path = ckpt.save_pytree(str(tmp_path / "t.npz"), tree)
    back = ckpt.load_pytree(path, target=tree)
    assert back["n"] == 2.5 and back["b"]["c"].dtype == np.int32
    bad_targets = {
        "keypath": {"a": torch.zeros(3), "b": {"d": np.zeros(4, np.int32)},
                    "n": 0.0},
        "count": {"a": torch.zeros(3), "n": 0.0},
        "shape": {"a": torch.zeros(4), "b": {"c": np.zeros(4, np.int32)},
                  "n": 0.0},
        "dtype": {"a": torch.zeros(3, dtype=torch.float64),
                  "b": {"c": np.zeros(4, np.int32)}, "n": 0.0},
    }
    for what, target in bad_targets.items():
        with pytest.raises(ValueError):
            ckpt.load_pytree(path, target=target)
    # the JAX package refuses a mismatched port file the same way
    with pytest.raises(ValueError):
        jckpt.load_pytree(path, target={"a": jnp.zeros(3), "n": 0.0})


def test_metrics_logger_roundtrip(tmp_path):
    path = tmp_path / "run" / "metrics.jsonl"
    csv = tmp_path / "run" / "metrics.csv"
    with MetricsLogger(str(path), csv_path=str(csv)) as log:
        rec = log.log(iter=0, loss=torch.tensor(0.25, dtype=torch.float64),
                      reward=np.float32(-0.5), tag="x")
        log.log(iter=1, loss=torch.tensor(0.125), reward=1.0, tag="y")
    assert rec["loss"] == 0.25 and isinstance(rec["loss"], float)
    rows = read_jsonl(str(path))
    assert [r["iter"] for r in rows] == [0, 1]
    assert rows[1]["loss"] == 0.125 and rows[0]["reward"] == -0.5
    assert all("time" in r for r in rows)
    lines = csv.read_text().splitlines()
    assert lines[0] == "iter,loss,reward,tag,time" and len(lines) == 3
    json.loads(path.read_text().splitlines()[0])


def test_model_registry_matches_jax():
    assert set(pmodels.MODEL_REGISTRY) == set(jmodels.MODEL_REGISTRY)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 7))
    x[:, 3] = rng.uniform(-1, 8, 16)  # both sides of the ST speed switch
    u = rng.normal(size=(16, 2))
    jp = J.VehicleParams.create(dtype=jnp.float64)
    pp = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    for name in jmodels.MODEL_REGISTRY:
        want = jmodels.get_model(name)(jnp.asarray(x), jnp.asarray(u), jp)
        got = pmodels.get_model(name)(torch.as_tensor(x), torch.as_tensor(u),
                                      pp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    with pytest.raises(ValueError, match="unknown model"):
        pmodels.get_model("nope")


def test_profiling_on_a_cpu_carry(tmp_path):
    """measure_steps_per_sec counts items a second on a CPU carry (no
    fence there), and trace writes a CPU-only trace for CPU work."""
    rate, carry = profiling.measure_steps_per_sec(
        lambda c: {"x": c["x"] + 1}, {"x": torch.zeros(4)}, num_steps=8,
        warmup=2, items_per_step=4)
    assert rate > 0 and float(carry["x"][0]) == 10.0
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as prof:
        with profiling.annotate("phase"):
            torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").exists()
    assert any(e.key == "phase" for e in prof.key_averages())
