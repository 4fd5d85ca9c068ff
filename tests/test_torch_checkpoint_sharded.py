"""PyTorch port: the sharded checkpoint (utils/checkpoint.py
``save_orbax``/``load_orbax`` on torch.distributed.checkpoint).

The env-sharded leaves are written as their global batch, so a checkpoint
written at one world size loads at another: here world size 1 without a
process group, and 2 gloo ranks (tests/torch_rank_workers.py::
sharded_checkpoint), both ways. The batch is the ring learner's of
tests/test_ppo.py, built from the same inputs the JAX package's
``batch_reset`` takes, and held to it.
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
from f1tenth_gym_tpu.parallel import vector as jvec
from f1tenth_gym_tpu.tracks.synthetic import ring_map_data as j_ring
from f1tenth_gym_tpu_torch.parallel import multihost
from f1tenth_gym_tpu_torch.state import SimState
from f1tenth_gym_tpu_torch.utils.checkpoint import load_orbax, save_orbax

E = 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _equal(a: SimState, b: SimState):
    for f in dataclasses.fields(SimState):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_ring_batch_matches_jax():
    """The batch both checkpoints hold is the JAX package's reset of the
    same poses (float64, no noise, the march), to 1e-10."""
    *_, states = W.ppo_ring(E)
    jcfg = J.SimConfig(num_agents=1, num_beams=64, dtype="float64",
                       scan_noise=False)
    jm = j_ring(size=128, radius=2.0, dtype=jnp.float64)
    poses = torch.stack([states.start_xs, states.start_ys,
                         states.start_thetas], -1)
    js, *_ = jvec.batch_reset(
        jnp.asarray(poses.numpy()),
        jax.random.split(jax.random.PRNGKey(0), E),
        J.VehicleParams.create(dtype=jnp.float64), jm,
        J.make_scan_tables(num_beams=64, dtype=jnp.float64), jcfg, 0.01)
    np.testing.assert_allclose(states.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(states.scans.numpy(), np.asarray(js.scans),
                               rtol=0, atol=1e-6)


def test_world1_without_process_group(tmp_path):
    """save_orbax and load_orbax in a lone process, no group started: the
    batch, a number and a generator's state come back exactly."""
    assert not dist.is_initialized()
    *_, states = W.ppo_ring(E)
    gen = P.make_generator("cpu", 3)
    path = save_orbax(str(tmp_path / "w1"), {"env_states": states,
                                             "step": 5, "generator": gen})
    assert not dist.is_initialized()
    blank = {"env_states": states.map(torch.zeros_like), "step": 0,
             "generator": P.make_generator("cpu", 0)}
    got = load_orbax(path, blank)
    _equal(got["env_states"], states)
    assert got["step"] == 5
    assert torch.equal(got["generator"].get_state(), gen.get_state())


def test_world2_to_world1_and_back(tmp_path):
    """A checkpoint written at world size 1 loads on 2 ranks, each its
    rows (and the replicated leaves whole); the ranks' shards written at
    world size 2 load at world size 1 as the global batch, bit for bit."""
    *_, states = W.ppo_ring(E)
    gen = P.make_generator("cpu", 9)
    path_in = save_orbax(str(tmp_path / "in"), {
        "env_states": states, "step": 11, "generator": gen})
    path_out = str(tmp_path / "out")
    ranks = multihost.spawn(W.sharded_checkpoint, 2,
                            (E, path_in, path_out), timeout_s=120.0)
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(
            r["x"], states.x.numpy()[rank * E // 2:(rank + 1) * E // 2])
        assert r["step"] == 11
        np.testing.assert_array_equal(r["generator"], gen.get_state().numpy())
    assert not dist.is_initialized()
    got = load_orbax(path_out, {"env_states": states.map(torch.zeros_like),
                                "step": 0})
    _equal(got["env_states"], states)
    assert got["step"] == 7     # a replicated leaf, written once
