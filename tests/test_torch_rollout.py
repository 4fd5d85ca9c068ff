"""PyTorch port: parallel/rollout.py against the JAX package's rollout.

A deterministic policy (pure pursuit along the ring's centre line, from
each package's planner) on 4 envs x 2 agents of the ring, float64, the
marching engine, no scan noise, auto-reset to the start poses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.parallel import rollout as j_rollout
from f1tenth_gym_tpu.parallel import vector as jvec
from f1tenth_gym_tpu.planning import PurePursuitPlanner as JPlanner
from f1tenth_gym_tpu.tracks.synthetic import ring_map_data as j_ring
from f1tenth_gym_tpu.tracks.synthetic import ring_start_poses
from f1tenth_gym_tpu.utils.waypoints import ring_waypoints
from f1tenth_gym_tpu_torch.parallel import Transition, rollout
from f1tenth_gym_tpu_torch.planning import PurePursuitPlanner as PPlanner
from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data as p_ring
from f1tenth_gym_tpu_torch.utils import convert

T, E, A, NB = 12, 4, 2, 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _leaves(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if v is not None}


@pytest.fixture(scope="module")
def both():
    """(JAX args, port args) of the same rollout."""
    poses = np.stack([ring_start_poses(A, 2.0)] * E)
    poses[1, :, 2] += 0.8                          # off the corridor: crash
    poses[3, 1] = poses[3, 0] + [0.1, 0.0, 0.2]    # overlapping spawn
    cfg_kw = dict(num_agents=A, num_beams=NB, dtype="float64",
                  scan_noise=False)
    jm = j_ring(size=128, radius=2.0, dtype=jnp.float64)
    pm = p_ring(size=128, radius=2.0, dtype=torch.float64, device="cpu")
    jcfg, pcfg = J.SimConfig(**cfg_kw), P.SimConfig(**cfg_kw)
    jparams = J.VehicleParams.create(dtype=jnp.float64)
    pparams = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    jt = J.make_scan_tables(num_beams=NB, dtype=jnp.float64)
    pt = P.make_scan_tables(num_beams=NB, dtype=torch.float64, device="cpu")
    jstates, *_ = jvec.batch_reset(jnp.asarray(poses),
                                   jax.random.split(jax.random.PRNGKey(0), E),
                                   jparams, jm, jt, jcfg, 0.01)
    pstates = convert.sim_state_from_jax(_leaves(jstates), device="cpu")
    jstep = jvec.make_autoreset_step(jparams, jm, jt, jcfg, 0.01,
                                     reset_poses=jnp.asarray(poses))
    pstep = P.make_autoreset_step(pparams, pm, pt, pcfg, 0.01,
                                  reset_poses=torch.as_tensor(poses),
                                  device="cpu")
    wpts = ring_waypoints(2.0, speed=5.0)
    jpol = JPlanner(wpts).batched_policy(0.8, 1.0)
    ppol = PPlanner(wpts, device="cpu").batched_policy(0.8, 1.0)
    jargs = (jstates, jpol, T, jparams, jm, jt, jcfg, 0.01,
             jax.random.PRNGKey(1))
    pargs = (pstates, ppol, T, pparams, pm, pt, pcfg, 0.01,
             P.make_generator("cpu", 1))
    return (jargs, jstep), (pargs, pstep)


def test_rollout_matches_jax(both):
    (jargs, jstep), (pargs, pstep) = both
    js, jtr = j_rollout(*jargs, step_fn=jstep)
    ps, ptr = rollout(*pargs, step_fn=pstep)
    assert isinstance(ptr, Transition)
    assert bool(np.asarray(jtr.done).any()), "no env was done and reset"
    assert set(ptr.obs) == set(jtr.obs)
    for k in jtr.obs:
        assert ptr.obs[k].shape == jtr.obs[k].shape, k
        np.testing.assert_allclose(ptr.obs[k].numpy(), np.asarray(jtr.obs[k]),
                                   rtol=0, atol=1e-9, err_msg=k)
    for k in ("action", "reward"):
        np.testing.assert_allclose(getattr(ptr, k).numpy(),
                                   np.asarray(getattr(jtr, k)), rtol=0,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(ptr.done.numpy(), np.asarray(jtr.done))
    np.testing.assert_allclose(ps.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=1e-9)
    # obs0 carries a zero lateral speed, as the step's obs does
    assert not ptr.obs["linear_vels_y"].any()


def test_rollout_totals_match_jax(both):
    (jargs, jstep), (pargs, pstep) = both
    js, (jr, jd) = j_rollout(*jargs, step_fn=jstep, collect=False)
    ps, (pr, pd) = rollout(*pargs, step_fn=pstep, collect=False)
    np.testing.assert_allclose(float(pr), float(jr), rtol=0, atol=1e-12)
    assert int(pd) == int(jd) > 0
    _, full = rollout(*pargs, step_fn=pstep)
    assert int(pd) == int(full.done.sum())
    np.testing.assert_allclose(float(pr), float(full.reward.sum()), rtol=0,
                               atol=1e-12)


def test_rollout_without_step_fn_draws_noise_from_generator():
    """Without ``step_fn`` the envs step with ``batch_step``, whose scan
    noise comes from the rollout's generator: the same seed gives the
    same rollout, another seed another."""
    m = p_ring(size=128, radius=2.0, device="cpu")
    cfg = P.SimConfig(num_agents=1, num_beams=NB)
    params = P.VehicleParams.create(device="cpu")
    tables = P.make_scan_tables(num_beams=NB, device="cpu")
    poses = torch.as_tensor(np.stack([ring_start_poses(1, 2.0)] * 2))
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               device="cpu")

    def policy(generator, obs):
        return torch.stack([torch.zeros_like(obs["poses_x"]),
                            torch.full_like(obs["poses_x"], 2.0)], -1)

    def run(seed):
        return rollout(states, policy, 4, params, m, tables, cfg, 0.01,
                       P.make_generator("cpu", seed))[1].obs["scans"]

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a[1:], c[1:])
