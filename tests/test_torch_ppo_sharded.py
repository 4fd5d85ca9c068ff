"""PyTorch port: PPO over a mesh of ranks (parallel/ppo.py, ``mesh=``)
against one process on the full batch, in float64 on the CPU.

Two gloo ranks run tests/torch_rank_workers.py::sharded_ppo once: an
iteration over an ('env',) mesh, whose gradients are summed over 'env';
the net over a ('model',) mesh, split as JAX ``_shard_net_params`` splits
it, its forward, its gradients and an iteration; and the flax net's
weights brought in under that mesh. The reduction order differs from one
process, hence the tolerances: 1e-10 for an iteration, 1e-12 for the
'model' forward and gradients.
Mirrors tests/test_ppo.py::test_ppo_train_step_sharded too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu_torch as P
import torch_rank_workers as W
from f1tenth_gym_tpu.parallel import ppo as jppo
from f1tenth_gym_tpu_torch.parallel import multihost
from f1tenth_gym_tpu_torch.parallel.ppo import PPO

E = 16          # 8 envs a rank over 'env': whole 8-scan subgroups
# an iteration ends in Adam, whose step divides by the gradient's root
# mean square: on pi_log_std, whose gradient is near Adam's eps, a 1e-16
# difference of the gradient moves the step by ~1e-12. So the iterations
# are held to 1e-10, the 'model' forward and gradients to 1e-12
ITER_TOL, MODEL_TOL = 1e-10, 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _max_diff(a, b):
    if isinstance(a, dict):
        return max(_max_diff(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b)).max())


@pytest.fixture(scope="module")
def run():
    """One process's learner on the full batch, the features, the flax
    parameters, and the ranks' results."""
    cfg, params, tables, m, states = W.ppo_ring(E)
    ppo = PPO(params, m, tables, cfg, 0.01, W.PPO_CFG, device="cpu")
    ts = ppo.init(states, P.make_generator("cpu", 1))
    feats = np.random.default_rng(0).normal(size=(5, 3, 18))
    x = torch.as_tensor(feats)
    mean, log_std, value = ts.net(x)
    (mean.square().sum() + value.square().sum() + log_std.sum()).backward()
    grads = {k: p.grad.numpy().copy() for k, p in ts.net.named_parameters()}
    forward = [t.detach().numpy().copy() for t in (mean, log_std, value)]
    ts.opt.zero_grad()
    ts, metrics = ppo.train_step(ts)
    one = W.ppo_parts(ppo, ts, metrics)

    jnet = jppo.ActorCritic(hidden=W.PPO_CFG.hidden)
    fparams = jnet.init(jax.random.PRNGKey(4), jnp.zeros((1, 18)))
    flax_np = jax.tree.map(np.asarray, fparams)
    flax_out = [np.asarray(t) for t in jnet.apply(fparams, jnp.asarray(feats))]
    ranks = multihost.spawn(W.sharded_ppo, 2, (E, feats, flax_np),
                            timeout_s=120.0)
    return dict(one=one, grads=grads, forward=forward, flax_out=flax_out,
                ranks=ranks)


def test_env_sharded_update_matches_one_process(run):
    """2 ranks on 'env': the rollout (global policy noise, each rank its
    rows), the global advantage normalisation, the owned rows of each
    global minibatch, the summed gradients and Adam give one process's
    parameters and metrics within 1e-10."""
    one = run["one"]
    for r in run["ranks"]:
        got = r["env"]
        assert _max_diff(got["net"], one["net"]) <= ITER_TOL
        for k, v in one["metrics"].items():
            assert abs(got["metrics"][k] - v) <= ITER_TOL, k
    for rank, r in enumerate(run["ranks"]):
        np.testing.assert_allclose(r["env"]["x"],
                                   one["x"][rank * E // 2:(rank + 1) * E // 2],
                                   rtol=0, atol=ITER_TOL)
    a, b = (r["env"]["net"] for r in run["ranks"])
    assert _max_diff(a, b) == 0.0     # the ranks agree exactly


def test_model_sharded_net_matches_unsharded(run):
    """2 ranks on 'model': fc1 split by output, fc2 by input. The forward
    and the gathered gradients equal the unsharded net's within 1e-12, one
    iteration within 1e-10, with the float32 layers unchanged to the bit."""
    for r in run["ranks"]:
        assert r["model_shapes"]["fc1.weight"] == (16, 18)
        assert r["model_shapes"]["fc2.weight"] == (32, 16)
        assert r["model_shapes"]["fc2.bias"] == (32,)
        for g, w in zip(r["model_forward"], run["forward"]):
            np.testing.assert_allclose(g, w, rtol=0, atol=MODEL_TOL)
        for k, w in run["grads"].items():
            np.testing.assert_allclose(r["model_grads"][k], w, rtol=0,
                                       atol=MODEL_TOL, err_msg=k)
        assert _max_diff(r["model"]["net"], run["one"]["net"]) <= ITER_TOL
        dense = {k: v for k, v in r["model"]["net"]["params"].items()
                 if k != "pi_log_std"}
        assert _max_diff(dense, run["one"]["net"]["params"]) == 0.0
        for k, v in run["one"]["metrics"].items():
            assert abs(r["model"]["metrics"][k] - v) <= ITER_TOL, k


def test_actor_critic_from_flax_under_mesh(run):
    """``actor_critic_from_flax`` takes the full flax tree under a 'model'
    mesh, keeps its slice, and computes the flax forward."""
    for r in run["ranks"]:
        for g, w in zip(r["from_flax"], run["flax_out"]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def test_ppo_train_step_sharded(run):
    """tests/test_ppo.py::test_ppo_train_step_sharded: a sharded train
    step gives finite metrics, moves the parameters and leaves the env
    batch sharded."""
    for r in run["ranks"]:
        got = r["env"]
        assert all(np.isfinite(v) for v in got["metrics"].values())
        assert got["changed"], "parameters did not update"
        assert got["x"].shape == (E // 2, 1, 7)
