"""PyTorch port: the PPO learner (parallel/ppo.py) against the JAX package.

The flax net's weights are carried across with
``convert.actor_critic_from_flax``; every comparison runs in float64 (the
suite's x64) on the same inputs, made from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.parallel import ppo as jppo
from f1tenth_gym_tpu.parallel import vector as jvec
from f1tenth_gym_tpu.tracks.synthetic import ring_map_data as j_ring
from f1tenth_gym_tpu.tracks.synthetic import ring_start_poses
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
from f1tenth_gym_tpu_torch.parallel import ppo as pppo
from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data as p_ring
from f1tenth_gym_tpu_torch.utils import convert

F32_RTOL, F64_RTOL = 1e-6, 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _leaves(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if v is not None}


def _flax_params(hidden, obs_dim, seed=0):
    net = jppo.ActorCritic(hidden=hidden)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)))
    return net, params, jax.tree.map(np.asarray, params)


def _named(np_params):
    """flax leaves by the port's parameter names."""
    p = np_params["params"]
    out = {"pi_log_std": p["pi_log_std"]}
    for layer in ("fc1", "fc2", "pi_mean", "vf"):
        out[f"{layer}.weight"] = p[layer]["kernel"].T
        out[f"{layer}.bias"] = p[layer]["bias"]
    return out


def _assert_leaves(got, want, what):
    for k, w in want.items():
        rtol = F64_RTOL if w.dtype == np.float64 else F32_RTOL
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=1e-12,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("hidden,obs_dim", [(32, 18), (256, 66)])
def test_actor_critic_forward_matches_flax(hidden, obs_dim):
    jnet, params, np_params = _flax_params(hidden, obs_dim)
    net = convert.actor_critic_from_flax(np_params, device="cpu")
    x = np.random.default_rng(1).normal(size=(5, 3, obs_dim))
    want = jnet.apply(params, jnp.asarray(x))
    got = net(torch.as_tensor(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-12)
    back = convert.actor_critic_to_numpy(net)
    jax.tree.map(np.testing.assert_array_equal, back, np_params)


def test_featurize_logp_scale_actions():
    rng = np.random.default_rng(2)
    E, A, B = 3, 2, 1080
    obs = {"scans": rng.uniform(0.1, 30.0, (E, A, B)),
           "linear_vels_x": rng.normal(0, 3, (E, A)),
           "ang_vels_z": rng.normal(0, 1, (E, A))}
    jt = J.make_scan_tables(num_beams=B, dtype=jnp.float64)
    pt = P.make_scan_tables(num_beams=B, dtype=torch.float64, device="cpu")
    want = jppo.featurize({k: jnp.asarray(v) for k, v in obs.items()}, jt, 64)
    got = pppo.featurize({k: torch.as_tensor(v) for k, v in obs.items()}, pt,
                         64)
    assert got.shape == (E, A, 66)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)

    mean, log_std, act = (rng.normal(size=(E, A, 2)) for _ in range(3))
    np.testing.assert_allclose(
        pppo.gaussian_logp(*map(torch.as_tensor, (mean, log_std, act))).numpy(),
        np.asarray(jppo.gaussian_logp(*map(jnp.asarray, (mean, log_std, act)))),
        rtol=0, atol=1e-12)

    # per-agent limits: each leaf (A,)
    leaves = _leaves(J.VehicleParams.create(dtype=jnp.float64))
    leaves = {k: np.full(A, v) for k, v in leaves.items()}
    leaves["s_min"] = np.array([-0.3, -0.5])
    leaves["s_max"] = np.array([0.45, 0.2])
    leaves["v_max"] = np.array([12.0, 20.0])
    jp = J.VehicleParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    pp = convert.vehicle_params_from_jax(leaves, device="cpu")
    raw = rng.normal(0, 2, (E, A, 2))
    np.testing.assert_allclose(
        pppo.scale_actions(torch.as_tensor(raw), pp).numpy(),
        np.asarray(jppo.scale_actions(jnp.asarray(raw), jp)), rtol=0,
        atol=1e-12)


def _ppos(pc, cfg_kw=None):
    cfg_kw = dict(num_agents=2, num_beams=64, dtype="float64",
                  scan_noise=False, **(cfg_kw or {}))
    jp = jppo.PPO(None, None, None, J.SimConfig(**cfg_kw), 0.01, pc)
    pp = pppo.PPO(None, None, None, P.SimConfig(**cfg_kw), 0.01, pc,
                  device="cpu")
    return jp, pp


def test_gae_matches_jax():
    rng = np.random.default_rng(3)
    T, E, A = 7, 5, 2
    traj = {"value": rng.normal(size=(T, E, A)),
            "reward": rng.normal(size=(T, E, A)),
            "done": rng.uniform(size=(T, E)) < 0.2}
    v_last = rng.normal(size=(E, A))
    jp, pp = _ppos(pppo.PPOConfig())
    want = jp._gae({k: jnp.asarray(v) for k, v in traj.items()},
                   jnp.asarray(v_last))
    got = pp._gae({k: torch.as_tensor(v) for k, v in traj.items()},
                  torch.as_tensor(v_last))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def _batch(rng, net_apply, N, A, F):
    feats = rng.normal(size=(N, A, F))
    mean, log_std, _ = net_apply(feats)
    raw = mean + np.exp(log_std) * rng.normal(size=(N, A, 2))
    logp = np.asarray(jppo.gaussian_logp(jnp.asarray(mean),
                                         jnp.asarray(log_std),
                                         jnp.asarray(raw)))
    # old log-probs off the current ones, so that some ratios clip
    return {"feats": feats, "raw": raw,
            "logp": logp + rng.normal(0, 0.3, (N, A)),
            "adv": rng.normal(size=(N, A)), "ret": rng.normal(size=(N, A))}


def test_loss_and_grads_match_jax():
    pc = pppo.PPOConfig(hidden=32, obs_beams=16)
    jnet, params, np_params = _flax_params(32, 18)
    net = convert.actor_critic_from_flax(np_params, device="cpu")
    rng = np.random.default_rng(4)
    batch = _batch(rng, lambda x: [np.asarray(o) for o in jnet.apply(
        params, jnp.asarray(x))], 64, 2, 18)
    jp, pp = _ppos(pc)
    (jloss, jaux), jgrads = jax.value_and_grad(jp._loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, aux = pp._loss(net, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=1e-12)
    for k in ("pg", "vf", "ent"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=0,
                                   atol=1e-12)
    got = {k: p.grad.numpy() for k, p in net.named_parameters()}
    for k, g in got.items():
        assert g.dtype == (np.float64 if k == "pi_log_std" else np.float32), k
    _assert_leaves(got, _named(jax.tree.map(np.asarray, jgrads)), "grad")


def test_clipped_adam_matches_optax():
    """Three steps of optax.chain(clip_by_global_norm(0.5), adam(3e-4)):
    global norms 5.0 (clipped), 0.1 (left alone), 2.0 (clipped)."""
    pc = pppo.PPOConfig(hidden=32, obs_beams=16)
    _, params, np_params = _flax_params(32, 18, seed=5)
    net = convert.actor_critic_from_flax(np_params, device="cpu")
    opt = pppo.ClippedAdam(dict(net.named_parameters()), pc.lr,
                           pc.max_grad_norm)
    tx = optax.chain(optax.clip_by_global_norm(pc.max_grad_norm),
                     optax.adam(pc.lr))
    state = tx.init(params)
    rng = np.random.default_rng(6)
    for norm in (5.0, 0.1, 2.0):
        g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(p.dtype),
                         np_params)
        total = np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2))
                            for x in jax.tree.leaves(g)))
        g = jax.tree.map(lambda x: (x * (norm / total)).astype(x.dtype), g)
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
        for k, p in net.named_parameters():
            p.grad = torch.as_tensor(_named(g)[k]).clone()
        opt.step()
        got = {k: p.detach().numpy() for k, p in net.named_parameters()}
        _assert_leaves(got, _named(jax.tree.map(np.asarray, params)),
                       f"param, norm {norm}")
        # the moments carry the clip's scale, and with it the float32
        # partial sums of the global norm: float32's tolerance on every
        # leaf, taken of the leaf's largest moment, since the moving
        # averages cancel on some elements
        adam = state[1][0]
        for name, got in (("mu", opt.mu), ("nu", opt.nu)):
            want = _named({"params": jax.tree.map(
                np.asarray, getattr(adam, name)["params"])})
            for k, w in want.items():
                np.testing.assert_allclose(
                    got[k].numpy(), w, rtol=F32_RTOL,
                    atol=F32_RTOL * np.abs(w).max(), err_msg=f"{name} {k}")
    assert int(opt.count) == int(state[1][0].count) == 3


def test_init_dtypes_and_truncation():
    """flax's dtypes (float32 Dense params, sim-dtype log std) and its
    lecun_normal: |w| <= 2 sigma, sample std sqrt(1/fan_in)."""
    pc = pppo.PPOConfig()
    _, np_params = _flax_params(pc.hidden, pc.obs_beams + 2)[1:]
    cfg = P.SimConfig(num_agents=1, num_beams=64, dtype="float64",
                      scan_noise=False)
    pp = pppo.PPO(None, None, None, cfg, 0.01, pc, device="cpu")
    ts = pp.init(None, P.make_generator("cpu", 9))
    named = _named(np_params)
    for k, p in ts.net.named_parameters():
        assert str(p.dtype).split(".")[1] == named[k].dtype.name, k
        assert tuple(p.shape) == named[k].shape, k
    assert ts.net.pi_log_std.dtype == torch.float64
    assert torch.equal(ts.net.pi_log_std,
                       torch.full((2,), -0.5, dtype=torch.float64))
    for layer in (ts.net.fc1, ts.net.fc2, ts.net.pi_mean, ts.net.vf):
        w = layer.weight.detach().double()
        fan_in = w.shape[1]
        sigma = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert float(w.abs().max()) <= 2.0 * sigma * (1 + 1e-6)
        assert not layer.bias.any()
        if w.numel() > 10000:
            assert abs(float(w.std()) / np.sqrt(1.0 / fan_in) - 1) < 0.02
    # the same generator seed draws the same net
    again = pp.init(None, P.make_generator("cpu", 9))
    for a, b in zip(ts.net.parameters(), again.net.parameters()):
        assert torch.equal(a, b)


def _ring_setup(E=4, A=2, beams=64):
    jm = j_ring(size=128, radius=2.0, dtype=jnp.float64)
    pm = p_ring(size=128, radius=2.0, dtype=torch.float64, device="cpu")
    poses = np.stack([ring_start_poses(A, 2.0)] * E)
    poses[1, :, 2] += 0.6                          # heading off the corridor
    poses[E - 1, 1] = poses[E - 1, 0] + [0.1, 0.0, 0.2]  # overlapping spawn
    cfg_kw = dict(num_agents=A, num_beams=beams, dtype="float64",
                  scan_noise=False)
    jcfg, pcfg = J.SimConfig(**cfg_kw), P.SimConfig(**cfg_kw)
    jparams = J.VehicleParams.create(dtype=jnp.float64)
    pparams = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    jt = J.make_scan_tables(num_beams=beams, dtype=jnp.float64)
    pt = P.make_scan_tables(num_beams=beams, dtype=torch.float64, device="cpu")
    return jm, pm, poses, jcfg, pcfg, jparams, pparams, jt, pt


class _JMeanPPO(jppo.PPO):
    def _policy(self, net_params, key, feats):
        mean, log_std, value = self.net.apply(net_params, feats)
        return mean, jppo.gaussian_logp(mean, log_std, mean), value


class _PMeanPPO(pppo.PPO):
    def _policy(self, net, generator, feats):
        mean, log_std, value = net(feats)
        return mean, pppo.gaussian_logp(mean, log_std, mean), value


# exploration without a random stream: the same smooth function of the
# features in both packages, so that the ratios leave 1 and clip
_PHASE = np.array([0.0, 1.7])


class _JHashPPO(jppo.PPO):
    def _policy(self, net_params, key, feats):
        mean, log_std, value = self.net.apply(net_params, feats)
        noise = jnp.sin(jnp.sum(feats, -1, keepdims=True) * 37.0
                        + jnp.asarray(_PHASE))
        raw = mean + jnp.exp(log_std) * noise
        return raw, jppo.gaussian_logp(mean, log_std, raw), value


class _PHashPPO(pppo.PPO):
    def _policy(self, net, generator, feats):
        mean, log_std, value = net(feats)
        noise = torch.sin(feats.sum(-1, keepdim=True) * 37.0
                          + torch.as_tensor(_PHASE, dtype=feats.dtype))
        raw = mean + torch.exp(log_std) * noise
        return raw, pppo.gaussian_logp(mean, log_std, raw), value


def test_rollout_matches_jax_without_noise():
    """8 rollout steps, the policy noise forced to zero in both packages,
    4 envs x 2 agents on the ring, auto-reset to fixed poses (env 3 spawns
    overlapping, so it is done and reset on the first step)."""
    jm, pm, poses, jcfg, pcfg, jparams, pparams, jt, pt = _ring_setup()
    pc = pppo.PPOConfig(obs_beams=16, hidden=32, rollout_steps=8)
    jstates, *_ = jvec.batch_reset(jnp.asarray(poses),
                                   jax.random.split(jax.random.PRNGKey(0), 4),
                                   jparams, jm, jt, jcfg, 0.01)
    pstates = convert.sim_state_from_jax(_leaves(jstates), device="cpu")
    jstep = jvec.make_autoreset_step(jparams, jm, jt, jcfg, 0.01,
                                     reset_poses=jnp.asarray(poses))
    pstep = P.make_autoreset_step(pparams, pm, pt, pcfg, 0.01,
                                  reset_poses=torch.as_tensor(poses),
                                  device="cpu")
    jp = _JMeanPPO(jparams, jm, jt, jcfg, 0.01, pc, step_fn=jstep)
    pp = _PMeanPPO(pparams, pm, pt, pcfg, 0.01, pc, step_fn=pstep,
                   device="cpu")
    jts = jp.init(jstates, jax.random.PRNGKey(1))
    pts = pp.init(pstates, P.make_generator("cpu", 1))
    pts.net.load_state_dict(convert.actor_critic_from_flax(
        jax.tree.map(np.asarray, jts.net_params), device="cpu").state_dict())
    jts, jtraj, jv = jax.jit(jp.rollout)(jts)
    pts, ptraj, pv = pp.rollout(pts)
    assert bool(np.asarray(jtraj["done"]).any())
    for k in ("feats", "raw", "logp", "value", "reward"):
        assert ptraj[k].shape == jtraj[k].shape, k
        np.testing.assert_allclose(ptraj[k].numpy(), np.asarray(jtraj[k]),
                                   rtol=0, atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(ptraj["done"].numpy(),
                                  np.asarray(jtraj["done"]))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=1e-9)
    np.testing.assert_allclose(pts.env_states.x.numpy(),
                               np.asarray(jts.env_states.x), rtol=0, atol=1e-9)


@pytest.mark.parametrize("policy", ["mean", "hashed"])
def test_train_step_matches_jax(policy):
    """Whole iterations with one minibatch (so the permutation only
    reorders a mean): rollout, GAE, normalization, two epochs of clipped
    Adam, against the JAX package's train_step. The policy acts with its
    mean, or with the same deterministic exploration in both packages
    (``_PHashPPO``), under which the old log-probs part from the new and
    the PPO clip acts."""
    jm, pm, poses, jcfg, pcfg, jparams, pparams, jt, pt = _ring_setup()
    jcls, pcls = {"mean": (_JMeanPPO, _PMeanPPO),
                  "hashed": (_JHashPPO, _PHashPPO)}[policy]
    pc = pppo.PPOConfig(obs_beams=16, hidden=32, rollout_steps=8, epochs=2,
                        minibatches=1, lr=1e-3)
    jstates, *_ = jvec.batch_reset(jnp.asarray(poses),
                                   jax.random.split(jax.random.PRNGKey(0), 4),
                                   jparams, jm, jt, jcfg, 0.01)
    pstates = convert.sim_state_from_jax(_leaves(jstates), device="cpu")
    jstep = jvec.make_autoreset_step(jparams, jm, jt, jcfg, 0.01,
                                     reset_poses=jnp.asarray(poses))
    pstep = P.make_autoreset_step(pparams, pm, pt, pcfg, 0.01,
                                  reset_poses=torch.as_tensor(poses),
                                  device="cpu")
    jp = jcls(jparams, jm, jt, jcfg, 0.01, pc, step_fn=jstep)
    pp = pcls(pparams, pm, pt, pcfg, 0.01, pc, step_fn=pstep,
                   device="cpu")
    jts = jp.init(jstates, jax.random.PRNGKey(1))
    pts = pp.init(pstates, P.make_generator("cpu", 1))
    pts.net.load_state_dict(convert.actor_critic_from_flax(
        jax.tree.map(np.asarray, jts.net_params), device="cpu").state_dict())
    step = jax.jit(jp.train_step)
    for it in range(3):
        jts, jmet = step(jts)
        pts, pmet = pp.train_step(pts)
        for k in ("loss", "mean_reward", "crash_rate"):
            np.testing.assert_allclose(float(pmet[k]), float(jmet[k]),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"iteration {it} {k}")
        got = _named(convert.actor_critic_to_numpy(pts.net))
        want = _named(jax.tree.map(np.asarray, jts.net_params))
        for k, w in want.items():
            # float32 params after 2 Adam steps an iteration: the f32
            # rounding of each step compounds
            np.testing.assert_allclose(got[k], w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"iteration {it} {k}")
        np.testing.assert_allclose(pts.env_states.x.numpy(),
                                   np.asarray(jts.env_states.x), rtol=0,
                                   atol=1e-9)


def test_ppo_learning_improves_reward():
    """tests/test_ppo.py::test_ppo_learning_improves_reward on the port:
    on a fixed seed the mean shaped reward improves over training, per
    agent (2 agents), with auto-reset to the start poses. Whether the last
    four iterations beat the first four depends on when the cars crash,
    so on the seed, in both packages, which draw different random
    streams; given the same exploration the two learners train alike
    (test_train_step_matches_jax, "hashed")."""
    _, pm, poses, _, pcfg, _, pparams, _, pt = _ring_setup(E=16)
    poses = np.stack([ring_start_poses(2, 2.0)] * 16)
    states, *_ = P.batch_reset(torch.as_tensor(poses), pparams, pm, pt, pcfg,
                               0.01, device="cpu")
    astep = P.make_autoreset_step(pparams, pm, pt, pcfg, 0.01,
                                  reset_poses=torch.as_tensor(poses),
                                  device="cpu")
    ppo = pppo.PPO(pparams, pm, pt, pcfg, 0.01,
                   pppo.PPOConfig(obs_beams=16, hidden=32, rollout_steps=8,
                                  epochs=2, minibatches=2, lr=1e-3),
                   step_fn=astep, device="cpu")
    ts = ppo.init(states, P.make_generator("cpu", 9))
    rewards = []
    for _ in range(20):
        ts, metrics = ppo.train_step(ts)
        assert np.isfinite(float(metrics["loss"]))
        rewards.append(float(metrics["mean_reward"]))
    early = np.mean(rewards[:4])
    late = np.mean(rewards[-4:])
    assert late > early, f"no learning: early {early:.4f} late {late:.4f}"


def test_train_step_kernel_engine(monkeypatch):
    """One train_step with the kernel engine on a map with a segment
    table: on the CPU the PPO path runs the kernel's plain version, once
    a rollout step; the parameters change and the metrics are finite."""
    calls = []
    plain = sk.sweep_plain
    monkeypatch.setattr(sk, "sweep_plain",
                        lambda w: calls.append(1) or plain(w))
    m = p_ring(size=128, radius=2.0, extract_segments=True, device="cpu")
    cfg = P.SimConfig(num_agents=1, num_beams=256, scan_engine="pallas")
    params = P.VehicleParams.create(device="cpu")
    tables = P.make_scan_tables(num_beams=256, device="cpu")
    poses = torch.as_tensor(np.stack([ring_start_poses(1, 2.0)] * 4))
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               device="cpu")
    pc = pppo.PPOConfig(obs_beams=16, hidden=32, rollout_steps=3, epochs=1,
                        minibatches=2)
    ppo = pppo.PPO(params, m, tables, cfg, 0.01, pc, device="cpu")
    ts = ppo.init(states, P.make_generator("cpu", 3))
    before = [p.detach().clone() for p in ts.net.parameters()]
    calls.clear()
    ts, metrics = ppo.train_step(ts)
    assert len(calls) == pc.rollout_steps
    assert sk.sweep.launches == 0  # no kernel launch on the CPU
    for k in ("loss", "mean_reward", "crash_rate"):
        assert np.isfinite(float(metrics[k])), k
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, ts.net.parameters()))
    sc = ts.env_states.scans
    assert sc.dtype == torch.float32 and bool(torch.isfinite(sc).all())


@pytest.mark.parametrize("entry", ["PPO", "ActorCritic",
                                   "actor_critic_from_flax",
                                   "PurePursuitPlanner", "F110VectorEnv"])
def test_default_device_raises_without_cuda(entry):
    """The new entry points default to the card and refuse to fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from f1tenth_gym_tpu_torch.envs import F110VectorEnv
    from f1tenth_gym_tpu_torch.planning import PurePursuitPlanner

    cfg = P.SimConfig(num_agents=1, num_beams=16, scan_noise=False)
    calls = {
        "PPO": lambda: pppo.PPO(None, None, None, cfg, 0.01),
        "ActorCritic": lambda: pppo.ActorCritic(18, 32),
        "actor_critic_from_flax": lambda: convert.actor_critic_from_flax(
            _flax_params(8, 4)[2]),
        "PurePursuitPlanner": lambda: PurePursuitPlanner(np.zeros((4, 3))),
        "F110VectorEnv": lambda: F110VectorEnv(num_envs=2, num_beams=16),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_train_state_is_a_dataclass_of_the_learner():
    cfg = P.SimConfig(num_agents=1, num_beams=64, dtype="float64",
                      scan_noise=True)
    pp = pppo.PPO(None, None, None, cfg, 0.01, pppo.PPOConfig(hidden=8),
                  device="cpu")
    gen = P.make_generator("cpu", 4)
    ts = pp.init(None, gen)
    assert [f.name for f in dataclasses.fields(ts)] == [
        "net", "opt", "env_states", "generator", "env_generator"]
    assert ts.generator is gen and ts.env_generator is pp.env_generator


def test_train_ppo_entry_point(tmp_path, capsys):
    """``python -m f1tenth_gym_tpu_torch.train_ppo`` on the CPU at a small
    size: --metrics-out, --save, then --restore of both that file and a
    JAX ``save_pytree(ts.net_params)`` file."""
    from f1tenth_gym_tpu.utils.checkpoint import save_pytree as j_save
    from f1tenth_gym_tpu_torch import train_ppo
    from f1tenth_gym_tpu_torch.utils.checkpoint import load_pytree
    from f1tenth_gym_tpu_torch.utils.metrics import read_jsonl

    small = ["--device", "cpu", "--envs", "4", "--iters", "2", "--beams",
             "64", "--engine", "march"]
    out = tmp_path / "policy"
    train_ppo.main(small + ["--save", str(out), "--metrics-out",
                            str(tmp_path / "m.jsonl")])
    rows = read_jsonl(str(tmp_path / "m.jsonl"))
    assert [r["iter"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in rows)
    saved = load_pytree(str(out) + ".npz")
    assert saved["['params']['fc1']['kernel']"].shape == (66, 256)
    train_ppo.main(small + ["--iters", "0", "--restore", str(out) + ".npz"])
    # what examples/train_ppo.py saves on a TPU, where x64 is off: every
    # leaf in float32
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          _flax_params(256, 66, seed=3)[1])
    jfile = j_save(str(tmp_path / "jax_policy"), params)
    train_ppo.main(small + ["--iters", "0", "--restore", jfile])
    assert capsys.readouterr().out.count("restored policy from") == 2
