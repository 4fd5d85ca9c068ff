"""PyTorch port: the learner (parallel/ppo.py) against the benchmark's plain
float64 reference (benchmark/reference/ppo.py), one iteration followed a
minibatch at a time from the learner's own state, under the learner cell's
limits (benchmark/traffic/ppo_4096.json), on the CPU at a small size.

The readings are the benchmark's own (``benchmark/ppo.py::Recorder`` and
``learner_readings``): the rollout's features, actions, log-probabilities,
values and rewards at two steps; each minibatch's loss and gradient from
the program's parameters before it; the clip and Adam from the program's
gradient and moments; the iteration's metrics. The reference in bfloat16 in
the program's place must fail every one of them, and so must a learner
with a fault.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import f1tenth_gym_tpu_torch as P
from benchmark import ppo as bppo
from benchmark import spec, worlds
from f1tenth_gym_tpu_torch.parallel import ppo as pppo
from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data, ring_start_poses

E, A, NB = 16, 2, 64
CHECKS = ("rollout_gap", "loss_gap", "grad_gap", "adam_gap", "metric_gap")
LIMITS = spec.load_traffic("ppo_4096")["limits"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ring():
    return ring_map_data(size=128, radius=2.0, extract_segments=True,
                         device="cpu")


def small_cfg():
    """The learner cell's configuration at 64 beams, a net of 32 hidden
    units over 16 pooled beams, 8 rollout steps and 2 x 2 minibatches. The
    scan engine is the march: the learner's check does not depend on it,
    and the kernel's plain version is the slowest engine on the CPU."""
    cfg = spec.cell(spec.load(), "dr16-ppo-4096")["config"]
    cfg.update(num_beams=NB, scan_engine="march")
    cfg["learner"].update(obs_beams=16, obs_dim=18, hidden=32,
                          rollout_steps=8, epochs=2, minibatches=2)
    return cfg


def checked_iteration(ring, seed, fault=None):
    """A learner on the ring from ``seed``: one iteration, then one more
    recorded by the benchmark's ``Recorder``. ``fault(ppo, ts)`` may alter
    the learner before the recorded iteration. Returns (cfg, recorder,
    metrics)."""
    cfg = small_cfg()
    noise_gen = P.make_generator("cpu", seed)
    _, params, tables, step = worlds.system(
        cfg, SimpleNamespace(map_data=ring), "cpu", noise_gen)
    sim = P.SimConfig(num_agents=A, num_beams=NB, scan_engine="march",
                      scan_noise=True, shared_agent_noise=True)
    poses = np.stack([ring_start_poses(A, 2.0)] * E)
    poses[:, :, 2] += np.linspace(-0.3, 0.3, E)[:, None]
    s, *_ = P.batch_reset(torch.as_tensor(poses, dtype=torch.float32),
                          params, ring, tables, sim, 0.01,
                          generator=noise_gen, device="cpu")

    def sort(states):   # a permutation, as the cell's sort is
        return states.map(lambda leaf: leaf.flip(0))

    rec = bppo.Recorder(sort, step, noise_gen, (0, 5))
    ppo = pppo.PPO(params, ring, tables, sim, 0.01,
                   bppo.ppo_config(pppo, cfg), step_fn=rec.step,
                   device="cpu", sort_fn=rec.sort)
    ts = ppo.init(s, P.make_generator("cpu", seed + 100))
    ts, _ = ppo.train_step(ts)
    if fault is not None:
        fault(ppo, ts)
    rec.arm(ppo, ts)
    ts, metrics = ppo.train_step(ts)
    rec.disarm()
    return cfg, rec, metrics


def readings(ring, seed, control=False, fault=None):
    cfg, rec, metrics = checked_iteration(ring, seed, fault)
    return bppo.learner_readings(cfg, rec, metrics, E, torch.device("cpu"),
                                 LIMITS, control)


@pytest.mark.parametrize("seed", [3, 2**31 + 7, 12345])
def test_learner_follows_the_reference(ring, seed):
    got = readings(ring, seed)
    for name in CHECKS:
        assert got["gaps"][name] <= LIMITS[name], (name, got["gaps"])
    assert got["failed"] == 0
    # every minibatch of the iteration was followed
    assert got["judged"] == 2 * E * 6 + 4 + 1


def test_bfloat16_control_fails_every_learner_check(ring):
    got = readings(ring, 3, control=True)
    for name in CHECKS:
        assert got["gaps"][name] > LIMITS[name], (name, got["gaps"])


def _adam_lr_off(ppo, ts):
    ts.opt.lr *= 1.01


def _advantages_not_normalized(ppo, ts):
    ppo._normalize = lambda advs: advs


def _noise_not_scaled(ppo, ts):
    policy = ppo._policy

    def unscaled(net, generator, feats):
        raw, logp, value = policy(net, generator, feats)
        return raw * 1.001, logp, value
    ppo._policy = unscaled


@pytest.mark.parametrize("fault,fails", [
    (_adam_lr_off, {"adam_gap"}),
    (_advantages_not_normalized, {"loss_gap", "grad_gap"}),
    (_noise_not_scaled, {"rollout_gap"})],
    ids=["adam_lr", "advantages", "policy_raw"])
def test_a_faulty_learner_fails_its_check(ring, fault, fails):
    got = readings(ring, 3, fault=fault)
    over = {k for k in CHECKS if got["gaps"][k] > LIMITS[k]}
    assert fails <= over, got["gaps"]


def test_reference_gae_and_adam_by_hand():
    """Two steps of GAE and one clipped Adam step worked out by hand."""
    from benchmark.reference import ppo as ref

    v = torch.tensor([[[1.0]], [[2.0]]], dtype=torch.float64)
    r = torch.tensor([[[0.5]], [[1.0]]], dtype=torch.float64)
    d = torch.tensor([[False], [True]])
    adv, ret = ref.gae(v, r, d, torch.tensor([[3.0]], dtype=torch.float64),
                       0.9, 0.5)
    # t=1 is done: delta = 1 - 2; t=0: delta = 0.5 + 0.9 * 2 - 1, plus
    # 0.9 * 0.5 * (-1)
    assert adv[:, 0, 0].tolist() == pytest.approx([1.3 - 0.45, -1.0])
    assert torch.equal(ret, adv + v)
    g = {k: torch.zeros(1, dtype=torch.float64) for k in ref.LEAVES}
    g["fc1.bias"] = torch.tensor([3.0], dtype=torch.float64)
    g["vf.bias"] = torch.tensor([4.0], dtype=torch.float64)
    zeros = {k: torch.zeros(1, dtype=torch.float64) for k in ref.LEAVES}
    change, mu, nu, norm = ref.clipped_adam(g, zeros, zeros, 0, 1e-3, 0.5)
    assert float(norm) == 5.0
    assert float(mu["fc1.bias"]) == pytest.approx(0.1 * 0.3)
    assert float(nu["vf.bias"]) == pytest.approx(0.001 * 0.4 ** 2)
    # the first Adam step moves each parameter by lr times its sign
    assert float(change["fc1.bias"]) == pytest.approx(-1e-3, rel=1e-6)
    assert float(change["fc2.bias"]) == 0.0


def test_reference_sets_tf32_off_and_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys, torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = True\n"
            "import benchmark.reference.ppo as r\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n"
            "print(sorted(m for m in sys.modules if m.startswith('f1tenth')"
            " or m.split('.')[0] in ('jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         text=True, capture_output=True, check=True)
    assert out.stdout.strip() == "[]"
