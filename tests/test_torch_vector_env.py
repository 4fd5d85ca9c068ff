"""PyTorch port: the gymnasium ``VectorEnv`` adapter (envs/vector_env.py).

Mirrors tests/test_vector_env.py on ``device="cpu"``: 256 envs through the
``gymnasium.vector`` API, NEXT_STEP autoreset against the reference's
reset-is-a-zero-action-step convention (f110_env.py:337-338), the vector
entry point on the port's id, and the terminal-spawn fix. gymnasium is
optional for the port (the card's machine lacks it): without it the
module still imports.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

gymnasium = pytest.importorskip("gymnasium")

from f1tenth_gym_tpu_torch.envs.vector_env import F110VectorEnv  # noqa: E402
from f1tenth_gym_tpu_torch.maps import map_path  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def venv256():
    env = F110VectorEnv(num_envs=256, map=map_path("compact"),
                        num_agents=2, num_beams=108, scan_engine="march",
                        dtype="float32", seed=5, device="cpu")
    yield env
    env.close()


def test_vector_spaces_and_reset(venv256):
    env = venv256
    assert env.num_envs == 256
    assert env.action_space.shape == (256, 2, 2)
    assert env.single_observation_space["scans"].shape == (2, 108)
    obs, info = env.reset()
    assert set(obs) >= {"scans", "poses_x", "collisions", "lap_counts"}
    assert obs["scans"].shape == (256, 2, 108)
    assert obs["scans"].dtype == np.float32
    assert obs in env.observation_space
    # the same seed resets to the same observation, noise included
    again, _ = env.reset(seed=5)
    for k in obs:
        np.testing.assert_array_equal(again[k], obs[k], err_msg=k)


def test_vector_step_256(venv256):
    env = venv256
    obs, _ = env.reset()
    for _ in range(8):
        actions = np.zeros((256, 2, 2), np.float32)
        actions[..., 1] = 2.0  # drive forward
        obs, rewards, terminations, truncations, infos = env.step(actions)
    assert obs["scans"].shape == (256, 2, 108)
    assert rewards.shape == (256,)
    assert terminations.shape == (256,) and truncations.shape == (256,)
    assert np.all(rewards[~terminations] > 0)  # timestep reward
    # envs actually accelerated (~0.07 m/s per step from standstill)
    assert np.abs(obs["linear_vels_x"]).max() > 0.3


def test_vector_next_step_autoreset():
    """A terminated env's next step ignores the action and returns its
    start-grid observation (NEXT_STEP convention; reference reset
    semantics)."""
    # spawns aimed across the corridor -> quick wall hits
    poses = np.tile(np.array([[[-0.5, -9.5, 1.5708],
                               [-0.5, -8.3, 1.5708]]], np.float32), (8, 1, 1))
    env = F110VectorEnv(num_envs=8, map=map_path("compact"), num_agents=2,
                        num_beams=108, scan_engine="march", dtype="float32",
                        poses=poses, seed=1, device="cpu")
    obs0, _ = env.reset()
    a = np.zeros((8, 2, 2), np.float32)
    a[..., 1] = 6.0
    terminated = np.zeros(8, bool)
    for _ in range(400):
        obs, rew, term, trunc, _ = env.step(a)
        if term.any():
            terminated = term
            break
    assert terminated.any(), "no env terminated driving into a wall"
    # the step AFTER termination: reset obs at the start grid, zero reward
    obs1, rew1, term1, _, _ = env.step(a)
    i = int(np.flatnonzero(terminated)[0])
    assert not term1[i]
    assert rew1[i] == 0.0
    assert np.allclose(obs1["poses_x"][i], obs0["poses_x"][i], atol=1e-5)
    assert np.allclose(obs1["poses_y"][i], obs0["poses_y"][i], atol=1e-5)
    assert np.all(obs1["collisions"][i] == 0)
    env.close()


def test_vector_entry_point_registration():
    import f1tenth_gym_tpu_torch.envs as envs

    assert envs.register_gymnasium_vector()
    spec = gymnasium.registry.get(envs.GYMNASIUM_ID)
    assert spec is not None
    assert spec.vector_entry_point == (
        "f1tenth_gym_tpu_torch.envs.vector_env:F110VectorEnv")


def test_terminal_spawn_not_swallowed():
    """An env whose spawn state is itself terminal (overlapping start
    poses) must keep REPORTING terminations, alternating 1-step episodes,
    not fall silent after the first one."""
    poses = np.tile(np.array([[[0.7, 0.0, 1.37], [0.75, 0.0, 1.37]]],
                             np.float32), (4, 1, 1))  # overlapping pair
    env = F110VectorEnv(num_envs=4, map=map_path("compact"), num_agents=2,
                        num_beams=108, scan_engine="march",
                        dtype="float32", poses=poses, seed=2, device="cpu")
    env.reset(seed=2)
    a = np.zeros((4, 2, 2), np.float32)
    reports = []
    for _ in range(6):
        _, _, term, _, _ = env.step(a)
        reports.append(bool(term.any()))
    assert sum(reports) >= 3, (
        f"terminal-spawn terminations were swallowed: {reports}")
    env.close()


def test_vector_env_matches_jax():
    """The port's F110VectorEnv against the JAX package's on the same fixed
    poses and actions (compact, float64, march, no scan noise): every obs
    key, reward, termination and truncation at every step, through wall
    hits, their NEXT_STEP resets and an overlapping spawn that stays
    terminal (the pending mask)."""
    from f1tenth_gym_tpu.envs.vector_env import F110VectorEnv as JVectorEnv

    def wall(theta):  # the ego aimed at a wall, the other car parked
        return [[-0.5, -9.5, theta], [-0.5, -8.3, 1.5708]]

    poses = np.array([wall(1.5708), wall(-1.5708),
                      [[0.7, 0.0, 1.37], [0.75, 0.0, 1.37]],
                      [[0.7, 0.0, 1.37], [0.7, -1.0, 1.37]]])
    kw = dict(num_envs=4, map=map_path("compact"), num_agents=2,
              num_beams=108, scan_engine="march", dtype="float64",
              poses=poses, seed=3, scan_noise=False)
    jenv, penv = JVectorEnv(**kw), F110VectorEnv(device="cpu", **kw)
    jobs, _ = jenv.reset()
    pobs, _ = penv.reset()

    def same(j, p, what):
        assert set(p) == set(j), what
        for k in j:
            assert p[k].dtype == j[k].dtype == np.float64, (what, k)
            np.testing.assert_allclose(p[k], j[k], rtol=0, atol=1e-9,
                                       err_msg=f"{what}: {k}")

    same(jobs, pobs, "reset")
    a = np.zeros((4, 2, 2))
    a[:, :, 1] = [[6.0, 0.0], [6.0, 0.0], [0.0, 0.0], [2.0, 1.0]]
    a[3, :, 0] = 0.05
    seen = np.zeros(4, int)
    after = 0
    for t in range(200):
        jr = jenv.step(a)
        pr = penv.step(a)
        same(jr[0], pr[0], f"step {t}")
        for i, name in ((1, "rewards"), (2, "terminations"),
                        (3, "truncations")):
            assert pr[i].dtype == jr[i].dtype, name
            np.testing.assert_array_equal(pr[i], jr[i],
                                          err_msg=f"step {t}: {name}")
        seen += pr[2]
        if seen[0] >= 2 and seen[1] >= 2:
            after += 1
            if after > 5:
                break
    # both wall runs ended, were reset and ended again; the overlapping
    # spawn reported every other step
    assert seen[0] >= 2 and seen[1] >= 2, seen
    assert seen[2] >= (t + 1) // 2, (seen, t)
    jenv.close()
    penv.close()


def test_imports_without_gymnasium():
    """With gymnasium unimportable every env module imports, the vector
    env refuses to build and nothing is registered."""
    code = (
        "import sys\n"
        "sys.modules['gymnasium'] = None\n"
        "import f1tenth_gym_tpu_torch.envs as envs\n"
        "assert envs.register_gymnasium_vector() is False\n"
        "try:\n"
        "    envs.F110VectorEnv(num_envs=2, device='cpu')\n"
        "except ImportError as e:\n"
        "    print('refused', e)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("refused")
