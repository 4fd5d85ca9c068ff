"""PyTorch port: the reference-compatible F110Env (envs/gym_api.py).

Mirrors tests/test_env.py:35-73 and holds the port's F110Env to the JAX
package's over ten steps in float64 without noise (both step the marching
engine on the CPU: 1e-9, the parity tests' bar), both started from the
same numbers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.envs import F110Env as JEnv
from f1tenth_gym_tpu.tracks.synthetic import ring_start_poses
from f1tenth_gym_tpu_torch.envs import GYMNASIUM_ID, F110Env
from f1tenth_gym_tpu_torch.tracks.synthetic import ring_track_bitmap
from f1tenth_gym_tpu_torch.utils import convert

RADIUS = 8.0
NB = 60
OBS_KEYS = ("scans", "poses_x", "poses_y", "poses_theta", "linear_vels_x",
            "linear_vels_y", "ang_vels_z", "collisions", "lap_times",
            "lap_counts")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ring_path(tmp_path_factory):
    """The ring track as a ROS map yaml + PNG pair."""
    d = tmp_path_factory.mktemp("ring")
    bitmap, res, origin = ring_track_bitmap(size=512, radius=RADIUS)
    Image.fromarray(np.flipud(bitmap).astype(np.uint8)).save(d / "ring.png")
    with open(d / "ring.yaml", "w") as f:
        yaml.safe_dump({"image": "ring.png", "resolution": res,
                        "origin": list(origin)}, f)
    return str(d / "ring")


def _env(ring_path, **kw):
    args = dict(map=ring_path, map_ext=".png", num_agents=2, num_beams=NB,
                timestep=0.01, integrator="rk4", dtype="float64",
                device="cpu")
    args.update(kw)
    return F110Env(**args)


def test_wrapper_api(ring_path):
    """F110Env reset/step round-trip through numpy with the reference API."""
    env = _env(ring_path)
    poses = ring_start_poses(2, RADIUS)
    obs, reward, done, info = env.reset(poses)
    assert isinstance(obs["scans"], np.ndarray) and obs["scans"].shape == (2, NB)
    assert obs["ego_idx"] == 0 and reward == 0.01 and not done
    for _ in range(10):
        obs, reward, done, info = env.step(np.array([[0.0, 2.0], [0.0, 2.0]]))
    assert obs["poses_x"].shape == (2,)
    assert not done
    assert "checkpoint_done" in info and info["checkpoint_done"].shape == (2,)
    assert env.current_time == pytest.approx(0.11)
    assert set(env.render_obs) == {"ego_idx", "poses_x", "poses_y",
                                   "poses_theta", "lap_times", "lap_counts"}
    env.update_params({"v_max": 5.0})
    assert float(env.params.v_max.max()) == 5.0
    env.update_params({"v_max": 7.0}, index=1)
    assert env.params.v_max.tolist() == [5.0, 7.0]
    with pytest.raises(ValueError, match="poses shape"):
        env.reset(np.zeros((3, 3)))


def test_matches_jax_env(ring_path):
    kw = dict(map=ring_path, map_ext=".png", num_agents=2, num_beams=NB,
              dtype="float64", scan_noise=False)
    jenv = JEnv(**kw)
    env = F110Env(device="cpu", **kw)
    # the same numbers in both: the JAX env's params and tables
    env.params = convert.vehicle_params_from_jax(
        {k: np.asarray(v) for k, v in vars(jenv.params).items()}, "cpu")
    env.tables = convert.scan_tables_from_jax(
        {k: np.asarray(v) for k, v in vars(jenv.tables).items()}, "cpu")
    poses = ring_start_poses(2, RADIUS, spacing=1.5)
    rng = np.random.default_rng(0)
    acts = np.stack([rng.uniform(-0.3, 0.3, (10, 2)),
                     rng.uniform(1.0, 5.0, (10, 2))], -1)
    pairs = [(env.reset(poses), jenv.reset(poses))]
    pairs += [(env.step(a), jenv.step(a)) for a in acts]
    for t, (got, want) in enumerate(pairs):
        for k in OBS_KEYS:
            np.testing.assert_allclose(got[0][k], want[0][k], rtol=0,
                                       atol=1e-9, err_msg=f"step {t} {k}")
        assert got[1:3] == want[1:3]
        np.testing.assert_array_equal(got[3]["checkpoint_done"],
                                      want[3]["checkpoint_done"])
    assert env.current_time == pytest.approx(jenv.current_time, abs=1e-12)


def test_update_params_per_agent_matches_jax():
    pp = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    jp = J.VehicleParams.create(dtype=jnp.float64)
    with pytest.raises(ValueError, match="Per-agent"):
        pp.replace_params({"mu": 0.5}, agent_idx=0)
    pp = P.VehicleParams(**{k: v.expand(3).clone() for k, v in vars(pp).items()})
    jp = jp.replace(**{k: jnp.broadcast_to(v, (3,))
                       for k, v in vars(jp).items()})
    upd = {"mu": 0.7, "m": 4.0}
    got = pp.replace_params(upd, agent_idx=2).replace_params({"h": 0.08})
    want = jp.replace_params(upd, agent_idx=2).replace_params({"h": 0.08})
    for k in vars(got):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    assert pp.mu.tolist() == [1.0489] * 3   # the original is unchanged


def test_same_seed_resets_repeat_the_noise(ring_path):
    env = _env(ring_path, dtype="float32", seed=9)
    poses = ring_start_poses(2, RADIUS)
    act = np.array([[0.1, 3.0], [0.0, 2.0]])
    runs = []
    for _ in range(2):
        seq = [env.reset(poses)[0]["scans"]]
        seq += [env.step(act)[0]["scans"] for _ in range(3)]
        runs.append(np.stack(seq))
    np.testing.assert_array_equal(runs[0], runs[1])
    env.seed = 10
    other = env.reset(poses)[0]["scans"]
    assert not np.array_equal(other, runs[0][0])
    # shared-agent noise: both cars see the same noise vector
    clean = _env(ring_path, dtype="float32", scan_noise=False).reset(poses)[0]
    noise = runs[0][0] - clean["scans"]
    assert 0.005 < noise.std() < 0.02


@pytest.mark.parametrize("engine", ["segments", "pallas"])
def test_engines_step(ring_path, engine):
    """The segment-based engines load the map's segments and step; the
    JAX package's "pallas" is the port's "kernel"."""
    env = _env(ring_path, scan_engine=engine, dtype="float32")
    assert env.map_data.segments is not None
    assert env.cfg.scan_engine == ("kernel" if engine == "pallas" else engine)
    obs, *_ = env.reset(ring_start_poses(2, RADIUS))
    for _ in range(3):
        obs, *_ = env.step(np.array([[0.0, 2.0], [0.0, 2.0]]))
    assert np.isfinite(obs["scans"]).all() and obs["scans"].min() < 3.0
    env.update_map(ring_path, ".png")
    assert env.map_data.segments is not None


def test_render_points_at_the_roadmap(ring_path):
    """render() draws the last observation (P18's renderer): a headless
    frame for "rgb_array"; an unknown mode raises."""
    env = _env(ring_path)
    env.reset(ring_start_poses(2, RADIUS))
    with pytest.raises(ValueError, match="render mode"):
        env.render("bogus")
    frame = env.render("rgb_array")
    assert frame.shape == (800, 1000, 3) and frame.dtype == np.uint8
    env.close()
    assert env.renderer is None
    assert not _env(ring_path)._wants_segments()  # "auto" on the CPU: march


def test_gymnasium_env(ring_path):
    gymnasium = pytest.importorskip("gymnasium")
    assert GYMNASIUM_ID in gymnasium.registry
    assert GYMNASIUM_ID != "f1tenth_tpu/f110-v0"
    env = gymnasium.make(GYMNASIUM_ID, map=ring_path, num_agents=2,
                         num_beams=NB, device="cpu").unwrapped
    obs, info = env.reset(seed=3, options={"poses": ring_start_poses(2, RADIUS)})
    assert env.observation_space.contains(obs)
    for _ in range(3):
        obs, reward, terminated, truncated, info = env.step(
            np.array([[0.0, 2.0], [0.0, 2.0]], np.float32))
    assert env.observation_space.contains(obs)
    assert reward == pytest.approx(0.01) and not terminated and not truncated
    assert obs["scans"].dtype == np.float32
