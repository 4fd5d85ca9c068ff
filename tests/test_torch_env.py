"""PyTorch port: env step/reset, auto-reset, locality sort, noise, devices.

Rollout fixtures at the JAX package's tolerances (tests/test_parity.py:
165-220, float64, marching engine, no noise); the batched auto-reset step
against JAX's at the kernel tolerance of test_torch_scan_kernel.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.maps import map_path
from f1tenth_gym_tpu.parallel import vector as jvec
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
from f1tenth_gym_tpu_torch.parallel import vector as pvec
from f1tenth_gym_tpu_torch.utils import convert

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _leaves(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if v is not None}


@pytest.mark.parametrize("name", ["rk4", "euler"])
def test_env_rollout_fixture(name):
    d = np.load(os.path.join(FIX, f"env_rollout_{name}.npz"))
    cfg = P.SimConfig(num_agents=2, integrator=name, scan_noise=False,
                      dtype="float64")
    params = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    m = P.load_map(map_path("example_map"), dtype=torch.float64, device="cpu")
    tables = P.make_scan_tables(dtype=torch.float64, device="cpu")
    state, *_ = P.batch_reset(torch.as_tensor(d["poses"])[None], params, m,
                              tables, cfg, 0.01, device="cpu")
    actions = torch.as_tensor(d["actions"])
    for t in range(actions.shape[0]):
        state, obs, reward, done, _ = P.batch_step(
            state, actions[t][None], params, m, tables, cfg, 0.01)
        for k in ("poses_x", "poses_y", "poses_theta", "linear_vels_x",
                  "ang_vels_z"):
            np.testing.assert_allclose(obs[k][0].numpy(), d[k][t], rtol=1e-8,
                                       atol=1e-8, err_msg=f"step {t} {k}")
        np.testing.assert_array_equal(obs["collisions"][0].numpy(),
                                      d["collisions"][t])
        for a in (0, 1):
            np.testing.assert_allclose(obs["scans"][0, a].numpy(),
                                       d[f"scans{a}"][t], rtol=1e-6,
                                       atol=1e-6, err_msg=f"step {t} scan{a}")
        assert bool(done[0]) == bool(d["done"][t]), f"step {t} done"
        assert abs(float(reward[0]) - d["reward"][t]) < 1e-12
        np.testing.assert_allclose(obs["lap_times"][0].numpy(),
                                   d["lap_times"][t], atol=1e-9)
        np.testing.assert_array_equal(obs["lap_counts"][0].numpy(),
                                      d["lap_counts"][t])


def test_autoreset_step_matches_jax_kernel_vs_pallas():
    """4 envs x 2 agents on the ring, 256 beams, no noise: the port's
    kernel engine (plain version on the CPU) against JAX's Pallas engine
    (interpret mode). Env 3 spawns overlapping, so it is done at once and
    auto-resets to its start grid on the first step."""
    from f1tenth_gym_tpu.tracks.synthetic import ring_map_data as j_ring
    from f1tenth_gym_tpu.tracks.synthetic import ring_start_poses
    from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data as p_ring

    NB = 256
    jm = j_ring(size=256, radius=4.0, dtype=jnp.float32, extract_segments=True)
    pm = p_ring(size=256, radius=4.0, extract_segments=True, device="cpu")
    jt = J.make_scan_tables(num_beams=NB, dtype=jnp.float32)
    pt = P.make_scan_tables(num_beams=NB, device="cpu")
    jp = J.VehicleParams.create(dtype=jnp.float32)
    pp = P.VehicleParams.create(device="cpu")
    jcfg = J.SimConfig(num_agents=2, num_beams=NB, scan_engine="pallas",
                       scan_noise=False)
    pcfg = P.SimConfig(num_agents=2, num_beams=NB, scan_engine="kernel",
                       scan_noise=False)
    poses = np.stack([ring_start_poses(2, 4.0)] * 4)
    poses[1] = ring_start_poses(2, 4.0, spacing=1.5)
    poses[1, :, 2] += 0.5                      # heading off the corridor
    poses[2, :, :2] *= -1.0
    poses[3, 1] = poses[3, 0] + [0.1, 0.0, 0.2]  # overlapping spawn
    poses = poses.astype(np.float32)
    jstates, *_ = jvec.batch_reset(jnp.asarray(poses),
                                   jax.random.split(jax.random.PRNGKey(0), 4),
                                   jp, jm, jt, jcfg, 0.01)
    pstates = convert.sim_state_from_jax(_leaves(jstates), device="cpu")
    jstep = jvec.make_autoreset_step(jp, jm, jt, jcfg, 0.01,
                                     reset_to_start=True)
    pstep = P.make_autoreset_step(pp, pm, pt, pcfg, 0.01, reset_to_start=True,
                                  device="cpu")
    rng = np.random.default_rng(0)
    dones = 0
    for t in range(4):
        act = np.stack([rng.uniform(-0.4, 0.4, (4, 2)),
                        rng.uniform(1.0, 6.0, (4, 2))], -1).astype(np.float32)
        jstates, jobs, _, jdone, _ = jstep(jstates, jnp.asarray(act))
        pstates, pobs, _, pdone, _ = pstep(pstates, torch.as_tensor(act))
        np.testing.assert_array_equal(pdone.numpy(), np.asarray(jdone))
        dones += int(pdone.sum())
        err = np.abs(pobs["scans"].numpy() - np.asarray(jobs["scans"]))
        assert np.median(err) < 1e-5 and np.percentile(err, 99.9) < 1e-3, t
        for k in ("x", "start_xs", "start_ys", "current_time"):
            np.testing.assert_allclose(getattr(pstates, k).numpy(),
                                       np.asarray(getattr(jstates, k)),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        for k in ("collisions", "steps", "near_starts", "toggle_list"):
            np.testing.assert_array_equal(getattr(pstates, k).numpy(),
                                          np.asarray(getattr(jstates, k)))
        np.testing.assert_array_equal(pstates.scans.numpy()[pdone.numpy()],
                                      0.0)  # reset envs carry zero scans
    assert dones >= 1


@pytest.mark.parametrize("tile_size", [None, 1.5])
def test_sort_envs_for_locality_matches_jax(tile_size):
    rng = np.random.default_rng(6)
    E = 48
    xy = np.round(rng.uniform(-6.0, 6.0, (E, 2, 2)) * 2.0) / 2.0  # key ties
    poses = np.concatenate([xy, rng.uniform(0, 6, (E, 2, 1))], -1)
    jcfg = J.SimConfig(num_agents=2, num_beams=16, dtype="float64")
    pcfg = P.SimConfig(num_agents=2, num_beams=16, dtype="float64")
    js = jax.vmap(lambda p: J.init_state(p, jax.random.PRNGKey(0), jcfg))(
        jnp.asarray(poses))
    ps = P.init_state(torch.as_tensor(poses), pcfg)
    kw = {} if tile_size is None else dict(tile_size=tile_size,
                                           origin=(-6.3, -6.1))
    want = jvec.sort_envs_for_locality(js, **kw)
    got = pvec.sort_envs_for_locality(ps, **kw)
    for k in ("x", "start_xs", "start_rot", "scans"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)


def test_scan_noise_statistics():
    """Mirror of test_components.py::test_scan_noise_statistics: zero mean,
    sigma 0.01, the same vector for both agents of an env, independent
    across beams and steps. Noise = noisy minus clean scans of stationary
    cars on opposite sides of the ring (walls hide the opponent)."""
    from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data

    m = ring_map_data(size=256, radius=4.0, dtype=torch.float64, device="cpu")
    params = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    tables = P.make_scan_tables(num_beams=108, dtype=torch.float64,
                                device="cpu")
    cfg_on = P.SimConfig(num_agents=2, num_beams=108, dtype="float64")
    cfg_off = P.SimConfig(num_agents=2, num_beams=108, dtype="float64",
                          scan_noise=False)
    E = 16
    poses = torch.tensor([[4.0, 0.0, 1.5708], [-4.0, 0.0, -1.5708]],
                         dtype=torch.float64).expand(E, 2, 3)
    gen = P.make_generator("cpu", seed=7)
    s_on, *_ = P.batch_reset(poses, params, m, tables, cfg_on, 0.01,
                             generator=gen, device="cpu")
    s_off, *_ = P.batch_reset(poses, params, m, tables, cfg_off, 0.01,
                              device="cpu")
    actions = torch.zeros((E, 2, 2), dtype=torch.float64)
    noises = []
    for _ in range(32):
        s_on, o_on, *_ = P.batch_step(s_on, actions, params, m, tables,
                                      cfg_on, 0.01, gen)
        s_off, o_off, *_ = P.batch_step(s_off, actions, params, m, tables,
                                        cfg_off, 0.01)
        noises.append((o_on["scans"] - o_off["scans"]).numpy())
    noise = np.stack(noises, 1)  # (E, T, A, B)
    np.testing.assert_allclose(noise[..., 0, :], noise[..., 1, :], atol=1e-12,
                               rtol=0)
    n = noise[..., 0, :]
    flat = n.ravel()
    sigma = 0.01
    assert abs(flat.mean()) < 5 * sigma / np.sqrt(flat.size), flat.mean()
    assert abs(flat.std() / sigma - 1.0) < 0.03, flat.std()
    assert np.abs(flat).max() < 6 * sigma
    c_beam = np.corrcoef(n[..., :-1].ravel(), n[..., 1:].ravel())[0, 1]
    assert abs(c_beam) < 0.05, c_beam
    c_step = np.corrcoef(n[:, :-1].ravel(), n[:, 1:].ravel())[0, 1]
    assert abs(c_step) < 0.05, c_step
    c_env = np.corrcoef(n[:-1].ravel(), n[1:].ravel())[0, 1]
    assert abs(c_env) < 0.05, c_env


def test_pose_sampler_grouped_aligned_component():
    """Mirror of test_env.py::test_pose_sampler_grouped_aligned_component."""
    from scipy import ndimage

    m = P.load_map(map_path("example_map"), dtype=torch.float64, device="cpu")
    s = P.uniform_pose_sampler(m, clearance=0.6, component_seed=(0.7, 0.0),
                               grouped=True, align_theta=True)
    p = s(P.make_generator("cpu", 3), (256, 2)).numpy()
    assert p.shape == (256, 2, 3)
    d = np.hypot(*(p[:, 0, :2] - p[:, 1, :2]).T)
    assert d.min() >= 0.79 and d.max() <= 2.01, (d.min(), d.max())
    assert (np.cos(p[:, 0, 2] - p[:, 1, 2]) > 0.0).all()
    dt = m.dt.numpy()
    res = float(m.resolution)
    lab, _ = ndimage.label(dt > 0.6)
    want = lab[int((0.0 - float(m.orig_y)) / res),
               int((0.7 - float(m.orig_x)) / res)]
    rows = ((p[..., 1].ravel() - float(m.orig_y)) / res).astype(int)
    cols = ((p[..., 0].ravel() - float(m.orig_x)) / res).astype(int)
    assert (lab[rows, cols] == want).all()


@pytest.mark.parametrize("entry", [
    "load_map", "make_scan_tables", "VehicleParams.create", "batch_reset",
    "make_autoreset_step", "scan", "make_generator"])
def test_default_device_raises_without_cuda(entry):
    """Entry points default to the card and refuse to fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    m = P.load_map(map_path("compact"), extract_segments=True, device="cpu")
    t = P.make_scan_tables(num_beams=16, device="cpu")
    pp = P.VehicleParams.create(device="cpu")
    cfg = P.SimConfig(num_beams=16, scan_noise=False)
    calls = {
        "load_map": lambda: P.load_map(map_path("compact")),
        "make_scan_tables": lambda: P.make_scan_tables(),
        "VehicleParams.create": lambda: P.VehicleParams.create(),
        "batch_reset": lambda: P.batch_reset(torch.zeros(1, 2, 3), pp, m, t,
                                             cfg, 0.01),
        "make_autoreset_step": lambda: P.make_autoreset_step(
            pp, m, t, cfg, 0.01, reset_to_start=True),
        "scan": lambda: sk.scan(torch.zeros(8, 3), m, t, 16, 2000),
        "make_generator": lambda: P.make_generator(None),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
