"""PyTorch port: per-env vehicle params, the experiment yaml, the renderer
and the examples (state.py, utils/experiment.py, render/renderer.py,
envs/gym_api.py::render, f1tenth_gym_tpu_torch/examples/).

* A step with (E, 1) params leaves equals the JAX package's ``vmap`` over
  per-env params (float64, march, 108 beams, no noise), as
  ``examples/param_sweep.py`` steps it.
* ``load_experiment_config`` gives the JAX one's attributes, on the
  example yaml and on PyYAML's edge cases.
* The headless renderer's frame and ``F110Env.render("rgb_array")`` equal
  the JAX package's on the same map and poses.
* Each example runs to completion at a tiny size on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.core.env import env_reset as j_reset
from f1tenth_gym_tpu.core.env import env_step as j_step
from f1tenth_gym_tpu.maps import map_path
from f1tenth_gym_tpu.utils import experiment as JX
from f1tenth_gym_tpu_torch.utils import convert
from f1tenth_gym_tpu_torch.utils import experiment as PX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "examples", "config_example_map.yaml")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _leaves(obj):
    return {k: np.asarray(v) for k, v in vars(obj).items() if v is not None}


def test_per_env_params_step_matches_jax_vmap():
    """E envs, each with its own mass, lf, width and length (collision boxes
    and dynamics), stepped 10 times: (E, 1) leaves against vmap."""
    E, A, NB = 6, 2, 108
    rng = np.random.default_rng(0)
    per_env = {"m": rng.uniform(3.0, 4.0, E), "lf": rng.uniform(0.147, 0.17, E),
               "width": rng.uniform(0.27, 0.33, E),
               "length": rng.uniform(0.5, 0.6, E),
               "v_max": rng.uniform(6.0, 20.0, E)}
    jcfg = J.SimConfig(num_agents=A, num_beams=NB, dtype="float64",
                       scan_noise=False)
    jm = J.load_map(map_path("example_map"), dtype=jnp.float64)
    jt = J.make_scan_tables(num_beams=NB, dtype=jnp.float64)
    jbase = J.VehicleParams.create(dtype=jnp.float64)
    jp = jbase.replace(**{k: jnp.broadcast_to(v, (E,))
                          for k, v in vars(jbase).items()})
    jp = jp.replace(**{k: jnp.asarray(v) for k, v in per_env.items()})

    pm = convert.map_data_from_jax(_leaves(jm), "cpu")
    pt = convert.scan_tables_from_jax(_leaves(jt), "cpu")
    pcfg = P.SimConfig(num_agents=A, num_beams=NB, dtype="float64",
                       scan_noise=False)
    from f1tenth_gym_tpu_torch.examples.param_sweep import per_env_params

    pp = per_env_params(P.VehicleParams.create(dtype=torch.float64,
                                               device="cpu"), E, **per_env)
    assert all(v.shape == (E, 1) for v in vars(pp).values())

    # a start grid on example_map's raceline; env 5's cars overlap
    wp = np.loadtxt(os.path.join(ROOT, "f1tenth_gym_tpu", "maps",
                                 "example_map_waypoints.csv"),
                    delimiter=";", skiprows=3)[:, 1:4]
    poses = np.stack([wp[40 * e + np.array([6, 0])] for e in range(E)])
    poses[5, 1] = poses[5, 0] + [0.2, 0.0, 0.3]
    acts = np.stack([rng.uniform(-0.35, 0.35, (10, E, A)),
                     rng.uniform(1.0, 9.0, (10, E, A))], -1)

    keys = jax.random.split(jax.random.PRNGKey(0), E)
    js, *_ = jax.vmap(lambda q, k, p: j_reset(q, k, p, jm, jt, jcfg, 0.01))(
        jnp.asarray(poses), keys, jp)
    ps, *_ = P.batch_reset(torch.as_tensor(poses), pp, pm, pt, pcfg, 0.01,
                           device="cpu")
    jstep = jax.jit(jax.vmap(lambda s, a, p: j_step(s, a, p, jm, jt, jcfg,
                                                    0.01)))
    for t in range(10):
        js, jo, _, jd, _ = jstep(js, jnp.asarray(acts[t]), jp)
        ps, po, _, pd, _ = P.batch_step(ps, torch.as_tensor(acts[t]), pp, pm,
                                        pt, pcfg, 0.01)
        for k in ("poses_x", "poses_y", "poses_theta", "linear_vels_x",
                  "ang_vels_z", "scans"):
            np.testing.assert_allclose(po[k].numpy(), np.asarray(jo[k]),
                                       rtol=1e-9, atol=1e-9,
                                       err_msg=f"step {t} {k}")
        np.testing.assert_array_equal(po["collisions"].numpy(),
                                      np.asarray(jo["collisions"]))
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    assert bool(pd[5])   # the overlapping cars collided
    # the per-env leaves matter: shared params give other poses
    shared = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    s2, *_ = P.batch_reset(torch.as_tensor(poses), shared, pm, pt, pcfg,
                           0.01, device="cpu")
    for t in range(10):
        s2, *_ = P.batch_step(s2, torch.as_tensor(acts[t]), shared, pm, pt,
                              pcfg, 0.01)
    assert not torch.allclose(s2.x, ps.x)


def test_experiment_config_equals_jax():
    got, want = PX.load_experiment_config(CONFIG), JX.load_experiment_config(
        CONFIG)
    assert vars(got) == vars(want)
    assert {k: type(v) for k, v in vars(got).items()} == \
        {k: type(v) for k, v in vars(want).items()}
    assert got.tlad_max == 5.0 and isinstance(got.perf_num, int)
    assert PX.resolve_path(got, got.map_path) == JX.resolve_path(
        want, want.map_path)
    np.testing.assert_array_equal(PX.load_config_waypoints(got),
                                  JX.load_config_waypoints(want))
    np.testing.assert_array_equal(PX.start_pose(got), JX.start_pose(want))


def test_experiment_config_edge_cases_equal_jax(tmp_path):
    path = tmp_path / "exp.yaml"
    path.write_text(
        "# comment line\n"
        "dot_float: 5.\n"
        "bare_exp: 1e3          # PyYAML 1.1: a string\n"
        "signed_exp: 1.0e+3\n"
        "unsigned_exp: 1.0e3\n"
        "quoted_hash: 'a # b'   # and a comment\n"
        "double_hash: \"c#d\"\n"
        "plain_hash: e#f\n"
        "negative: -3\n"
        "octal: 017\n"
        "hex: 0x1F\n"
        "under: 1_000\n"
        "flag: yes\n"
        "nothing: ~\n"
        "empty:\n"
        "inf: -.inf\n"
        "inline: [1, 2.5, 'x,y', z]\n"
        "block:\n"
        "  - 0.7\n"
        "  - 'w'\n"
        "quote: 'it''s'\n")
    got, want = PX.load_experiment_config(str(path)), \
        JX.load_experiment_config(str(path))
    assert vars(got) == vars(want)
    assert {k: type(v) for k, v in vars(got).items()} == \
        {k: type(v) for k, v in vars(want).items()}
    assert got.bare_exp == "1e3" and got.signed_exp == 1000.0


def test_experiment_config_rejects_nested(tmp_path):
    path = tmp_path / "nested.yaml"
    path.write_text("outer:\n  inner: 1\n")
    with pytest.raises(ValueError, match="nested"):
        PX.load_experiment_config(str(path))
    path.write_text("outer: {inner: 1}\n")
    with pytest.raises(ValueError, match="flat"):
        PX.load_experiment_config(str(path))


def test_renderer_frame_equals_jax():
    from f1tenth_gym_tpu.render.renderer import EnvRenderer as JR
    from f1tenth_gym_tpu_torch.render.renderer import EnvRenderer as PR

    obs = {"ego_idx": 0, "poses_x": np.array([0.7, 1.5]),
           "poses_y": np.array([0.0, -0.8]),
           "poses_theta": np.array([1.37, 0.4]),
           "lap_times": np.array([3.25, 3.25]),
           "lap_counts": np.array([1.0, 0.0])}
    ghosts = np.array([[[2.0, 1.0, 0.3], [2.5, 1.5, 1.0]]])
    frames = []
    renderers = [JR(headless=True), PR(headless=True)]
    for r in renderers:
        r.update_map(map_path("example_map"), ".png")
        r.update_obs(obs)
        r.update_batch(ghosts)
        frames.append(r.draw(return_array=True))
    for r in renderers:
        r.close()
    assert frames[1].shape == (800, 1000, 3) and frames[1].dtype == np.uint8
    assert np.array_equal(frames[1], frames[0])
    assert (frames[1] != frames[1][0, 0]).any()


def test_env_render_rgb_array_equals_jax():
    from f1tenth_gym_tpu.envs import F110Env as JEnv
    from f1tenth_gym_tpu_torch.envs import F110Env

    kw = dict(map=map_path("example_map")[:-5], num_agents=2, num_beams=108,
              dtype="float64", scan_noise=False)
    poses = np.array([[0.7, 0.0, 1.37079632679], [0.7, -1.0, 1.37079632679]])
    frames = []
    envs = [JEnv(**kw), F110Env(device="cpu", **kw)]
    calls = []
    for env in envs:
        env.add_render_callback(lambda r: calls.append(type(r).__module__))
        env.reset(poses)
        frames.append(env.render("rgb_array"))
    for env in envs:
        env.close()
    assert np.array_equal(frames[1], frames[0])
    assert calls == ["f1tenth_gym_tpu.render.renderer",
                     "f1tenth_gym_tpu_torch.render.renderer"]


def test_domain_randomization_example():
    from f1tenth_gym_tpu_torch.examples import domain_randomization as dr

    argv = ["--tracks", "4", "--seed", "11", "--envs", "8", "--beams", "108",
            "--device", "cpu"]
    r = dr.main(argv + ["--steps", "6"])
    assert r["env_steps_per_s"] > 0 and len(r["progress_per_track"]) == 4
    assert all(np.isfinite(v) for v in r["progress_per_track"])
    r = dr.main(argv + ["--train", "--iters", "1"])
    assert np.isfinite(r["iterations"][0]["loss"])


def test_waypoint_follow_example(tmp_path):
    from f1tenth_gym_tpu_torch.examples import waypoint_follow as wf
    from PIL import Image

    base = ["--beams", "108", "--device", "cpu"]
    r = wf.main(base + ["--steps", "30", "--track-dir", str(tmp_path / "t")])
    assert r["steps"] == 30 and r["collisions"] == [0.0]
    assert sorted(os.listdir(tmp_path / "t")) == [
        "demo.png", "demo.yaml", "demo_centerline.csv"]
    r = wf.main(base + ["--config", CONFIG, "--steps", "10"])
    assert r["steps"] == 10 and r["collisions"] == [0.0]
    frames = tmp_path / "frames"
    r = wf.main(base + ["--map", str(tmp_path / "t" / "demo"), "--waypoints",
                        str(tmp_path / "t" / "demo_centerline.csv"),
                        "--steps", "25", "--fused", "--render", "rgb",
                        "--frames-out", str(frames)])
    assert r["steps"] == 25 and r["collisions"] == [0.0]
    assert sorted(os.listdir(frames)) == ["f00000.png", "f00020.png"]
    assert np.array(Image.open(frames / "f00020.png")).shape == (800, 1000, 3)


def test_param_sweep_example():
    from f1tenth_gym_tpu_torch.examples import param_sweep

    r = param_sweep.main(["--budget", "4", "--steps", "6", "--beams", "108",
                          "--device", "cpu"])
    assert r["candidates"] == 4 and r["steps"] == 6 and r["poses_finite"]
    assert r["states"].x.shape == (4, 1, 7)
    assert float(r["states"].x[:, 0, 3].min()) > 0.0   # the cars drive


def test_massive_rollout_example():
    from f1tenth_gym_tpu_torch.examples import massive_rollout

    r = massive_rollout.main(["--envs", "8", "--steps", "4", "--beams", "108",
                              "--device", "cpu"])
    assert r["env_steps_per_s"] > 0 and r["poses_finite"]
