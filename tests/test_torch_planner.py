"""PyTorch port: planning/ (pure pursuit, FlippyPlanner) against the JAX
package and the reference's fixtures (tests/test_planner.py).

The port writes the planner on tensors with leading batch axes where the
JAX package vmaps one car; the fixtures' cases go through in one call.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu import planning as jplan
from f1tenth_gym_tpu.maps import map_path
from f1tenth_gym_tpu.utils.waypoints import load_waypoints as j_load_waypoints
from f1tenth_gym_tpu_torch import planning as pplan
from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data
from f1tenth_gym_tpu_torch.utils.waypoints import load_waypoints, ring_waypoints

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
LAD = 0.82461887897713965  # tests/test_planner.py's lookahead


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fix(name):
    return np.load(os.path.join(FIX, name))


def test_nearest_point_parity():
    """All 128 fixture points in one batched call (atol 1e-9, indices
    equal)."""
    d = _fix("planner_kernels.npz")
    p, dist, t, i = pplan.nearest_point_on_trajectory(
        torch.as_tensor(d["pts"]), torch.as_tensor(d["wpts"]))
    g = d["nearest"]
    np.testing.assert_allclose(p.numpy(), g[:, 0:2], rtol=0, atol=1e-9)
    np.testing.assert_allclose(dist.numpy(), g[:, 2], rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.numpy(), g[:, 3], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(i.numpy(), g[:, 4].astype(np.int64))


def test_circle_intersection_parity():
    d = _fix("planner_kernels.npz")
    wpts = torch.as_tensor(d["wpts"])
    pts = torch.as_tensor(d["pts"])
    _, _, t, i = pplan.nearest_point_on_trajectory(pts, wpts)
    p, i2, t2, found = pplan.first_point_on_trajectory_intersecting_circle(
        pts, LAD, wpts, i.to(torch.float64) + t)
    g = d["inter"]
    np.testing.assert_array_equal(found.numpy(), g[:, 4].astype(bool))
    f = g[:, 4].astype(bool)
    assert f.any() and not f.all()
    np.testing.assert_allclose(p.numpy()[f], g[f, 0:2], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(i2.numpy()[f],
                                  g[f, 2].astype(np.int64) % wpts.shape[0])
    np.testing.assert_allclose(t2.numpy()[f], g[f, 3], rtol=0, atol=1e-9)


def test_first_segment_order_and_truncation():
    """The cyclic "first segment" order: a circle crossing the trajectory
    on several segments picks the first from start_i on, wrapping through
    the closing segment; on start_i itself only t >= frac(t0) counts.
    start_i truncates t0 to int32 and frac is a floor modulo, as in JAX."""
    wpts = ring_waypoints(2.0, n=16)[:, :2]
    pts = np.array([[2.0, 0.0], [0.0, 2.0], [-2.0, 0.1], [1.9, -0.3]])
    t0 = np.array([0.0, 4.5, 8.99, 15.7])
    jout = [jplan.first_point_on_trajectory_intersecting_circle(
        jnp.asarray(pt), 1.5, jnp.asarray(wpts), jnp.asarray(t))
        for pt, t in zip(pts, t0)]
    p, j, t, found = pplan.first_point_on_trajectory_intersecting_circle(
        torch.as_tensor(pts), 1.5, torch.as_tensor(wpts), torch.as_tensor(t0))
    for k, (jp, jj, jt, jf) in enumerate(jout):
        assert bool(found[k]) == bool(jf) and int(j[k]) == int(jj), k
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(float(t[k]), float(jt), rtol=0, atol=1e-12)


def test_closed_loop_parity():
    """Pure pursuit + env reproduces the reference's 500-step driven lap
    segment on example_map (tests/test_planner.py::test_closed_loop_parity
    on the port: float64, march, no noise; atol 1e-6)."""
    d = _fix("closed_loop.npz")
    cfg = P.SimConfig(num_agents=1, scan_noise=False, dtype="float64")
    params = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    tables = P.make_scan_tables(dtype=torch.float64, device="cpu")
    m = P.load_map(map_path("example_map"), ".png", dtype=torch.float64,
                   device="cpu")
    wpts = torch.as_tensor(d["wpts_xyv"])
    tlad, vgain = float(d["tlad"]), float(d["vgain"])
    wheelbase = 0.17145 + 0.15875

    state, obs, *_ = P.env_reset(torch.as_tensor(d["start"])[None], params,
                                 m, tables, cfg, 0.01)
    T = d["poses"].shape[0]
    actions, poses = np.zeros((T, 2)), np.zeros((T, 3))
    for t in range(T):
        speed, steer = pplan.pure_pursuit_plan(
            obs["poses_x"][0, 0], obs["poses_y"][0, 0],
            obs["poses_theta"][0, 0], wpts, tlad, vgain, wheelbase)
        actions[t] = [float(steer), float(speed)]
        state, obs, *_ = P.env_step(
            state, torch.stack([steer, speed]).reshape(1, 1, 2), params, m,
            tables, cfg, 0.01)
        poses[t] = [float(obs["poses_x"][0, 0]), float(obs["poses_y"][0, 0]),
                    float(obs["poses_theta"][0, 0])]
    np.testing.assert_allclose(actions, d["actions"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(poses, d["poses"], rtol=0, atol=1e-6)


def test_fused_plan_step_matches_two_call():
    """fused_plan_step is bit-identical to the plan -> step two-call loop
    (tests/test_planner.py::test_fused_plan_step_matches_two_call)."""
    m = P.load_map(map_path("compact"), ".png", dtype=torch.float64,
                   device="cpu")
    wpts = load_waypoints(map_path("compact")[:-5] + "_centerline.csv")
    params = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    tables = P.make_scan_tables(num_beams=108, dtype=torch.float64,
                                device="cpu")
    cfg = P.SimConfig(num_agents=1, num_beams=108, dtype="float64")
    start = torch.tensor([[[wpts[0, 0], wpts[0, 1],
                            float(np.arctan2(*(wpts[1, :2] - wpts[0, :2])[::-1]))
                            ]]], dtype=torch.float64)
    planner = pplan.PurePursuitPlanner(wpts, device="cpu")
    gen_ref, gen_fused = P.make_generator("cpu", 3), P.make_generator("cpu", 3)

    def step_with(gen):
        def step(s, a):
            return P.env_step(s, a, params, m, tables, cfg, 0.01, gen)
        return step

    s_ref, obs, *_ = P.env_reset(start, params, m, tables, cfg, 0.01,
                                 P.make_generator("cpu", 3))
    s_fused = s_ref
    step_ref = step_with(gen_ref)
    fused = planner.fused_plan_step(step_with(gen_fused), 0.9, 0.8)
    for _ in range(25):
        speed, steer = planner.plan(obs["poses_x"][0, 0], obs["poses_y"][0, 0],
                                    obs["poses_theta"][0, 0], 0.9, 0.8)
        s_ref, obs, *_ = step_ref(
            s_ref, torch.tensor([[[steer, speed]]], dtype=torch.float64))
        s_fused, obs_f, *_ = fused(s_fused)
    assert torch.equal(s_ref.x, s_fused.x)
    assert torch.equal(obs["scans"], obs_f["scans"])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batched_policy_matches_jax_vmap(dtype):
    """batched_policy on (E, A) poses against the JAX package's vmapped
    policy, example_map's raceline, poses on and off it (atol 1e-12 in
    float64; float32 waypoints and poses as on the card, atol 1e-5)."""
    wpts = load_waypoints(map_path("example_map")[:-5] + "_waypoints.csv")
    np.testing.assert_array_equal(
        wpts, j_load_waypoints(map_path("example_map")[:-5]
                               + "_waypoints.csv"))
    rng = np.random.default_rng(5)
    E, A = 24, 2
    idx = rng.integers(0, wpts.shape[0], (E, A))
    obs = {"poses_x": wpts[idx, 0] + rng.normal(0, 0.5, (E, A)),
           "poses_y": wpts[idx, 1] + rng.normal(0, 0.5, (E, A)),
           "poses_theta": rng.uniform(-np.pi, np.pi, (E, A))}
    obs["poses_x"][0, 0] += 500.0  # beyond max_reacquire: the fallback
    np_dt = np.dtype(dtype)
    want = jplan.PurePursuitPlanner(wpts.astype(np_dt)).batched_policy(
        0.82, 1.0)(jax.random.PRNGKey(0),
                   {k: jnp.asarray(v.astype(np_dt)) for k, v in obs.items()})
    planner = pplan.PurePursuitPlanner(wpts, device="cpu")
    got = planner.batched_policy(0.82, 1.0)(
        None, {k: torch.as_tensor(v.astype(np_dt)) for k, v in obs.items()})
    assert got.shape == (E, A, 2) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12 if dtype == "float64" else 1e-5)
    np.testing.assert_array_equal(got[0, 0].numpy(), [0.0, 4.0])


def test_flippy_matches_jax():
    steps = np.arange(-3, 13)
    for kw in ({}, {"speed": 1.5, "flip_every": 3, "steer_mag": 0.2}):
        want = np.asarray(jplan.flippy_action(jnp.asarray(steps), **kw))
        got = pplan.flippy_action(torch.as_tensor(steps), **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        assert float(pplan.flippy_action(5, **kw)[0]) == float(
            jplan.flippy_action(5, **kw)[0])
        jp, pp = jplan.FlippyPlanner(**kw), pplan.FlippyPlanner(**kw)
        for _ in range(7):
            assert pp.plan(0.0, 0.0, 0.0) == jp.plan(0.0, 0.0, 0.0)
        jp.reset()
        pp.reset()
        assert pp.plan() == jp.plan()


def test_flippy_drives_the_env():
    """FlippyPlanner's actions step an env with the RK4 and Euler
    integrators (the probe's use, examples/waypoint_follow.py:220-238)."""
    wpts = ring_waypoints(2.0)
    m = ring_map_data(size=128, radius=2.0, dtype=torch.float64,
                      device="cpu")
    for integrator in ("rk4", "euler"):
        cfg = P.SimConfig(num_agents=1, num_beams=64, dtype="float64",
                          scan_noise=False, integrator=integrator)
        params = P.VehicleParams.create(dtype=torch.float64, device="cpu")
        tables = P.make_scan_tables(num_beams=64, dtype=torch.float64,
                                    device="cpu")
        pose = torch.tensor([[[wpts[0, 0], wpts[0, 1], np.pi / 2]]],
                            dtype=torch.float64)
        state, obs, *_ = P.env_reset(pose, params, m, tables, cfg, 0.01)
        flippy = pplan.FlippyPlanner()
        for _ in range(20):
            speed, steer = flippy.plan(obs)
            state, obs, *_ = P.env_step(
                state, torch.tensor([[[steer, speed]]], dtype=torch.float64),
                params, m, tables, cfg, 0.01)
        assert bool(torch.isfinite(state.x).all()), integrator
