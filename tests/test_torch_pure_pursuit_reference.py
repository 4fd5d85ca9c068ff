"""PyTorch port: the batched pure-pursuit planner with per-env gains against
the benchmark's plain transcription of upstream's planner
(``benchmark/reference/pure_pursuit.py``), on example_map's raceline.

The port tests every segment at once and picks the first in the search's
order; the reference visits the segments one at a time, as upstream does.
In float64 the port's action is one of the reference's admitted actions
(those within its near-tie margins) to 1e-12 on every car; scalar gains and
a tensor of equal gains give the same bits.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import pure_pursuit as ref
from f1tenth_gym_tpu_torch.maps import centerline_path
from f1tenth_gym_tpu_torch.planning import (PurePursuitPlanner,
                                            pure_pursuit_plan)

WB, MAX_RE = 0.17145 + 0.15875, 20.0
TLAD, VGAIN = (0.2, 5.0), (0.5, 1.5)   # config_example_map.yaml's bounds
NEAR, FAR = 240, 16                    # cars near the raceline, past 20 m


@pytest.fixture(scope="module")
def waypoints():
    w = np.loadtxt(centerline_path("example_map"), delimiter=";",
                   skiprows=3)
    return w[:, [1, 2, 5]]


def _cars(waypoints, seed=7):
    """(C, 3) float64 poses: NEAR on and off the raceline (up to ~2 m),
    FAR more than max_reacquire from it; (C,) gains in the yaml's
    bounds."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, len(waypoints) - 1, NEAR)
    f = rng.random(NEAR)[:, None]
    xy = waypoints[k, :2] + (waypoints[k + 1, :2] - waypoints[k, :2]) * f
    xy = xy + rng.normal(0.0, 0.7, (NEAR, 2))
    far = np.stack([rng.uniform(30.0, 60.0, FAR),
                    rng.uniform(-60.0, -40.0, FAR)], 1)
    xy = np.concatenate([xy, far])
    theta = rng.uniform(-np.pi, np.pi, NEAR + FAR)
    poses = np.concatenate([xy, theta[:, None]], 1)
    tlad = rng.uniform(*TLAD, NEAR + FAR)
    vgain = rng.uniform(*VGAIN, NEAR + FAR)
    return (torch.as_tensor(poses), torch.as_tensor(tlad),
            torch.as_tensor(vgain))


def _gap(speed, steer, poses, tlad, vgain, waypoints):
    car, r_speed, r_steer = ref.admitted(poses, tlad, vgain, waypoints, WB,
                                         MAX_RE)
    return ref.action_gap(speed.reshape(-1), steer.reshape(-1), car, r_speed,
                          r_steer)


def test_far_cars_are_past_max_reacquire(waypoints):
    poses, _, _ = _cars(waypoints)
    d, _ = ref.nearest_point_on_trajectory(poses[:, :2],
                                           torch.as_tensor(waypoints[:, :2]))
    least = d.min(-1).values
    assert (least[NEAR:] > MAX_RE).all()
    assert (least[:NEAR] < 3.0).all()


def test_plan_with_per_car_gains_is_admitted(waypoints):
    poses, tlad, vgain = _cars(waypoints)
    speed, steer = pure_pursuit_plan(poses[:, 0], poses[:, 1], poses[:, 2],
                                     torch.as_tensor(waypoints), tlad, vgain,
                                     WB, MAX_RE)
    gap = _gap(speed, steer, poses, tlad, vgain, waypoints)
    assert gap.max() <= 1e-12
    # the fallback of the cars past max_reacquire: 4.0 m/s, straight
    assert (speed[NEAR:] == 4.0).all() and (steer[NEAR:] == 0.0).all()
    # different gains plan differently: a sweep, not one car's gains
    assert len(torch.unique(speed[:NEAR])) > NEAR // 2


def test_fused_plan_step_with_per_env_gains_is_admitted(waypoints):
    """(E, 1) gains against (E, A=1) poses, as a sweep's envs hold them."""
    poses, tlad, vgain = _cars(waypoints)
    planner = PurePursuitPlanner(waypoints, WB, MAX_RE, device="cpu")
    state = type("S", (), {})()
    state.x = torch.zeros((len(poses), 1, 7), dtype=torch.float64)
    state.x[:, 0, 0], state.x[:, 0, 1], state.x[:, 0, 4] = poses.T
    got = {}

    def step_fn(s, actions):
        got["a"] = actions
        return s, None, None, None, None

    planner.fused_plan_step(step_fn, tlad[:, None], vgain[:, None])(state)
    a = got["a"]
    assert a.shape == (len(poses), 1, 2)
    gap = _gap(a[..., 1], a[..., 0], poses, tlad, vgain, waypoints)
    assert gap.max() <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_scalar_gains_equal_a_tensor_of_them(waypoints, dtype):
    poses, _, _ = _cars(waypoints)
    poses = poses.to(dtype)
    planner = PurePursuitPlanner(waypoints, WB, MAX_RE, device="cpu")
    obs = dict(poses_x=poses[:, None, 0], poses_y=poses[:, None, 1],
               poses_theta=poses[:, None, 2])
    E = len(poses)
    for gains in ((0.82461887897713965, 0.9), (0.2, 1.5), (5.0, 0.5)):
        # numbers the dtype holds: equal gains on both sides
        tlad, vgain = (float(torch.tensor(v, dtype=dtype)) for v in gains)
        scalar = planner.batched_policy(tlad, vgain)(None, obs)
        t = torch.full((E, 1), tlad, dtype=dtype)
        g = torch.full((E, 1), vgain, dtype=dtype)
        tensor = planner.batched_policy(t, g)(None, obs)
        assert scalar.dtype == tensor.dtype == dtype
        assert torch.equal(scalar, tensor)


def test_reference_plan_is_upstreams_first_choice(waypoints):
    """``plan`` (no margins) is one action a car and one of the admitted
    ones; the bfloat16 reference, the cells' control, is not."""
    poses, tlad, vgain = _cars(waypoints)
    speed, steer = ref.plan(poses, tlad, vgain, waypoints, WB, MAX_RE)
    assert _gap(speed, steer, poses, tlad, vgain, waypoints).max() == 0.0
    low = ref.plan(poses, tlad, vgain, waypoints, WB, MAX_RE,
                   dtype=torch.bfloat16)
    assert _gap(*low, poses, tlad, vgain, waypoints).max() > 1e-3


# float32 cars whose crossing lies on a raceline vertex: with the circle
# test's constant term expanded (|start|^2 + |point|^2 - 2 start.point),
# float32 moved the root off both segments at that vertex and the search
# ran round the loop to a point behind the car (gaps 0.01-1.0)
VERTEX_CASES = [
    ((-36.401180267333984, -9.533102035522461, -2.1680800914764404),
     1.2277668714523315, 0.5635424852371216),
    ((-50.27884292602539, -8.538721084594727, 2.4147932529449463),
     1.9998483657836914, 1.370082139968872),
    ((-46.158870697021484, 20.284515380859375, 0.9446706175804138),
     3.4192161560058594, 1.3678255081176758),
    ((-45.137332916259766, 24.52332305908203, -2.8398916721343994),
     1.5926376581192017, 0.8449238538742065),
    ((-40.862571716308594, 25.170576095581055, 2.63407301902771),
     0.21752230823040009, 0.8838922381401062),
]


def test_float32_plan_keeps_crossings_on_vertices(waypoints):
    poses = torch.tensor([c[0] for c in VERTEX_CASES], dtype=torch.float32)
    tlad = torch.tensor([c[1] for c in VERTEX_CASES], dtype=torch.float32)
    vgain = torch.tensor([c[2] for c in VERTEX_CASES], dtype=torch.float32)
    w32 = torch.as_tensor(waypoints, dtype=torch.float32)
    speed, steer = pure_pursuit_plan(poses[:, 0], poses[:, 1], poses[:, 2],
                                     w32, tlad, vgain, WB, MAX_RE)
    assert _gap(speed, steer, poses, tlad, vgain, waypoints).max() < 1e-4
