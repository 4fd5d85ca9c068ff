"""Pure-pursuit waypoint follower over any batch of cars.

Port of ``f1tenth_gym_tpu/planning/pure_pursuit.py``. Behavioral parity
targets (reference examples/waypoint_follow.py):

  * ``nearest_point_on_trajectory``                         — :15-47
  * ``first_point_on_trajectory_intersecting_circle``       — :49-131
  * ``get_actuation``                                       — :133-144
  * ``PurePursuitPlanner._get_current_waypoint`` / ``plan`` — :183-217

The JAX package writes each function for one car and vmaps it; here the
cars are leading batch axes of the tensors. The reference scans trajectory
segments sequentially and breaks at the first circle intersection; here
every segment is tested at once and "first" is the argmin of the cyclic
segment order starting at the nearest segment (``torch.argmin`` returns
the first minimum, as ``jnp.argmin`` does, which that order relies on).

The circle test's constant term is |start - point|^2 - r^2, the reference's
|start|^2 + |point|^2 - 2 start.point - r^2 written without its
cancellation: in float32 at example_map's ~50 m coordinates the expanded
form is off by ~1e-3 m^2, enough to move a root across 0 or 1 at a
segment's end, so that neither segment at a vertex holds the crossing and
the search runs round the loop to a point behind the car.

The lookahead distance and the speed gain may be numbers or per-car
tensors that broadcast against the poses' leading axes (an (E, 1) tensor
for (E, A=1) poses: a gain sweep). Spans (``utils/profiling.annotate``):
``plan.step`` around a whole plan (with its extent on the card's
timeline), and inside it ``plan.nearest``, ``plan.lookahead`` and
``plan.actuation``; ``pure_pursuit_plan.cars`` counts the cars planned.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.state import IX_X, IX_Y, IX_YAW
from f1tenth_gym_tpu_torch.utils.profiling import annotate

Gain = Union[float, torch.Tensor]


def _take(a, idx):
    """a (..., N) indexed by idx (...) along its last axis."""
    return torch.gather(a, -1, idx[..., None])[..., 0]


def nearest_point_on_trajectory(point, trajectory):
    """Nearest point on a piecewise-linear trajectory.

    point: (..., 2); trajectory: (N, 2) -> (projection (..., 2), dist (...),
    t (...), seg_idx (...) int64).
    """
    diffs = trajectory[1:] - trajectory[:-1]  # (N-1, 2)
    l2s = diffs[:, 0] ** 2 + diffs[:, 1] ** 2
    rel = point[..., None, :] - trajectory[:-1]  # (..., N-1, 2)
    dots = rel[..., 0] * diffs[:, 0] + rel[..., 1] * diffs[:, 1]
    t = torch.clamp(dots / l2s, 0.0, 1.0)
    projections = trajectory[:-1] + t[..., None] * diffs
    d = point[..., None, :] - projections
    dists = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    i = torch.argmin(dists, -1)
    return (projections.gather(-2, i[..., None, None].expand(
        *i.shape, 1, 2))[..., 0, :], _take(dists, i), _take(t, i), i)


def first_point_on_trajectory_intersecting_circle(point, radius, trajectory,
                                                  t0):
    """First circle/trajectory intersection in cyclic segment order.

    Replicates the reference's sequential scan (waypoint_follow.py:49-131)
    with wrap=True: segments are visited start_i, start_i+1, ..., N-1 (the
    closing segment N-1 -> 0), 0, ..., start_i-1; within a segment t1 is
    preferred over t2; on the first segment the intersection parameter must
    be >= frac(t0). ``start_i`` truncates t0 to int32 and frac(t0) is a
    floor modulo, as in the JAX package.

    point (..., 2), radius a number or (...), t0 (...) -> (point (..., 2),
    seg_idx (...), t (...), found (...)).
    """
    N = trajectory.shape[0]
    t0 = torch.as_tensor(t0, dtype=point.dtype, device=point.device)
    start_i = t0.to(torch.int32).to(torch.int64)
    start_t = torch.remainder(t0, 1.0)

    starts = trajectory  # segment i: trajectory[i] -> trajectory[(i+1) % N]
    ends = torch.roll(trajectory, -1, 0) + 1e-6
    V = ends - starts

    def dot(u, v):
        return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1]

    rel = starts - point[..., None, :]
    a = dot(V, V)
    b = 2.0 * dot(V, rel)
    r2 = radius * radius
    if isinstance(r2, torch.Tensor) and r2.dim():   # a radius a car
        r2 = r2[..., None]
    c = dot(rel, rel) - r2
    disc = b * b - 4 * a * c
    has_root = disc >= 0.0
    sq = torch.sqrt(torch.where(has_root, disc, torch.zeros_like(disc)))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)

    seg_ids = torch.arange(N, device=point.device)
    not_first = seg_ids != start_i[..., None]
    st = start_t[..., None]
    t1_ok = has_root & (t1 >= 0.0) & (t1 <= 1.0) & (not_first | (t1 >= st))
    t2_ok = has_root & (t2 >= 0.0) & (t2 <= 1.0) & (not_first | (t2 >= st))
    t_sel = torch.where(t1_ok, t1, t2)
    valid = t1_ok | t2_ok

    order = torch.remainder(seg_ids - start_i[..., None], N)
    score = torch.where(valid, order, N + 1)
    j = torch.argmin(score, -1)
    t_j = _take(t_sel, j)
    return starts[j] + t_j[..., None] * V[j], j, t_j, _take(valid, j)


def get_actuation(pose_theta, lookahead_point, position, lookahead_distance,
                  wheelbase):
    """Curvature actuation (waypoint_follow.py:133-144).

    lookahead_point: (..., 3) [x, y, speed]. Returns (speed, steering_angle).
    """
    d = lookahead_point[..., 0:2] - position
    waypoint_y = torch.sin(-pose_theta) * d[..., 0] + torch.cos(-pose_theta) * d[..., 1]
    speed = lookahead_point[..., 2]
    radius = 1.0 / (2.0 * waypoint_y / lookahead_distance ** 2)
    steering_angle = torch.arctan(wheelbase / radius)
    small = torch.abs(waypoint_y) < 1e-6
    return speed, torch.where(small, torch.zeros_like(steering_angle),
                              steering_angle)


def pure_pursuit_plan(
    pose_x,
    pose_y,
    pose_theta,
    waypoints_xyv,       # (N, 3): x, y, target speed
    lookahead_distance,
    vgain,
    wheelbase,
    max_reacquire: float = 20.0,
):
    """Full planner step (waypoint_follow.py:183-217) for cars on any
    leading axes. Returns (speed, steer). The off-trajectory fallback is
    the reference's: speed 4.0 un-gained, steer 0. ``lookahead_distance``
    and ``vgain``: numbers, or tensors that broadcast against the poses
    (one gain a car)."""
    with annotate("plan.step", extent=True):
        pure_pursuit_plan.cars += pose_x.numel()
        return _plan(pose_x, pose_y, pose_theta, waypoints_xyv,
                     lookahead_distance, vgain, wheelbase, max_reacquire)


pure_pursuit_plan.cars = 0


def _plan(pose_x, pose_y, pose_theta, waypoints_xyv, lookahead_distance,
          vgain, wheelbase, max_reacquire):
    position = torch.stack([pose_x, pose_y], -1)
    wpts = waypoints_xyv[:, 0:2]

    with annotate("plan.nearest"):
        _, nearest_dist, t, i = nearest_point_on_trajectory(position, wpts)

    with annotate("plan.lookahead"):
        _, i2, _, found = first_point_on_trajectory_intersecting_circle(
            position, lookahead_distance, wpts, i.to(position.dtype) + t)
    with annotate("plan.actuation"):
        # the reference takes the lookahead position from the *segment
        # start* wpts[i2] (waypoint_follow.py:195-196), not the
        # intersection point
        speed_i = waypoints_xyv[i, 2:3]
        current_wp_near = torch.cat([wpts[i2], speed_i], -1)
        current_wp_far = torch.cat([wpts[i], speed_i], -1)

        within = nearest_dist < lookahead_distance
        reacquire = nearest_dist < max_reacquire

        lookahead_point = torch.where(within[..., None], current_wp_near,
                                      current_wp_far)
        have_point = torch.where(within, found, reacquire)

        speed, steer = get_actuation(pose_theta, lookahead_point, position,
                                     lookahead_distance, wheelbase)
        speed = vgain * speed
        speed = torch.where(have_point, speed, torch.full_like(speed, 4.0))
        steer = torch.where(have_point, steer, torch.zeros_like(steer))
    return speed, steer


class PurePursuitPlanner:
    """Stateful convenience wrapper mirroring the reference class
    (waypoint_follow.py:146-217), plus a batched policy factory.

    The waypoints live on ``device`` (default: the card) in the dtype
    numpy gives them; each plan casts them to its poses' dtype, so float32
    poses plan in float32 and float64 poses in float64."""

    def __init__(self, waypoints_xyv: np.ndarray, wheelbase: float = 0.33020,
                 max_reacquire: float = 20.0, device=None):
        self.device = resolve_device(device)
        self.waypoints = torch.as_tensor(np.asarray(waypoints_xyv),
                                         device=self.device)
        self.wheelbase = wheelbase
        self.max_reacquire = max_reacquire

    def _plan(self, x, y, th, lookahead_distance, vgain):
        return pure_pursuit_plan(x, y, th, self.waypoints.to(x.dtype),
                                 lookahead_distance, vgain, self.wheelbase,
                                 self.max_reacquire)

    def plan(self, pose_x, pose_y, pose_theta, lookahead_distance, vgain):
        """One car's (speed, steer) as Python floats. Python float poses
        plan in the waypoints' dtype."""
        def scalar(v):
            if isinstance(v, torch.Tensor):
                return v.to(self.device)
            return torch.as_tensor(v, dtype=self.waypoints.dtype,
                                   device=self.device)

        speed, steer = self._plan(scalar(pose_x), scalar(pose_y),
                                  scalar(pose_theta), lookahead_distance,
                                  vgain)
        return float(speed), float(steer)

    def fused_plan_step(self, step_fn, lookahead_distance: Gain,
                        vgain: Gain):
        """Plan and step in one call per frame.

        The returned ``plan_step(state) -> (state, obs, reward, done,
        info)`` plans every agent's pure-pursuit action from the CURRENT
        state pose on the device and steps, so nothing comes back to the
        host unless the caller reads the obs. ``step_fn(state, actions)``
        is a functional step (``batch_step`` bound to its env, or
        ``make_autoreset_step``'s). ``lookahead_distance`` and ``vgain``
        are numbers, or per-env tensors that broadcast against the (E, A)
        poses, e.g. (E, 1): each env a candidate of a gain sweep. Per-env
        gains are bound to env slots: after ``sort_envs_for_locality``
        permute them with the order it returns (``return_order=True``)
        and build the step again."""
        def plan_step(state):
            speed, steer = self._plan(state.x[..., IX_X], state.x[..., IX_Y],
                                      state.x[..., IX_YAW],
                                      lookahead_distance, vgain)
            return step_fn(state, torch.stack([steer, speed], -1))

        return plan_step

    def batched_policy(self, lookahead_distance: Gain, vgain: Gain):
        """(generator, obs) -> (..., 2) actions policy for the vector env
        and ``rollout``. The gains are numbers or per-env tensors that
        broadcast against the obs' (E, A) poses, as in
        ``fused_plan_step``."""
        def policy(generator, obs):
            speed, steer = self._plan(obs["poses_x"], obs["poses_y"],
                                      obs["poses_theta"], lookahead_distance,
                                      vgain)
            return torch.stack([steer, speed], -1)

        return policy
