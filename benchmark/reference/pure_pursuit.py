"""Plain reference of f1tenth_gym's pure-pursuit planner, in torch ops.

A transcription of upstream ``examples/waypoint_follow.py``:
``nearest_point_on_trajectory`` (:15-47),
``first_point_on_trajectory_intersecting_circle`` (:49-131) with
``wrap=True``, ``get_actuation`` (:133-144) and ``PurePursuitPlanner.plan``
with ``_get_current_waypoint`` (:183-217), its off-trajectory fallback
included (speed 4.0, steer 0). It imports nothing of the program, so that
the planner cell's yardstick does not move when the program does.

Departures, none of which changes a result:

* it works on a batch of cars (leading axis) where upstream plans one;
* ``nearest_point_on_trajectory``'s two loops over segments compute one
  independent value a segment, so they run as one broadcast;
* the circle search visits the segments one at a time in upstream's order
  (``start_i`` .. N-2, the closing segment N-1 -> 0, 0 .. ``start_i`` - 1)
  for every car at once; a car that has found its segment is carried by a
  mask, and the loop ends once every car has (checked every 16 segments).
  Upstream names the closing segment -1; here it is N-1, and
  ``wpts[-1]`` and ``wpts[N-1]`` are the same point;
* the waypoints come as (N, 3) [x, y, speed], the columns upstream picks
  with ``wpt_xind``, ``wpt_yind`` and ``wpt_vind``.

``admitted`` also gives every action a planner that rounds differently may
rightly take. Each decision whose margin is under ``MARGIN_M`` (in m) or
``MARGIN_T`` (in a segment's t) admits both of its outcomes:

* the nearest segment: every segment within ``MARGIN_M`` of the least
  distance; where its t lies within ``MARGIN_T`` of 1, both starts of the
  search, (i, t) and (i + 1, 0);
* the nearest distance against the lookahead and against
  ``max_reacquire``;
* a root's t against 0, 1 and, on the search's first segment, the start
  fraction;
* the discriminant against 0, as the distance of the segment's line from
  the car against the lookahead, in m.

Only which segment the search stops on and which branch is taken change an
action (the lookahead point is a segment's start, upstream :195-196), so a
car's admitted actions are the branches and segments that some resolution
of its near ties reaches. ``plan`` is the same code with no margin: one
action a car, upstream's.
"""

from __future__ import annotations

import torch

MARGIN_M = 1e-4
MARGIN_T = 1e-4
FALLBACK_SPEED = 4.0     # upstream plan(): `return 4.0, 0.0`
END_OFFSET = 1e-6        # upstream's `end = trajectory[...] + 1e-6`
SMALL_Y = 1e-6           # upstream get_actuation's straight-ahead test
CHECK_EVERY = 16


def _dot(u, v):
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1]


def nearest_point_on_trajectory(point, trajectory):
    """Every segment's (distance, t) from ``point`` (C, 2) to the polyline
    ``trajectory`` (N, 2): (C, N-1) each. Upstream takes the argmin."""
    diffs = trajectory[1:] - trajectory[:-1]
    l2s = diffs[:, 0] ** 2 + diffs[:, 1] ** 2
    dots = _dot(point[:, None, :] - trajectory[None, :-1], diffs[None])
    t = (dots / l2s).clamp(0.0, 1.0)     # t[t < 0] = 0; t[t > 1] = 1
    projections = trajectory[:-1] + t[..., None] * diffs
    temp = point[:, None, :] - projections
    return torch.sqrt(_dot(temp, temp)), t


def first_point_on_trajectory_intersecting_circle(
        point, radius, trajectory, start_i, start_t, margin_m=0.0,
        margin_t=0.0, skip=None):
    """The circle search of each row: ``point`` (R, 2), ``radius``,
    ``start_t`` (R,) and ``start_i`` (R,) int64, upstream's
    ``int(t)`` and ``t % 1.0``. Returns (``cand`` (R, N) bool: the
    segments the search may stop on, ``lost`` (R,) bool: whether it may
    find none). With no margins ``cand`` holds upstream's ``first_i`` alone
    (or nothing, and ``lost`` is set). Rows in ``skip`` (R,) bool, whose
    search upstream never runs, are not searched."""
    N = trajectory.shape[0]
    R = point.shape[0]
    dev = point.device
    rows = torch.arange(R, device=dev)
    found = torch.zeros(R, dtype=torch.bool, device=dev) if skip is None \
        else skip.clone()
    cand = torch.zeros((R, N), dtype=torch.bool, device=dev)
    r2 = radius * radius
    for k in range(N):
        i = torch.remainder(start_i + k, N)
        start = trajectory[i]
        end = trajectory[torch.remainder(i + 1, N)] + END_OFFSET
        V = end - start
        a = _dot(V, V)
        b = 2.0 * _dot(V, start - point)
        c = _dot(start, start) + _dot(point, point) \
            - 2.0 * _dot(start, point) - r2
        discriminant = b * b - 4 * a * c
        root = discriminant >= 0
        sq = torch.sqrt(discriminant.clamp(min=0.0))
        t1 = (-b - sq) / (2.0 * a)
        t2 = (-b + sq) / (2.0 * a)
        # the line's distance from the point against the radius, in m
        line = torch.sqrt((r2 - discriminant / (4.0 * a)).clamp(min=0.0))
        tangent = (line - radius).abs() < margin_m
        lo = start_t if k == 0 else torch.zeros_like(start_t)

        def inside(t, m):
            return (t >= lo + m) & (t <= 1.0 - m)

        sure = root & ~tangent & (inside(t1, margin_t) | inside(t2, margin_t))
        maybe = (root | tangent) & (inside(t1, -margin_t)
                                    | inside(t2, -margin_t))
        cand[rows, i] |= maybe & ~found
        found |= sure
        if k % CHECK_EVERY == CHECK_EVERY - 1 and bool(found.all()):
            break
    return cand, ~found


def get_actuation(pose_theta, lookahead_point, position, lookahead_distance,
                  wheelbase):
    """(speed, steering angle) of each row, upstream :133-144."""
    d = lookahead_point[..., 0:2] - position
    waypoint_y = torch.sin(-pose_theta) * d[..., 0] \
        + torch.cos(-pose_theta) * d[..., 1]
    speed = lookahead_point[..., 2]
    radius = 1 / (2.0 * waypoint_y / lookahead_distance ** 2)
    steering_angle = torch.arctan(wheelbase / radius)
    straight = waypoint_y.abs() < SMALL_Y
    return speed, torch.where(straight, 0.0, steering_angle)


def admitted(poses, lookahead_distance, vgain, waypoints, wheelbase,
             max_reacquire, margin_m=MARGIN_M, margin_t=MARGIN_T,
             dtype=torch.float64):
    """Every admitted action (module docstring) of each car.

    ``poses`` (C, 3) [x, y, theta], ``lookahead_distance`` and ``vgain``
    (C,), ``waypoints`` (N, 3) [x, y, speed]; all computed in ``dtype``.
    Returns (car (K,) int64, speed (K,), steer (K,)): K >= C rows, at least
    one a car."""
    dev = poses.device
    poses = poses.to(dtype)
    tlad = lookahead_distance.to(dtype)
    vgain = vgain.to(dtype)
    wp = torch.as_tensor(waypoints, device=dev).to(dtype)
    wpts = wp[:, 0:2]
    C = poses.shape[0]
    position = poses[:, 0:2]

    dists, ts = nearest_point_on_trajectory(position, wpts)
    if margin_m > 0:
        near = dists <= dists.min(-1, keepdim=True).values + margin_m
    else:    # np.argmin: the first least distance
        near = torch.zeros_like(dists, dtype=torch.bool)
        near[torch.arange(C, device=dev), dists.argmin(-1)] = True
    car, i = torch.nonzero(near, as_tuple=True)
    t = ts[car, i]
    dist = dists[car, i]
    # the search's start, `i + t` as upstream hands it over
    t0 = i.to(dtype) + t
    start_i = t0.to(torch.int64)
    start_t = torch.remainder(t0, 1.0)
    if margin_t > 0:
        # t within the margin of 1: the start (i, t) and the start (i + 1, 0)
        edge = t >= 1.0 - margin_t
        alt_i = torch.where(start_i == i, i + 1, i)
        alt_t = torch.where(start_i == i, torch.zeros_like(t), t)
        car = torch.cat([car, car[edge]])
        i = torch.cat([i, i[edge]])
        dist = torch.cat([dist, dist[edge]])
        start_i = torch.cat([start_i, alt_i[edge]])
        start_t = torch.cat([start_t, alt_t[edge]])

    r = tlad[car]
    within = dist < r + margin_m           # `nearest_dist < lookahead`
    cand, lost = first_point_on_trajectory_intersecting_circle(
        position[car], r, wpts, start_i, start_t, margin_m, margin_t,
        skip=~within)
    beyond = dist >= r - margin_m          # its else branch
    reacquire = dist < max_reacquire + margin_m
    astray = dist >= max_reacquire - margin_m

    # (row, lookahead segment start) pairs: the circle's segments when the
    # car is within the lookahead, its nearest segment's start beyond it
    row_c, seg_c = torch.nonzero(cand & within[:, None], as_tuple=True)
    far = torch.nonzero(beyond & reacquire, as_tuple=True)[0]
    row = torch.cat([row_c, far])
    seg = torch.cat([seg_c, i[far]])
    lookahead = torch.cat([wpts[seg], wp[i[row], 2:3]], -1)
    c = car[row]
    speed, steer = get_actuation(poses[c, 2], lookahead, position[c],
                                 tlad[c], wheelbase)
    speed = vgain[c] * speed
    # no point: lost within the lookahead, or beyond max_reacquire
    none = torch.nonzero((within & lost) | (beyond & astray),
                         as_tuple=True)[0]
    c_none = car[none]
    return (torch.cat([c, c_none]),
            torch.cat([speed, torch.full_like(c_none, FALLBACK_SPEED,
                                              dtype=dtype)]),
            torch.cat([steer, torch.zeros_like(c_none, dtype=dtype)]))


def plan(poses, lookahead_distance, vgain, waypoints, wheelbase,
         max_reacquire, dtype=torch.float64):
    """Upstream's (speed, steer) of each car, (C,) each, in ``dtype``."""
    car, speed, steer = admitted(poses, lookahead_distance, vgain, waypoints,
                                 wheelbase, max_reacquire, 0.0, 0.0, dtype)
    out_speed = torch.empty(poses.shape[0], dtype=dtype, device=poses.device)
    out_steer = torch.empty_like(out_speed)
    out_speed[car] = speed
    out_steer[car] = steer
    return out_speed, out_steer


def action_gap(speed, steer, car, ref_speed, ref_steer):
    """Per car (C,): the least, over its admitted actions (``car``,
    ``ref_speed``, ``ref_steer``), of the larger of |speed - ref speed|
    (m/s) and |steer - ref steer| (rad); a NaN gives infinity."""
    speed = speed.double()
    steer = steer.double()
    g = torch.maximum((speed[car] - ref_speed.double()).abs(),
                      (steer[car] - ref_steer.double()).abs())
    g = torch.nan_to_num(g, nan=float("inf"))
    out = torch.full_like(speed, float("inf"))
    return out.scatter_reduce(0, car, g, "amin")
