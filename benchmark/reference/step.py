"""Plain reference of one racing step of f1tenth_gym's env, in torch ops.

A frozen transcription of f1tenth_gym's ``F110Env.step`` as the port
computes it (``gym/f110_gym/envs/base_classes.py:270-612``,
``dynamic_models.py:29-221``, ``collision_models.py:184-259``,
``laser_models.py:188-346``, ``f110_env.py:204-246``), written out here so
that the benchmark's yardstick does not move when the program does. It
imports nothing of the program: it builds its own parameters and LiDAR
tables from the configuration, and takes the wall scan from
``reference.scan``.

Every function works on a batch of envs (n, A, ...) in the dtype the
tables were made in: float32 as the configuration states, or bfloat16 for
the benchmark's lower-precision control. The operations and their order
are those of the configuration's semantics in float32, so that a sound
program reads the same bits.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark.reference import scan as ref_scan

TWO_PI = 2.0 * np.pi
G = 9.81
IX_X, IX_Y, IX_STEER, IX_VEL, IX_YAW, IX_YAW_RATE, IX_SLIP = range(7)
LEAVES = ("x", "steer_buf", "collisions", "collision_idx", "scans",
          "lap_times", "lap_counts", "toggle_list", "near_starts",
          "start_xs", "start_ys", "start_thetas", "start_rot",
          "current_time", "steps")


class Reference:
    """The configuration's vehicle, LiDAR and map, made on ``device`` in
    ``dtype``; ``segments`` (K, 4) are the wall segments the scan sweeps."""

    def __init__(self, cfg: dict, segments: np.ndarray, device,
                 dtype=torch.float32):
        self.dtype = dtype
        self.device = torch.device(device)
        self.A = int(cfg["num_agents"])
        self.B = int(cfg["num_beams"])
        self.theta_dis = int(cfg["theta_dis"])
        self.p = {k: torch.tensor(v, dtype=dtype, device=self.device)
                  for k, v in cfg["vehicle_params"].items()}
        self.t = make_tables(cfg, dtype, self.device)
        self.timestep = torch.tensor(cfg["timestep"], dtype=dtype,
                                     device=self.device)
        self.table = ref_scan.seg_table(segments, dtype, self.device)

    # -- the step --------------------------------------------------------
    def reset(self, poses: torch.Tensor, noise: torch.Tensor):
        """Envs reset at ``poses`` (n, A, 3): a fresh state and the
        zero-action first step (f110_env.py:337-338) with ``noise``."""
        s = self.init_state(poses)
        actions = torch.zeros((poses.shape[0], self.A, 2), dtype=self.dtype,
                              device=self.device)
        return self.step(s, actions, noise, autoreset=False)[0]

    def step(self, s: Dict[str, torch.Tensor], actions: torch.Tensor,
             noise: torch.Tensor, autoreset: bool = True):
        """One env step of the envs of ``s`` with ``noise`` (n, 1, B) their
        rows of the scan noise. Returns (state', done)."""
        p, t = self.p, self.t
        x_new, steer_buf = self.physics(s["x"], s["steer_buf"],
                                        actions.to(self.dtype))
        yaw = x_new[..., IX_YAW]
        scan_pose = torch.stack([
            x_new[..., IX_X] + t["lidar_dist"] * torch.cos(yaw),
            x_new[..., IX_Y] + t["lidar_dist"] * torch.sin(yaw),
            yaw,
        ], -1)
        scans = ref_scan.scan(scan_pose, self.table, t, self.B,
                              self.theta_dis).to(self.dtype)
        scans = scans + t["scan_std"] * noise.to(self.dtype)

        poses_pre = torch.stack([x_new[..., IX_X], x_new[..., IX_Y], yaw], -1)
        vertices = get_vertices(poses_pre, p["length"], p["width"])
        collisions, collision_idx = collision_multiple(vertices)

        ttc_hit = check_ttc(scans, x_new[..., IX_VEL], t)
        zero_mask = ttc_hit[..., None] & (
            torch.arange(7, device=x_new.device) >= 3)
        x_new = torch.where(zero_mask, torch.zeros_like(x_new), x_new)
        collisions = torch.maximum(collisions, ttc_hit.to(collisions.dtype))

        A = self.A
        if A > 1:
            poses_post = torch.stack(
                [x_new[..., IX_X], x_new[..., IX_Y], x_new[..., IX_YAW]], -1)
            k = torch.arange(A - 1, device=x_new.device)
            opp_idx = k + (k >= torch.arange(A, device=x_new.device)[:, None])
            scans = ray_cast_opponents(poses_post, scans,
                                       vertices[..., opp_idx, :, :], t)

        s = dict(s, x=x_new, steer_buf=steer_buf, collisions=collisions,
                 collision_idx=collision_idx, scans=scans,
                 steps=s["steps"] + 1)
        s["current_time"] = s["current_time"] + self.timestep
        s = update_laps(s)
        finished = s["toggle_list"] >= 4
        done = (s["collisions"][:, 0] > 0.0) | finished.all(-1)
        if autoreset:
            poses = torch.stack([s["start_xs"], s["start_ys"],
                                 s["start_thetas"]], -1)
            fresh = self.init_state(poses)
            s = {k: torch.where(done.view(done.shape + (1,) * (v.dim() - 1)),
                                fresh[k], v) for k, v in s.items()}
        return s, done

    def physics(self, x, steer_buf, actions):
        """Steering delay, PID, RK4 of the single-track model, yaw wrap
        (base_classes.py:270-404)."""
        p = self.p
        raw_steer = actions[..., 0]
        vel_cmd = actions[..., 1]
        steer = steer_buf[..., 1]
        steer_buf = torch.stack([raw_steer, steer_buf[..., 0]], -1)
        accl, sv = pid(vel_cmd, steer, x[..., IX_VEL], x[..., IX_STEER],
                       p["sv_max"], p["a_max"], p["v_max"], p["v_min"])
        u = torch.stack([sv, accl], -1)
        dt = self.timestep
        k1 = dynamics_st(x, u, p)
        k2 = dynamics_st(x + dt * (k1 / 2.0), u, p)
        k3 = dynamics_st(x + dt * (k2 / 2.0), u, p)
        k4 = dynamics_st(x + dt * k3, u, p)
        x_new = x + dt * (1.0 / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        yaw = x_new[..., IX_YAW]
        x_new[..., IX_YAW] = torch.where(
            yaw > TWO_PI, yaw - TWO_PI,
            torch.where(yaw < 0.0, yaw + TWO_PI, yaw))
        return x_new, steer_buf

    def init_state(self, poses: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Agents at ``poses`` (n, A, 3), at rest (base_classes.py:183-204)."""
        dtype, dev = self.dtype, self.device
        poses = poses.to(dtype)
        n, A = poses.shape[0], self.A
        x = torch.zeros((n, A, 7), dtype=dtype, device=dev)
        x[..., IX_X] = poses[..., 0]
        x[..., IX_Y] = poses[..., 1]
        x[..., IX_YAW] = poses[..., 2]
        ego_theta = poses[:, 0, 2]
        c, s = torch.cos(-ego_theta), torch.sin(-ego_theta)
        start_rot = torch.stack([torch.stack([c, -s], -1),
                                 torch.stack([s, c], -1)], -2)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return dict(
            x=x, steer_buf=zeros(n, A, 2), collisions=zeros(n, A),
            collision_idx=-torch.ones((n, A), dtype=dtype, device=dev),
            scans=zeros(n, A, self.B), lap_times=zeros(n, A),
            lap_counts=zeros(n, A), toggle_list=zeros(n, A),
            near_starts=torch.ones((n, A), dtype=torch.bool, device=dev),
            start_xs=poses[..., 0].clone(), start_ys=poses[..., 1].clone(),
            start_thetas=poses[..., 2].clone(), start_rot=start_rot,
            current_time=zeros(n),
            steps=torch.zeros((n,), dtype=torch.int32, device=dev))


def make_tables(cfg: dict, dtype, device) -> Dict[str, torch.Tensor]:
    """LiDAR look-up tables and the body's distance along each beam
    (laser_models.py:360-381, base_classes.py:122-158), in float64 on the
    host, then cast."""
    B, theta_dis = int(cfg["num_beams"]), int(cfg["theta_dis"])
    fov = float(cfg["fov"])
    theta_arr = np.linspace(0.0, TWO_PI, num=theta_dis)
    angle_increment = fov / (B - 1)
    scan_angles = -fov / 2.0 + np.arange(B) * angle_increment
    p = cfg["vehicle_params"]
    dist_sides = p["width"] / 2.0
    dist_fr = (p["lf"] + p["lr"]) / 2.0
    sd = np.empty((B,))
    for i, ang in enumerate(scan_angles):
        if ang > 0:
            if ang < np.pi / 2:
                sd[i] = min(dist_sides / np.sin(ang), dist_fr / np.cos(ang))
            else:
                sd[i] = min(dist_sides / np.cos(ang - np.pi / 2.0),
                            dist_fr / np.sin(ang - np.pi / 2.0))
        else:
            if ang > -np.pi / 2:
                sd[i] = min(dist_sides / np.sin(-ang), dist_fr / np.cos(-ang))
            else:
                sd[i] = min(dist_sides / np.cos(-ang - np.pi / 2.0),
                            dist_fr / np.sin(-ang - np.pi / 2.0))

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=device)

    return dict(sines=t(np.sin(theta_arr)), cosines=t(np.cos(theta_arr)),
                scan_angles=t(scan_angles), beam_cosines=t(np.cos(scan_angles)),
                side_distances=t(sd), fov=t(fov),
                max_range=t(cfg["max_range"]), scan_std=t(cfg["scan_std"]),
                ttc_thresh=t(cfg["ttc_thresh"]),
                lidar_dist=t(cfg["lidar_dist"]))


# -- vehicle dynamics (dynamic_models.py) ----------------------------------

def accl_constraints(vel, accl, v_switch, a_max, v_min, v_max):
    vel_safe = torch.where(vel > v_switch, vel, torch.ones_like(vel))
    pos_limit = torch.where(vel > v_switch, a_max * v_switch / vel_safe, a_max)
    zero_cond = (((vel <= v_min) & (accl <= 0.0))
                 | ((vel >= v_max) & (accl >= 0.0)))
    out = torch.where(accl >= pos_limit, pos_limit, accl)
    out = torch.where(accl <= -a_max, -a_max, out)
    return torch.where(zero_cond, torch.zeros_like(out), out)


def steering_constraint(steering_angle, steering_velocity, s_min, s_max,
                        sv_min, sv_max):
    zero_cond = (((steering_angle <= s_min) & (steering_velocity <= 0.0))
                 | ((steering_angle >= s_max) & (steering_velocity >= 0.0)))
    out = torch.where(steering_velocity >= sv_max, sv_max, steering_velocity)
    out = torch.where(steering_velocity <= sv_min, sv_min, out)
    return torch.where(zero_cond, torch.zeros_like(out), out)


def _kinematic(x, u, p):
    lwb = p["lf"] + p["lr"]
    delta, v, yaw = x[..., IX_STEER], x[..., IX_VEL], x[..., IX_YAW]
    sv, a = u[..., 0], u[..., 1]
    cos_d = torch.cos(delta)
    return torch.stack([
        v * torch.cos(yaw), v * torch.sin(yaw), sv, a,
        v / lwb * torch.tan(delta),
        a / lwb * torch.tan(delta) + v / (lwb * cos_d * cos_d) * sv,
        torch.zeros_like(v),
    ], -1)


def _single_track(x, u, p):
    delta, v, yaw = x[..., IX_STEER], x[..., IX_VEL], x[..., IX_YAW]
    wz, beta = x[..., IX_YAW_RATE], x[..., IX_SLIP]
    sv, a = u[..., 0], u[..., 1]
    v_safe = torch.where(torch.abs(v) < 0.25,
                         torch.where(v < 0, -0.25, 0.25).to(v.dtype), v)
    lf, lr, h, m, I, mu, C_Sf, C_Sr = (p[k] for k in (
        "lf", "lr", "h", "m", "I", "mu", "C_Sf", "C_Sr"))
    lwb = lf + lr
    glr_ah = G * lr - a * h
    glf_ah = G * lf + a * h
    f_wz = (
        -mu * m / (v_safe * I * lwb)
        * (lf ** 2 * C_Sf * glr_ah + lr ** 2 * C_Sr * glf_ah) * wz
        + mu * m / (I * lwb) * (lr * C_Sr * glf_ah - lf * C_Sf * glr_ah) * beta
        + mu * m / (I * lwb) * lf * C_Sf * glr_ah * delta
    )
    f_beta = (
        (mu / (v_safe ** 2 * lwb) * (C_Sr * glf_ah * lr - C_Sf * glr_ah * lf)
         - 1.0) * wz
        - mu / (v_safe * lwb) * (C_Sr * glf_ah + C_Sf * glr_ah) * beta
        + mu / (v_safe * lwb) * (C_Sf * glr_ah) * delta
    )
    return torch.stack([v * torch.cos(beta + yaw), v * torch.sin(beta + yaw),
                        sv, a, wz, f_wz, f_beta], -1)


def dynamics_st(x, u_init, p):
    """Single-track model with its kinematic switch below 0.5 m/s."""
    sv = steering_constraint(x[..., IX_STEER], u_init[..., 0], p["s_min"],
                             p["s_max"], p["sv_min"], p["sv_max"])
    accl = accl_constraints(x[..., IX_VEL], u_init[..., 1], p["v_switch"],
                            p["a_max"], p["v_min"], p["v_max"])
    u = torch.stack([sv, accl], -1)
    low_speed = (torch.abs(x[..., IX_VEL]) < 0.5)[..., None]
    return torch.where(low_speed, _kinematic(x, u, p), _single_track(x, u, p))


def pid(speed, steer, current_speed, current_steer, max_sv, max_a, max_v,
        min_v):
    steer_diff = steer - current_steer
    sv = torch.where(torch.abs(steer_diff) > 1e-4,
                     torch.sign(steer_diff) * max_sv,
                     torch.zeros_like(steer_diff))
    vel_diff = speed - current_speed
    gain = torch.where(current_speed > 0.0, 10.0, 2.0).to(speed.dtype)
    kp = gain * max_a / torch.where(vel_diff > 0.0, max_v, -min_v)
    return kp * vel_diff, sv


# -- collisions (collision_models.py) and the LiDAR's iTTC and opponents ---

def get_vertices(pose, length, width):
    c = torch.cos(pose[..., 2])
    s = torch.sin(pose[..., 2])
    half_l = length / 2.0
    half_w = width / 2.0
    ones = torch.ones_like(c)
    bx = torch.stack([-half_l * ones, -half_l * ones, half_l * ones,
                      half_l * ones], -1)
    by = torch.stack([half_w * ones, -half_w * ones, -half_w * ones,
                      half_w * ones], -1)
    wx = pose[..., 0:1] + bx * c[..., None] - by * s[..., None]
    wy = pose[..., 1:2] + bx * s[..., None] + by * c[..., None]
    return torch.stack([wx, wy], -1)


def _project(vertices, axes):
    proj = (axes[..., :, None, 0] * vertices[..., None, :, 0]
            + axes[..., :, None, 1] * vertices[..., None, :, 1])
    return proj.amin(-1), proj.amax(-1)


def _overlap(v1, v2):
    ii, jj = torch.triu_indices(4, 4, 1, device=v1.device)

    def pair_axes(v):
        d = v[..., jj, :] - v[..., ii, :]
        return torch.stack([-d[..., 1], d[..., 0]], -1)

    axes = torch.cat([pair_axes(v1), pair_axes(v2)], -2)
    min1, max1 = _project(v1, axes)
    min2, max2 = _project(v2, axes)
    return ~((max1 < min2) | (max2 < min1)).any(-1)


def collision_multiple(vertices):
    """(n, A, 4, 2) -> collisions (n, A) 0/1 and the partner index, the
    reference's pair loop order (collision_models.py:184-212)."""
    A = vertices.shape[-3]
    ii, jj = torch.triu_indices(A, A, 1, device=vertices.device)
    colpair = _overlap(vertices[..., ii, :, :], vertices[..., jj, :, :])
    colmat = torch.zeros(vertices.shape[:-3] + (A, A), dtype=torch.bool,
                         device=vertices.device)
    colmat[..., ii, jj] = colpair
    colmat[..., jj, ii] = colpair
    idx = torch.arange(A, device=vertices.device)
    upper = colmat & (idx[None, :] > idx[:, None])
    lower = colmat & (idx[None, :] < idx[:, None])
    last_upper = torch.where(upper, idx, -1).amax(-1)
    last_lower = torch.where(lower, idx, -1).amax(-1)
    collision_idx = torch.where(last_upper >= 0, last_upper, last_lower)
    return (colmat.any(-1).to(vertices.dtype),
            collision_idx.to(vertices.dtype))


def check_ttc(scan, vel, t):
    proj_vel = vel[..., None] * t["beam_cosines"]
    ttc = (scan - t["side_distances"]) / proj_vel
    hit = (ttc < t["ttc_thresh"]) & (ttc >= 0.0)
    return torch.where(vel != 0.0, hit.any(-1), False)


def ray_cast_opponents(pose, scan, opp_vertices, t):
    """Clip scans by the other cars' boxes (laser_models.py:249-346)."""
    B = scan.shape[-1]
    ox = pose[..., 0, None, None]
    oy = pose[..., 1, None, None]
    theta = pose[..., 2]
    vecs_x = opp_vertices[..., 0] - ox
    vecs_y = opp_vertices[..., 1] - oy
    vert_angles = torch.atan2(vecs_y, vecs_x)
    ego_angle = torch.atan2(torch.sin(theta), torch.cos(theta))
    diff = ego_angle[..., None, None] - vert_angles
    diff = torch.where(diff > np.pi, diff - 2 * np.pi, diff)
    diff = torch.where(diff < -np.pi, diff + 2 * np.pi, diff)
    angles_with_x = -diff
    angle0 = t["scan_angles"][0]
    inc_b = t["scan_angles"][1] - t["scan_angles"][0]
    inds = torch.clamp(torch.ceil((angles_with_x - angle0) / inc_b - 0.5),
                       0, B - 1)
    min_ind = inds.amin(-1)
    max_ind = inds.amax(-1)
    beam_ids = torch.arange(B, device=scan.device, dtype=inds.dtype)
    in_window = ((beam_ids >= min_ind[..., None])
                 & (beam_ids <= max_ind[..., None]))
    ca_b = torch.cos(t["scan_angles"] + np.pi / 2.0)
    sa_b = torch.sin(t["scan_angles"] + np.pi / 2.0)
    ct = torch.cos(theta)[..., None]
    st = torch.sin(theta)[..., None]
    v3x = (ct * ca_b - st * sa_b)[..., None, None, :]
    v3y = (st * ca_b + ct * sa_b)[..., None, None, :]
    va = opp_vertices
    vb = torch.roll(opp_vertices, shifts=-1, dims=-2)
    v1x = ox - va[..., 0]
    v1y = oy - va[..., 1]
    v2x = vb[..., 0] - va[..., 0]
    v2y = vb[..., 1] - va[..., 1]
    denom = v2x[..., None] * v3x + v2y[..., None] * v3y
    d1 = (v2x * v1y - v2y * v1x)[..., None] / denom
    d2 = (v1x[..., None] * v3x + v1y[..., None] * v3y) / denom
    valid = (torch.abs(denom) > 0.0) & (d1 >= 0.0) & (d2 >= 0.0) & (d2 <= 1.0)
    dist = torch.where(valid, d1, math.inf)
    ca_x = va[..., 0] - ox
    ca_y = va[..., 1] - oy
    collinear = torch.abs(v2x * ca_y - v2y * ca_x) < 1e-8
    da = torch.sqrt(v1x ** 2 + v1y ** 2)
    db = torch.sqrt((vb[..., 0] - ox) ** 2 + (vb[..., 1] - oy) ** 2)
    col_dist = torch.minimum(da, db)
    dist = torch.where((torch.abs(denom) <= 0.0) & collinear[..., None],
                       col_dist[..., None], dist)
    closest = dist.amin(-2)
    closest = torch.where(in_window, closest, math.inf)
    return torch.minimum(scan, closest.amin(-2))


def update_laps(s):
    """Finish-line toggles in the ego start frame (f110_env.py:204-243)."""
    left_t = right_t = 2.0
    dx = s["x"][..., IX_X] - s["start_xs"]
    dy = s["x"][..., IX_Y] - s["start_ys"]
    rot = s["start_rot"][:, :, :, None]
    delta_x = rot[:, 0, 0] * dx + rot[:, 0, 1] * dy
    temp_y = rot[:, 1, 0] * dx + rot[:, 1, 1] * dy
    idx1 = temp_y > left_t
    idx2 = temp_y < -right_t
    temp_y = torch.where(idx1, temp_y - left_t,
                         torch.where(idx2, -right_t - temp_y,
                                     torch.zeros_like(temp_y)))
    closes = delta_x ** 2 + temp_y ** 2 <= 0.1
    crossed = closes != s["near_starts"]
    toggle_list = s["toggle_list"] + crossed.to(s["toggle_list"].dtype)
    lap_times = torch.where(toggle_list < 4, s["current_time"][:, None],
                            s["lap_times"])
    return dict(s, toggle_list=toggle_list, near_starts=closes,
                lap_counts=torch.floor(toggle_list / 2.0), lap_times=lap_times)
