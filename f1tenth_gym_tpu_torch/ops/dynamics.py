"""Batched vehicle dynamics: CommonRoad single-track + kinematic bicycle.

Port of ``f1tenth_gym_tpu/ops/dynamics.py``; reference kernels of
dynamic_models.py:29-221 (``accl_constraints``, ``steering_constraint``,
``vehicle_dynamics_ks``, ``vehicle_dynamics_st`` with its |v| < 0.5
kinematic switch, ``pid``). Every function is elementwise over any leading
batch axes; Python branches become ``torch.where`` chains in the
reference's precedence order, and the divisions the reference guards by
control flow use safe denominators so the branch not taken never makes
NaN or Inf.
"""

from __future__ import annotations

import torch

from f1tenth_gym_tpu_torch.state import (
    IX_SLIP,
    IX_STEER,
    IX_VEL,
    IX_YAW,
    IX_YAW_RATE,
    VehicleParams,
)

G = 9.81  # gravity, m/s^2 (dynamic_models.py:146)


def accl_constraints(vel, accl, v_switch, a_max, v_min, v_max):
    """Longitudinal acceleration limits (dynamic_models.py:29-60)."""
    vel_safe = torch.where(vel > v_switch, vel, torch.ones_like(vel))
    pos_limit = torch.where(vel > v_switch, a_max * v_switch / vel_safe, a_max)
    zero_cond = ((vel <= v_min) & (accl <= 0.0)) | ((vel >= v_max) & (accl >= 0.0))
    out = torch.where(accl >= pos_limit, pos_limit, accl)
    out = torch.where(accl <= -a_max, -a_max, out)
    return torch.where(zero_cond, torch.zeros_like(out), out)


def steering_constraint(steering_angle, steering_velocity, s_min, s_max,
                        sv_min, sv_max):
    """Steering velocity limits (dynamic_models.py:62-87)."""
    zero_cond = (((steering_angle <= s_min) & (steering_velocity <= 0.0))
                 | ((steering_angle >= s_max) & (steering_velocity >= 0.0)))
    out = torch.where(steering_velocity >= sv_max, sv_max, steering_velocity)
    out = torch.where(steering_velocity <= sv_min, sv_min, out)
    return torch.where(zero_cond, torch.zeros_like(out), out)


def _constrain_inputs(x, u_init, p: VehicleParams):
    """u[..., 0] = steering velocity, u[..., 1] = longitudinal accel."""
    sv = steering_constraint(x[..., IX_STEER], u_init[..., 0], p.s_min,
                             p.s_max, p.sv_min, p.sv_max)
    accl = accl_constraints(x[..., IX_VEL], u_init[..., 1], p.v_switch,
                            p.a_max, p.v_min, p.v_max)
    return torch.stack([sv, accl], -1)


def vehicle_dynamics_ks5(x, u_init, p: VehicleParams):
    """Kinematic single-track, 5-state form (dynamic_models.py:90-121)."""
    u = _constrain_inputs(x, u_init, p)
    lwb = p.lf + p.lr
    return torch.stack([
        x[..., 3] * torch.cos(x[..., 4]),
        x[..., 3] * torch.sin(x[..., 4]),
        u[..., 0],
        u[..., 1],
        x[..., 3] / lwb * torch.tan(x[..., 2]),
    ], -1)


def _f_ks7(x, u, p: VehicleParams):
    """Kinematic branch in the 7-state layout (dynamic_models.py:152-160)."""
    lwb = p.lf + p.lr
    delta = x[..., IX_STEER]
    v = x[..., IX_VEL]
    yaw = x[..., IX_YAW]
    sv = u[..., 0]
    a = u[..., 1]
    cos_d = torch.cos(delta)
    return torch.stack([
        v * torch.cos(yaw),
        v * torch.sin(yaw),
        sv,
        a,
        v / lwb * torch.tan(delta),
        a / lwb * torch.tan(delta) + v / (lwb * cos_d * cos_d) * sv,
        torch.zeros_like(v),
    ], -1)


def _f_st7(x, u, p: VehicleParams):
    """Dynamic single-track branch (dynamic_models.py:162-174)."""
    delta = x[..., IX_STEER]
    v = x[..., IX_VEL]
    yaw = x[..., IX_YAW]
    wz = x[..., IX_YAW_RATE]
    beta = x[..., IX_SLIP]
    sv = u[..., 0]
    a = u[..., 1]

    # guard: |v| >= 0.5 in the taken branch, so clamp magnitude below that
    v_safe = torch.where(torch.abs(v) < 0.25,
                         torch.where(v < 0, -0.25, 0.25).to(v.dtype), v)

    lf, lr, h, m, I, mu, C_Sf, C_Sr = (p.lf, p.lr, p.h, p.m, p.I, p.mu,
                                       p.C_Sf, p.C_Sr)
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
    return torch.stack([
        v * torch.cos(beta + yaw),
        v * torch.sin(beta + yaw),
        sv,
        a,
        wz,
        f_wz,
        f_beta,
    ], -1)


def vehicle_dynamics_st(x, u_init, p: VehicleParams):
    """Single-track dynamics, 7-state (dynamic_models.py:123-176): both
    branches computed, selected elementwise on |v| < 0.5."""
    u = _constrain_inputs(x, u_init, p)
    low_speed = (torch.abs(x[..., IX_VEL]) < 0.5)[..., None]
    return torch.where(low_speed, _f_ks7(x, u, p), _f_st7(x, u, p))


def vehicle_dynamics_ks7(x, u_init, p: VehicleParams):
    """Kinematic model in the 7-state layout at every speed."""
    return _f_ks7(x, _constrain_inputs(x, u_init, p), p)


def pid(speed, steer, current_speed, current_steer, max_sv, max_a, max_v,
        min_v):
    """Speed/steer set-points -> (accel, steering velocity)
    (dynamic_models.py:178-221)."""
    steer_diff = steer - current_steer
    sv = torch.where(torch.abs(steer_diff) > 1e-4,
                     torch.sign(steer_diff) * max_sv,
                     torch.zeros_like(steer_diff))
    vel_diff = speed - current_speed
    gain = torch.where(current_speed > 0.0, 10.0, 2.0).to(speed.dtype)
    kp = gain * max_a / torch.where(vel_diff > 0.0, max_v, -min_v)
    return kp * vel_diff, sv


def euler_step(x, u, p: VehicleParams, dt, dyn_fn=vehicle_dynamics_st):
    """Explicit Euler (base_classes.py:375-395)."""
    return x + dt * dyn_fn(x, u, p)


def rk4_step(x, u, p: VehicleParams, dt, dyn_fn=vehicle_dynamics_st):
    """Classic RK4 with inputs held across stages (base_classes.py:284-373)."""
    k1 = dyn_fn(x, u, p)
    k2 = dyn_fn(x + dt * (k1 / 2.0), u, p)
    k3 = dyn_fn(x + dt * (k2 / 2.0), u, p)
    k4 = dyn_fn(x + dt * k3, u, p)
    return x + dt * (1.0 / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
