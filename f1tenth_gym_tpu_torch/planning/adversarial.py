"""Adversarial planners for integrator / dynamics stress testing.

Port of ``f1tenth_gym_tpu/planning/adversarial.py``. The reference ships
``FlippyPlanner`` ("a planner that minimizes the car's steering effort...
designed to exploit integration methods", examples/waypoint_follow.py:
220-238): a probe that commands extreme, rapidly flipping steering to
expose integrator instability (Euler blows up where RK4 stays bounded).
"""

from __future__ import annotations

import torch


def flippy_action(step_idx, speed: float = 0.2, flip_every: int = 2,
                  steer_mag: float = 0.4189):
    """Action for a step counter (int or integer tensor of any shape):
    steering flips sign every ``flip_every`` steps at magnitude
    ``steer_mag`` (default = the vehicle's s_max). Returns (..., 2)
    [steer, speed] in float64 on the counter's device."""
    step_idx = torch.as_tensor(step_idx)
    phase = torch.div(step_idx, flip_every, rounding_mode="floor") % 2
    mag = torch.tensor(steer_mag, dtype=torch.float64,
                       device=step_idx.device)
    steer = torch.where(phase == 0, mag, -mag)
    return torch.stack([steer, torch.full_like(steer, speed)], -1)


class FlippyPlanner:
    """Stateful adversarial planner with the reference's plan() surface.

    Commands maximal alternating steering to stress the integrator; with
    Euler at large dt the single-track model's slip/yaw-rate states diverge,
    with RK4 they stay bounded (reference examples/waypoint_follow.py:
    220-238).
    """

    def __init__(self, speed: float = 0.2, flip_every: int = 2,
                 steer_mag: float = 0.4189):
        self.speed = float(speed)
        self.flip_every = int(flip_every)
        self.steer_mag = float(steer_mag)
        self._count = 0

    def reset(self):
        self._count = 0

    def plan(self, *args, **kwargs):
        a = flippy_action(self._count, self.speed, self.flip_every,
                          self.steer_mag)
        self._count += 1
        return float(a[1]), float(a[0])  # (speed, steer) like the reference
