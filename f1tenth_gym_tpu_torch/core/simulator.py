"""The simulation step of E envs at once.

Port of ``f1tenth_gym_tpu/core/simulator.py`` (``physics_step``,
``sim_step``), the batched replacement for the reference's
``Simulator.step`` (base_classes.py:553-612). Sub-step order, as in
core/simulator.py:141-263:

  1. steering-delay FIFO pop/push           (base_classes.py:270-278)
  2. PID -> RK4/Euler integration -> single +-2pi yaw wrap
  3. the scan pose (lidar mounted lidar_dist ahead)
  4. the scan ("march", "segments" or the "kernel" sweep)
  5. noise, before iTTC                      (laser_models.py:450-452)
  6. collision boxes from the PRE-zeroing pose
  7. iTTC, which zeroes x[3:], yaw included  (base_classes.py:229-254)
  8. opponent ray cast from the POST-zeroing scan pose (K3 on the card,
     ``ops/opp_clip_kernel.py``)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from f1tenth_gym_tpu_torch.config import (
    INTEGRATOR_EULER,
    INTEGRATOR_RK4,
    MODEL_KS,
    MODEL_ST,
    SimConfig,
)
from f1tenth_gym_tpu_torch.ops import collision as col_ops
from f1tenth_gym_tpu_torch.ops import dynamics as dyn_ops
from f1tenth_gym_tpu_torch.ops import lidar as lidar_ops
from f1tenth_gym_tpu_torch.ops import opp_clip_kernel
from f1tenth_gym_tpu_torch.ops import scan_kernel
from f1tenth_gym_tpu_torch.ops import segments as seg_ops
from f1tenth_gym_tpu_torch.state import (
    IX_VEL,
    IX_X,
    IX_Y,
    IX_YAW,
    MapData,
    ScanTables,
    SimState,
    VehicleParams,
)
from f1tenth_gym_tpu_torch.utils.profiling import annotate

TWO_PI = 2.0 * np.pi


def _dyn_fn(cfg: SimConfig):
    if cfg.model == MODEL_ST:
        return dyn_ops.vehicle_dynamics_st
    if cfg.model == MODEL_KS:
        return dyn_ops.vehicle_dynamics_ks7
    raise ValueError(f"unknown model '{cfg.model}'")


def physics_step(x, steer_buf, actions, params: VehicleParams, timestep,
                 cfg: SimConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., 7), steer_buf (..., 2), actions (..., 2) [steer, speed]
    -> (x', steer_buf')."""
    raw_steer = actions[..., 0]
    vel_cmd = actions[..., 1]
    # 2-deep steering delay FIFO: read slot 1, then shift
    steer = steer_buf[..., 1]
    steer_buf = torch.stack([raw_steer, steer_buf[..., 0]], -1)

    accl, sv = dyn_ops.pid(vel_cmd, steer, x[..., IX_VEL], x[..., 2],
                           params.sv_max, params.a_max, params.v_max,
                           params.v_min)
    u = torch.stack([sv, accl], -1)
    dyn = _dyn_fn(cfg)
    if cfg.integrator == INTEGRATOR_RK4:
        x_new = dyn_ops.rk4_step(x, u, params, timestep, dyn_fn=dyn)
    elif cfg.integrator == INTEGRATOR_EULER:
        x_new = dyn_ops.euler_step(x, u, params, timestep, dyn_fn=dyn)
    else:
        raise ValueError(f"unknown integrator '{cfg.integrator}'")

    # single +-2pi yaw correction (base_classes.py:400-404)
    yaw = x_new[..., IX_YAW]
    x_new[..., IX_YAW] = torch.where(
        yaw > TWO_PI, yaw - TWO_PI, torch.where(yaw < 0.0, yaw + TWO_PI, yaw))
    return x_new, steer_buf


def sim_step(state: SimState, actions: torch.Tensor, params: VehicleParams,
             map_data: MapData, tables: ScanTables, cfg: SimConfig, timestep,
             generator: Optional[torch.Generator] = None,
             ) -> Tuple[SimState, Dict[str, torch.Tensor]]:
    """One lockstep tick of all agents of all envs. actions: (E, A, 2).

    ``generator`` draws the scan noise (needed when ``cfg.scan_noise``).
    """
    with annotate("sim.physics"):
        x_new, steer_buf = physics_step(state.x, state.steer_buf, actions,
                                        params, timestep, cfg)

    yaw = x_new[..., IX_YAW]
    with annotate("sim.scan"):
        scan_pose = torch.stack([
            x_new[..., IX_X] + tables.lidar_dist * torch.cos(yaw),
            x_new[..., IX_Y] + tables.lidar_dist * torch.sin(yaw),
            yaw,
        ], -1)  # (E, A, 3)
        engine = cfg.resolved_scan_engine(map_data.device,
                                          map_data.seg_table is not None)
        if engine == "kernel":
            scans = scan_kernel.scan(scan_pose, map_data, tables,
                                     cfg.num_beams, cfg.theta_dis,
                                     device=map_data.device)
        elif engine == "segments":
            if map_data.segments is None:
                raise ValueError(
                    "scan_engine='segments' needs MapData.segments: load the "
                    "map with extract_segments=True")
            scans = seg_ops.get_scan_segments(scan_pose, map_data.segments,
                                              tables, cfg.num_beams,
                                              cfg.theta_dis)
        elif engine == "march":
            scans = lidar_ops.get_scan(scan_pose, map_data, tables,
                                       cfg.num_beams, cfg.theta_dis,
                                       max_iters=cfg.max_march_iters)
        else:
            raise ValueError(f"unknown scan engine '{engine}'")

    if cfg.scan_noise:
        if generator is None:
            raise ValueError("scan_noise=True needs a torch.Generator")
        with annotate("sim.noise"):
            if cfg.shared_agent_noise:
                # reference quirk: all agents of an env add the same vector
                noise = torch.randn(scans.shape[:-2] + (1, cfg.num_beams),
                                    generator=generator, dtype=scans.dtype,
                                    device=scans.device)
                scans = scans + tables.scan_std * noise
            else:
                scans = lidar_ops.add_scan_noise(scans, tables.scan_std,
                                                 generator)

    # agent-agent collisions at the new, pre-zeroing poses
    with annotate("sim.collision"):
        poses_pre = torch.stack([x_new[..., IX_X], x_new[..., IX_Y], yaw], -1)
        vertices = col_ops.get_vertices(poses_pre, params.length,
                                        params.width)
        collisions, collision_idx = col_ops.collision_multiple(vertices)

    # iTTC on the pre-raycast scan zeroes state[3:], yaw included
    with annotate("sim.ittc"):
        ttc_hit = lidar_ops.check_ttc(scans, x_new[..., IX_VEL], tables)
        zero_mask = ttc_hit[..., None] & (
            torch.arange(7, device=x_new.device) >= 3)
        x_new = torch.where(zero_mask, torch.zeros_like(x_new), x_new)
        collisions = torch.maximum(collisions, ttc_hit.to(collisions.dtype))

    # opponents ray-cast into each scan: scanning pose after zeroing,
    # opponent boxes from before it (base_classes.py:574,579-585)
    A = cfg.num_agents
    if A > 1:
        with annotate("sim.opp_clip", extent=True):
            scans = opp_clip_kernel.opp_clip(x_new, scans, vertices, tables)

    new_state = state.replace(
        x=x_new,
        steer_buf=steer_buf,
        collisions=collisions,
        collision_idx=collision_idx,
        scans=scans,
        steps=state.steps + 1,
    )
    obs = {
        "ego_idx": cfg.ego_idx,
        "scans": scans,
        "poses_x": x_new[..., IX_X],
        "poses_y": x_new[..., IX_Y],
        "poses_theta": x_new[..., IX_YAW],
        "linear_vels_x": x_new[..., IX_VEL],
        "linear_vels_y": torch.zeros_like(x_new[..., IX_VEL]),
        "ang_vels_z": x_new[..., 5],
        "collisions": collisions,
    }
    return new_state, obs
