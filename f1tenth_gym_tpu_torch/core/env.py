"""Environment layer of E envs: reset, step, lap bookkeeping, done.

Port of ``f1tenth_gym_tpu/core/env.py`` (``init_state``, ``_update_laps``,
``env_step``, ``env_reset``, ``make_env_fns``), the analogue of the reference's
``F110Env`` (f110_env.py:53-418): reward == timestep, the finish-line
toggle count in the ego start frame (f110_env.py:204-246), and a reset
that performs the reference's zero-action step (f110_env.py:337-338).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from f1tenth_gym_tpu_torch.config import DEFAULT_SEED, SimConfig
from f1tenth_gym_tpu_torch.core.simulator import sim_step
from f1tenth_gym_tpu_torch.state import (
    IX_X,
    IX_Y,
    IX_YAW,
    MapData,
    ScanTables,
    SimState,
    VehicleParams,
)
from f1tenth_gym_tpu_torch.utils.profiling import annotate


def init_state(poses: torch.Tensor, cfg: SimConfig) -> SimState:
    """Fresh state with agents at ``poses`` (E, A, 3), on the poses'
    device (RaceCar.reset, base_classes.py:183-204)."""
    dtype = cfg.torch_dtype
    poses = poses.to(dtype)
    E, A = poses.shape[0], cfg.num_agents
    dev = poses.device
    x = torch.zeros((E, A, 7), dtype=dtype, device=dev)
    x[..., IX_X] = poses[..., 0]
    x[..., IX_Y] = poses[..., 1]
    x[..., IX_YAW] = poses[..., 2]

    ego_theta = poses[:, cfg.ego_idx, 2]
    c, s = torch.cos(-ego_theta), torch.sin(-ego_theta)
    start_rot = torch.stack([torch.stack([c, -s], -1),
                             torch.stack([s, c], -1)], -2)  # R(-theta_ego)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return SimState(
        x=x,
        steer_buf=zeros(E, A, 2),
        collisions=zeros(E, A),
        collision_idx=-torch.ones((E, A), dtype=dtype, device=dev),
        scans=zeros(E, A, cfg.num_beams),
        lap_times=zeros(E, A),
        lap_counts=zeros(E, A),
        toggle_list=zeros(E, A),
        near_starts=torch.ones((E, A), dtype=torch.bool, device=dev),
        start_xs=poses[..., 0].clone(),
        start_ys=poses[..., 1].clone(),
        start_thetas=poses[..., 2].clone(),
        start_rot=start_rot,
        current_time=zeros(E),
        steps=torch.zeros((E,), dtype=torch.int32, device=dev),
    )


def _update_laps(state: SimState, cfg: SimConfig) -> SimState:
    """Finish-line toggle bookkeeping (f110_env.py:204-243)."""
    left_t = 2.0
    right_t = 2.0
    dx = state.x[..., IX_X] - state.start_xs
    dy = state.x[..., IX_Y] - state.start_ys
    rot = state.start_rot[:, :, :, None]          # (E, 2, 2, 1)
    delta_x = rot[:, 0, 0] * dx + rot[:, 0, 1] * dy
    temp_y = rot[:, 1, 0] * dx + rot[:, 1, 1] * dy
    idx1 = temp_y > left_t
    idx2 = temp_y < -right_t
    temp_y = torch.where(idx1, temp_y - left_t,
                         torch.where(idx2, -right_t - temp_y,
                                     torch.zeros_like(temp_y)))
    dist2 = delta_x ** 2 + temp_y ** 2
    closes = dist2 <= 0.1

    crossed = closes != state.near_starts
    toggle_list = state.toggle_list + crossed.to(state.toggle_list.dtype)
    lap_counts = torch.floor(toggle_list / 2.0)
    lap_times = torch.where(toggle_list < 4, state.current_time[:, None],
                            state.lap_times)
    return state.replace(toggle_list=toggle_list, near_starts=closes,
                         lap_counts=lap_counts, lap_times=lap_times)


def env_step(state: SimState, actions: torch.Tensor, params: VehicleParams,
             map_data: MapData, tables: ScanTables, cfg: SimConfig, timestep,
             generator: Optional[torch.Generator] = None,
             ) -> Tuple[SimState, Dict, torch.Tensor, torch.Tensor, Dict]:
    """One step of E envs -> (state', obs, reward (E,), done (E,), info)."""
    with annotate("env.step"):
        timestep = torch.as_tensor(timestep, dtype=state.current_time.dtype,
                                   device=state.current_time.device)
        state, obs = sim_step(state, actions, params, map_data, tables, cfg,
                              timestep, generator)
        state = state.replace(current_time=state.current_time + timestep)
        with annotate("env.laps"):
            state = _update_laps(state, cfg)
        obs["lap_times"] = state.lap_times
        obs["lap_counts"] = state.lap_counts
        finished = state.toggle_list >= 4
        done = (state.collisions[:, cfg.ego_idx] > 0.0) | finished.all(-1)
        reward = timestep.expand(state.num_envs)
    return state, obs, reward, done, {"checkpoint_done": finished}


def env_reset(poses: torch.Tensor, params: VehicleParams, map_data: MapData,
              tables: ScanTables, cfg: SimConfig, timestep,
              generator: Optional[torch.Generator] = None):
    """Reset E envs to ``poses`` (E, A, 3) and take the reference's
    zero-action first step."""
    state = init_state(poses, cfg)
    actions = torch.zeros((state.num_envs, cfg.num_agents, 2),
                          dtype=cfg.torch_dtype, device=poses.device)
    return env_step(state, actions, params, map_data, tables, cfg, timestep,
                    generator)


def make_env_fns(params: VehicleParams, map_data: MapData, tables: ScanTables,
                 cfg: SimConfig, timestep: float):
    """Convenience factory: ``(reset(poses, generator=None),
    step(state, actions, generator=None))``, closures over ``env_reset``
    and ``env_step`` with the rest bound (JAX ``core/env.py:153``).

    The envs run on the map's device, poses (E, A, 3) and actions (E, A, 2)
    carry the env axis, and the scan noise comes from ``generator``, or
    from one generator the factory seeds on the map's device when a call
    passes none."""
    dev = map_data.device
    default_gen = torch.Generator(device=dev)
    default_gen.manual_seed(DEFAULT_SEED)
    # on the device once, so that no step copies it there
    timestep = torch.as_tensor(timestep, dtype=cfg.torch_dtype, device=dev)

    def reset(poses: torch.Tensor,
              generator: Optional[torch.Generator] = None):
        return env_reset(torch.as_tensor(poses).to(dev), params, map_data,
                         tables, cfg, timestep, generator or default_gen)

    def step(state: SimState, actions: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        return env_step(state, torch.as_tensor(actions, dtype=cfg.torch_dtype,
                                                device=dev), params,
                        map_data, tables, cfg, timestep,
                        generator or default_gen)

    return reset, step
