"""Batched rollouts under any policy, the envs staying on the device.

Port of ``f1tenth_gym_tpu/parallel/rollout.py``. The JAX package scans
the step inside one program; here the T steps are a Python loop of eager
steps, with nothing read back to the host until the caller reads the
result.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from f1tenth_gym_tpu_torch.config import SimConfig
from f1tenth_gym_tpu_torch.parallel.vector import batch_step
from f1tenth_gym_tpu_torch.state import MapData, ScanTables, SimState, VehicleParams


class Transition(NamedTuple):
    obs: dict
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


@torch.no_grad()
def rollout(
    states: SimState,
    policy_fn: Callable,       # (generator, obs) -> (E, A, 2) actions
    n_steps: int,
    params: VehicleParams,
    map_data: MapData,
    tables: ScanTables,
    cfg: SimConfig,
    timestep,
    generator: Optional[torch.Generator] = None,
    step_fn: Optional[Callable] = None,  # e.g. an autoreset step
    collect: bool = True,
):
    """Roll all envs n_steps forward.

    ``policy_fn`` gets ``generator`` and the previous step's obs; without
    ``step_fn`` the envs step with ``batch_step``, whose scan noise also
    comes from ``generator``. Returns (final_states, Transition stacked
    over T) when collect=True, else (final_states, (sum_reward,
    num_dones)), the no-materialization path for throughput runs.
    """
    if step_fn is None:
        def step_fn(s, a):
            return batch_step(s, a, params, map_data, tables, cfg, timestep,
                              generator)

    # the initial observation comes from the scans already in the state
    obs = {
        "scans": states.scans,
        "poses_x": states.x[..., 0],
        "poses_y": states.x[..., 1],
        "poses_theta": states.x[..., 4],
        "linear_vels_x": states.x[..., 3],
        "linear_vels_y": torch.zeros_like(states.x[..., 3]),
        "ang_vels_z": states.x[..., 5],
        "collisions": states.collisions,
        "lap_times": states.lap_times,
        "lap_counts": states.lap_counts,
    }
    steps = []
    for _ in range(n_steps):
        actions = policy_fn(generator, obs)
        states, nobs, reward, done, _ = step_fn(states, actions)
        nobs = dict(nobs)
        nobs.pop("ego_idx", None)
        steps.append(Transition(obs=obs, action=actions, reward=reward,
                                done=done) if collect
                     else (torch.sum(reward), torch.sum(done)))
        obs = nobs
    if not collect:
        return states, (torch.stack([r for r, _ in steps]).sum(),
                        torch.stack([d for _, d in steps]).sum())
    return states, Transition(
        obs={k: torch.stack([t.obs[k] for t in steps]) for k in steps[0].obs},
        action=torch.stack([t.action for t in steps]),
        reward=torch.stack([t.reward for t in steps]),
        done=torch.stack([t.done for t in steps]))
