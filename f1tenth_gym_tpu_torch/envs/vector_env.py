"""Gymnasium ``VectorEnv`` adapter: thousands of envs behind numpy IO.

Port of ``f1tenth_gym_tpu/envs/vector_env.py``. The batch is one set of
tensors stepped in lockstep on the device (``parallel/vector.py``); this
adapter wraps it in the standard ``gymnasium.vector.VectorEnv`` interface
so off-the-shelf RL stacks (CleanRL, SB3 via compatibility shims, ...)
consume the batch without writing any torch.

Autoreset follows Gymnasium's NEXT_STEP convention: the step after a
termination ignores that env's action and returns its reset observation,
produced by a zero-action step from the start pose, which is the
reference's ``reset()`` (f110_env.py:337-338: reset IS a zero-action
step).

gymnasium is optional: without it the module imports, the class exists
and cannot be built, and ``register_gymnasium_vector`` registers nothing.
Every step copies the obs dict (notably scans, E x A x num_beams) to the
host: that is the price of the numpy API. Keep rollouts on the device
with ``parallel.rollout`` / ``make_autoreset_step`` when the policy is
torch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from f1tenth_gym_tpu_torch.config import DEFAULT_TIMESTEP, SimConfig, resolve_device
from f1tenth_gym_tpu_torch.envs.gym_api import GYMNASIUM_ID
from f1tenth_gym_tpu_torch.maps import map_path
from f1tenth_gym_tpu_torch.ops.lidar import make_scan_tables
from f1tenth_gym_tpu_torch.parallel.vector import (
    batch_reset,
    make_autoreset_step,
    make_generator,
    uniform_pose_sampler,
)
from f1tenth_gym_tpu_torch.state import VehicleParams
from f1tenth_gym_tpu_torch.utils.map_loader import load_map

try:
    import gymnasium
    from gymnasium import spaces
    from gymnasium.vector import VectorEnv as _VectorBase
    from gymnasium.vector.utils import batch_space
except ImportError:  # pragma: no cover
    gymnasium = None
    _VectorBase = object


class F110VectorEnv(_VectorBase):
    """E lockstep racing envs as one batch on ``device`` (default: the
    card).

    Parameters mirror ``F110Env`` kwargs plus:
        num_envs: batch size E.
        poses: optional (E, A, 3) fixed start grid. Default: uniform
            corridor spawns (grouped start grid, corridor-aligned headings)
            sampled from the map's free space.
        seed: seed of the spawn sampler, and of the scan noise at each
            ``reset``.

    ``reset`` and autoreset return each env to its own start grid
    (reference reset semantics); pass ``options={'poses': ...}`` to move
    the grid.
    """

    metadata: Dict[str, Any] = {"render_modes": []}

    def __init__(self, num_envs: int = 256, map: Optional[str] = None,
                 map_ext: str = ".png", num_agents: int = 2,
                 num_beams: int = 1080, timestep: float = DEFAULT_TIMESTEP,
                 params: Optional[Dict[str, Any]] = None,
                 poses: Optional[np.ndarray] = None, seed: int = 0,
                 scan_engine: str = "auto", dtype: str = "float32",
                 device=None, **cfg_kwargs):
        if gymnasium is None:  # pragma: no cover
            raise ImportError("F110VectorEnv requires gymnasium")
        from gymnasium.vector import AutoresetMode

        self.metadata = dict(self.metadata,
                             autoreset_mode=AutoresetMode.NEXT_STEP)
        self.device = resolve_device(device)
        if map is None:
            map = map_path("example_map")
        self.cfg = SimConfig(num_agents=num_agents, num_beams=num_beams,
                             dtype=dtype, scan_engine=scan_engine,
                             **cfg_kwargs)
        td = self.cfg.torch_dtype
        self.params = VehicleParams.create(params, dtype=td, device=self.device)
        self.tables = make_scan_tables(num_beams=num_beams, dtype=td,
                                       device=self.device)
        engine = self.cfg.resolved_scan_engine(self.device, True)
        self.map_data = load_map(
            map, map_ext, dtype=td, extract_segments=engine != "march",
            tile_culling=engine == "kernel", device=self.device)
        self.timestep = float(timestep)
        self.num_envs = int(num_envs)
        self._seed = seed

        if poses is not None:
            poses = np.asarray(poses)
            if poses.shape != (num_envs, num_agents, 3):
                raise ValueError(
                    f"poses must be ({num_envs}, {num_agents}, 3), "
                    f"got {poses.shape}")
            self._poses = torch.as_tensor(poses, dtype=td, device=self.device)
        else:
            sampler = uniform_pose_sampler(self.map_data, clearance=0.6,
                                           grouped=True, align_theta=True)
            self._poses = sampler(make_generator(self.device, seed),
                                  (num_envs, num_agents))
        # the step's generator is re-seeded at every reset
        self._generator = make_generator(self.device, seed)
        self._astep = make_autoreset_step(
            self.params, self.map_data, self.tables, self.cfg, self.timestep,
            reset_to_start=True, generator=self._generator,
            device=self.device)
        self._states = None
        self._pending_reset = np.zeros(num_envs, bool)

        A, B = num_agents, num_beams
        dt = np.dtype(dtype)
        big = np.finfo(dt).max
        max_range = float(self.tables.max_range)
        prm = {k: getattr(self.params, k).cpu().numpy()
               for k in ("s_min", "s_max", "v_min", "v_max")}
        self.single_action_space = spaces.Box(
            low=np.tile(np.array([prm["s_min"].min(), prm["v_min"].min()],
                                 dtype=dt), (A, 1)),
            high=np.tile(np.array([prm["s_max"].max(), prm["v_max"].max()],
                                  dtype=dt), (A, 1)),
            dtype=dt)
        self.single_observation_space = spaces.Dict({
            "scans": spaces.Box(-1.0, max_range + 1.0, (A, B), dt),
            "poses_x": spaces.Box(-big, big, (A,), dt),
            "poses_y": spaces.Box(-big, big, (A,), dt),
            "poses_theta": spaces.Box(-big, big, (A,), dt),
            "linear_vels_x": spaces.Box(-big, big, (A,), dt),
            "linear_vels_y": spaces.Box(-big, big, (A,), dt),
            "ang_vels_z": spaces.Box(-big, big, (A,), dt),
            "collisions": spaces.Box(0.0, 1.0, (A,), dt),
            "lap_times": spaces.Box(0.0, big, (A,), dt),
            "lap_counts": spaces.Box(0.0, big, (A,), dt),
        })
        self.action_space = batch_space(self.single_action_space, num_envs)
        self.observation_space = batch_space(self.single_observation_space,
                                             num_envs)
        self._np_dtype = dt

    def _host_obs(self, obs) -> Dict[str, np.ndarray]:
        obs.pop("ego_idx", None)
        return {k: np.asarray(v.cpu().numpy(), dtype=self._np_dtype)
                for k, v in obs.items()}

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._seed = seed
        if options and options.get("poses") is not None:
            self._poses = torch.as_tensor(np.asarray(options["poses"]),
                                          dtype=self.cfg.torch_dtype,
                                          device=self.device)
        self._generator.manual_seed(self._seed)
        self._states, obs, _, _, _ = batch_reset(
            self._poses, self.params, self.map_data, self.tables, self.cfg,
            self.timestep, generator=self._generator, device=self.device)
        self._pending_reset[:] = False
        return self._host_obs(obs), {}

    def step(self, actions):
        if self._states is None:
            raise RuntimeError("call reset() before step()")
        a = torch.as_tensor(np.asarray(actions), dtype=self.cfg.torch_dtype,
                            device=self.device)
        if self._pending_reset.any():
            # NEXT_STEP autoreset: a freshly reset env ignores the incoming
            # action; its spawn step is the reference's zero-action reset
            mask = torch.as_tensor(self._pending_reset,
                                   device=self.device)[:, None, None]
            a = torch.where(mask, torch.zeros_like(a), a)
        self._states, obs, reward, done, _ = self._astep(self._states, a)
        done_np = done.cpu().numpy().astype(bool)
        rewards = np.where(self._pending_reset, 0.0,
                           reward.cpu().numpy().astype(np.float64))
        terminations = done_np & ~self._pending_reset
        # pending tracks "this step REPORTED a termination" (so the next
        # step is that env's reset/spawn step); tracking raw done instead
        # would swallow for good the terminations of an env whose spawn
        # state is itself terminal (an overlapping start grid): such an env
        # alternates report/reset, 1-step episodes
        self._pending_reset = terminations.copy()
        truncations = np.zeros(self.num_envs, bool)
        return (self._host_obs(obs), rewards, terminations, truncations, {})

    def close(self, **kwargs):
        self._states = None


def register_gymnasium_vector() -> bool:
    """Attach the vector entry point to the port's registration
    ``f1tenth_tpu_torch/f110-v0`` when gymnasium is available; returns
    whether it is attached."""
    if gymnasium is None:  # pragma: no cover
        return False
    spec = gymnasium.registry.get(GYMNASIUM_ID)
    if spec is None:
        return False
    if not spec.vector_entry_point:
        spec.vector_entry_point = (
            "f1tenth_gym_tpu_torch.envs.vector_env:F110VectorEnv")
    return True
