"""Reference-compatible stateful environment API.

Port of ``f1tenth_gym_tpu/envs/gym_api.py``. ``F110Env`` mirrors the
reference's Gym env surface (f110_env.py:53-418): the same constructor
kwargs, the same ``reset(poses) -> (obs, reward, done, info)`` 4-tuple,
the same observation keys (docs/api/obv.rst), ``update_map``,
``update_params``, ``add_render_callback`` and ``render`` (pygame,
``render/renderer.py``). It is a thin host shell
around ``core/env.py`` stepping one env (E = 1) on the card, or on the CPU
with ``device="cpu"``; the scan noise comes from a ``torch.Generator``
seeded from ``seed`` at every reset.

``F110GymnasiumEnv`` is the Gymnasium-API variant (5-tuple step, spaces,
options-reset). It needs gymnasium: without it the class exists but cannot
be built, and ``register_gymnasium`` registers nothing. The id is
``f1tenth_tpu_torch/f110-v0``, so it does not collide with the JAX
package's ``f1tenth_tpu/f110-v0`` when both are imported.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from f1tenth_gym_tpu_torch.config import (
    DEFAULT_SEED,
    DEFAULT_TIMESTEP,
    INTEGRATOR_EULER,
    INTEGRATOR_RK4,
    MODEL_ST,
    SimConfig,
    resolve_device,
)
from f1tenth_gym_tpu_torch.core.env import env_reset, env_step
from f1tenth_gym_tpu_torch.ops.lidar import make_scan_tables
from f1tenth_gym_tpu_torch.parallel.vector import make_generator
from f1tenth_gym_tpu_torch.state import VehicleParams
from f1tenth_gym_tpu_torch.utils.map_loader import load_map

GYMNASIUM_ID = "f1tenth_tpu_torch/f110-v0"


def _normalize_integrator(integrator) -> str:
    if isinstance(integrator, str):
        s = integrator.lower()
    else:  # enum-like (reference Integrator.RK4 / .Euler)
        s = getattr(integrator, "name", str(integrator)).lower()
    if s in (INTEGRATOR_RK4, INTEGRATOR_EULER):
        return s
    raise ValueError(f"unknown integrator {integrator!r}; use 'rk4' or 'euler'")


def _host(v):
    """One env's value as numpy (the E axis dropped)."""
    return v[0].cpu().numpy() if isinstance(v, torch.Tensor) else v


class F110Env:
    """Stateful, single-instance environment with the reference's API.

    kwargs (all optional, defaults match f110_env.py:102-159):
        seed, map, map_ext, params, num_agents, timestep, ego_idx,
        integrator, lidar_dist, model, num_beams, scan_noise, scan_engine,
        dtype, device

    ``device`` defaults to the card. ``scan_engine`` defaults to "auto":
    the CUDA kernel on the card, the marching engine on the CPU (see
    SimConfig); "pallas" is taken as "kernel". ``timestep`` is read at
    each ``reset``.
    """

    metadata = {"render.modes": ["human", "human_fast", "rgb_array"]}

    def __init__(self, **kwargs):
        self.seed = kwargs.get("seed", DEFAULT_SEED)
        self.map_name = kwargs.get("map", None)
        self.map_ext = kwargs.get("map_ext", ".png")
        params = kwargs.get("params", None)
        self.num_agents = kwargs.get("num_agents", 2)
        self.timestep = kwargs.get("timestep", DEFAULT_TIMESTEP)
        self.ego_idx = kwargs.get("ego_idx", 0)
        integrator = _normalize_integrator(kwargs.get("integrator",
                                                      INTEGRATOR_RK4))
        lidar_dist = kwargs.get("lidar_dist", 0.0)
        model = kwargs.get("model", MODEL_ST)
        num_beams = kwargs.get("num_beams", 1080)
        scan_noise = kwargs.get("scan_noise", True)
        scan_engine = kwargs.get("scan_engine", "auto")
        dtype = kwargs.get("dtype", "float32")
        self.device = resolve_device(kwargs.get("device", None))

        if self.map_name is None:
            raise ValueError(
                "a map is required: pass map='/path/to/map_yaml' (with or "
                "without the .yaml extension) and map_ext for the image")

        self.cfg = SimConfig(
            num_agents=self.num_agents,
            num_beams=num_beams,
            ego_idx=self.ego_idx,
            integrator=integrator,
            model=model,
            scan_noise=scan_noise,
            scan_engine=scan_engine,
            dtype=dtype,
        )
        tdtype = self.cfg.torch_dtype

        # vehicle params as (A,) leaves so that one agent's can change
        base = VehicleParams.create(params, dtype=tdtype, device=self.device)
        self.params = VehicleParams(**{
            k: getattr(base, k).expand(self.num_agents).clone()
            for k in base.__dataclass_fields__})
        self.tables = make_scan_tables(
            num_beams=num_beams, lidar_dist=lidar_dist,
            width=float(base.width), lf=float(base.lf), lr=float(base.lr),
            dtype=tdtype, device=self.device)
        self.map_data = self._load_map(self.map_name, self.map_ext)

        self.state = None
        self.render_obs = None
        self.render_callbacks = []
        self.renderer = None
        self.current_time = 0.0
        self._generator = None
        self._timestep = None

    # ------------------------------------------------------------- helpers
    def _wants_segments(self) -> bool:
        """Whether the scan engine needs the map's wall segments: whether
        it is anything but the march on a map that has them."""
        return self.cfg.resolved_scan_engine(self.device, True) != "march"

    def _load_map(self, map_path, map_ext):
        return load_map(map_path, map_ext, dtype=self.cfg.torch_dtype,
                        extract_segments=self._wants_segments(),
                        device=self.device)

    def _finish(self, out):
        self.state, obs, reward, done, info = out
        obs = {k: _host(v) for k, v in obs.items()}
        self.current_time = float(self.state.current_time[0])
        self._update_render_obs(obs)
        return (obs, float(reward[0]), bool(done[0]),
                {k: _host(v) for k, v in info.items()})

    # ------------------------------------------------------------- gym API
    def reset(self, poses):
        """Reset to (num_agents, 3) poses. Returns (obs, reward, done, info)."""
        poses = np.asarray(poses, dtype=np.float64)
        if poses.shape != (self.num_agents, 3):
            raise ValueError(
                f"poses shape {poses.shape} != ({self.num_agents}, 3)")
        self._generator = make_generator(self.device, self.seed)
        self._timestep = torch.as_tensor(self.timestep,
                                         dtype=self.cfg.torch_dtype,
                                         device=self.device)
        poses = torch.as_tensor(poses, dtype=self.cfg.torch_dtype)
        return self._finish(env_reset(
            poses[None].to(self.device), self.params, self.map_data,
            self.tables, self.cfg, self._timestep, self._generator))

    def step(self, action):
        """Step with (num_agents, 2) [steer, speed] actions."""
        if self.state is None:
            raise RuntimeError("call reset(poses) before step()")
        action = torch.as_tensor(np.asarray(action),
                                 dtype=self.cfg.torch_dtype)
        return self._finish(env_step(
            self.state, action[None].to(self.device), self.params,
            self.map_data, self.tables, self.cfg, self._timestep,
            self._generator))

    def update_map(self, map_path, map_ext):
        """Swap the track (f110_env.py:351-362)."""
        self.map_name = map_path
        self.map_ext = map_ext
        self.map_data = self._load_map(map_path, map_ext)
        if self.renderer is not None:
            self.renderer.update_map(map_path, map_ext)

    def update_params(self, params: Dict[str, Any], index: int = -1):
        """Update vehicle params (f110_env.py:364-375): every agent's, or
        only agent ``index``'s."""
        self.params = self.params.replace_params(params, agent_idx=index)

    def add_render_callback(self, callback_func):
        self.render_callbacks.append(callback_func)

    def _update_render_obs(self, obs):
        self.render_obs = {k: obs[k] for k in (
            "ego_idx", "poses_x", "poses_y", "poses_theta", "lap_times",
            "lap_counts")}

    def render(self, mode: str = "human"):
        """Draw the last observation on the host (f110_env.py:387-418):
        a window for "human" and "human_fast", an (H, W, 3) uint8 frame
        for "rgb_array". The renderer (pygame) is built at the first call."""
        if mode not in ("human", "human_fast", "rgb_array"):
            raise ValueError(f"unknown render mode {mode!r}")
        if self.renderer is None:
            from f1tenth_gym_tpu_torch.render.renderer import EnvRenderer

            self.renderer = EnvRenderer(
                headless=(mode == "rgb_array"),
                car_length=float(self.params.length.max()),
                car_width=float(self.params.width.max()),
            )
            self.renderer.update_map(self.map_name, self.map_ext)
        self.renderer.update_obs(self.render_obs)
        for cb in self.render_callbacks:
            cb(self.renderer)
        frame = self.renderer.draw(return_array=(mode == "rgb_array"))
        if mode == "human":
            time.sleep(0.005)
        return frame

    def close(self):
        if self.renderer is not None:
            self.renderer.close()
            self.renderer = None


try:  # gymnasium.make requires inheriting gymnasium.Env
    import gymnasium as _gymnasium

    _GymnasiumBase = _gymnasium.Env
except ImportError:  # pragma: no cover
    _GymnasiumBase = object


class F110GymnasiumEnv(_GymnasiumBase):
    """Gymnasium-flavored wrapper: 5-tuple step, spaces, options-reset."""

    metadata = {"render_modes": ["human", "human_fast", "rgb_array"]}

    def __init__(self, render_mode: Optional[str] = None, **kwargs):
        from gymnasium import spaces

        self._env = F110Env(**kwargs)
        self.render_mode = render_mode
        A, B = self._env.num_agents, self._env.cfg.num_beams
        # spaces declare the sim dtype, and observations are cast to it
        dt = np.dtype(self._env.cfg.dtype)
        self._np_dtype = dt
        big = np.finfo(dt).max
        prm = {k: getattr(self._env.params, k).cpu().numpy()
               for k in ("s_min", "s_max", "v_min", "v_max")}
        self.action_space = spaces.Box(
            low=np.tile(np.array([prm["s_min"].min(), prm["v_min"].min()],
                                 dtype=dt), (A, 1)),
            high=np.tile(np.array([prm["s_max"].max(), prm["v_max"].max()],
                                  dtype=dt), (A, 1)),
            dtype=dt,
        )
        # scans: max_range clamp + additive Gaussian noise (sigma = 0.01)
        # applied post-clamp can push a beam slightly outside [0, max_range]
        max_range = float(self._env.tables.max_range)
        self.observation_space = spaces.Dict({
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
        self._default_poses = None

    def _host_obs_cast(self, obs):
        obs.pop("ego_idx", None)
        return {k: np.asarray(v, dtype=self._np_dtype) for k, v in obs.items()}

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        if seed is not None:
            self._env.seed = seed
        poses = None if options is None else options.get("poses", None)
        if poses is None:
            poses = self._default_poses
        if poses is None:
            poses = np.zeros((self._env.num_agents, 3))
        self._default_poses = poses
        obs, _, _, info = self._env.reset(poses)
        return self._host_obs_cast(obs), info

    def step(self, action):
        obs, reward, done, info = self._env.step(action)
        if self.render_mode in ("human", "human_fast"):
            self._env.render(self.render_mode)
        return self._host_obs_cast(obs), reward, bool(done), False, info

    def render(self):
        return self._env.render(self.render_mode or "rgb_array")

    def close(self):
        self._env.close()


def register_gymnasium() -> bool:
    """Register ``f1tenth_tpu_torch/f110-v0`` with gymnasium when it is
    importable; returns whether the id is registered."""
    try:
        import gymnasium
    except ImportError:  # pragma: no cover
        return False
    if GYMNASIUM_ID not in gymnasium.registry:
        gymnasium.register(
            id=GYMNASIUM_ID,
            entry_point="f1tenth_gym_tpu_torch.envs.gym_api:F110GymnasiumEnv")
    return True
