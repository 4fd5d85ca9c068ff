"""Simulator and env layer (JAX ``core/__init__.py``'s exports)."""

from f1tenth_gym_tpu_torch.core.env import env_reset, env_step, init_state, make_env_fns
from f1tenth_gym_tpu_torch.core.simulator import physics_step, sim_step

__all__ = [
    "sim_step",
    "physics_step",
    "env_step",
    "env_reset",
    "init_state",
    "make_env_fns",
]
