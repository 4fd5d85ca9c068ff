from f1tenth_gym_tpu_torch.parallel.vector import (
    batch_reset,
    batch_step,
    make_autoreset_step,
    make_generator,
    sort_envs_for_locality,
    uniform_pose_sampler,
)
from f1tenth_gym_tpu_torch.parallel.rollout import Transition, rollout

__all__ = [
    "batch_reset",
    "batch_step",
    "make_autoreset_step",
    "make_generator",
    "uniform_pose_sampler",
    "sort_envs_for_locality",
    "rollout",
    "Transition",
]
