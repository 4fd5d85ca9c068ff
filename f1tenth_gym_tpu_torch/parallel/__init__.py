from f1tenth_gym_tpu_torch.parallel.vector import (
    batch_reset,
    batch_step,
    make_autoreset_step,
    make_generator,
    sort_envs_for_locality,
    uniform_pose_sampler,
)
from f1tenth_gym_tpu_torch.parallel.sharding import (
    ENV_AXIS,
    MODEL_AXIS,
    env_batch_sharding,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_env_pytree,
    shard_states,
)
from f1tenth_gym_tpu_torch.parallel.rollout import Transition, rollout
from f1tenth_gym_tpu_torch.parallel import multihost

__all__ = [
    "batch_reset",
    "batch_step",
    "make_autoreset_step",
    "make_generator",
    "uniform_pose_sampler",
    "sort_envs_for_locality",
    "make_mesh",
    "env_batch_sharding",
    "replicated_sharding",
    "shard_states",
    "shard_env_pytree",
    "replicate",
    "ENV_AXIS",
    "MODEL_AXIS",
    "rollout",
    "Transition",
    "multihost",
]
