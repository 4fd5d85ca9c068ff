from f1tenth_gym_tpu_torch.envs.gym_api import (
    GYMNASIUM_ID,
    F110Env,
    F110GymnasiumEnv,
    register_gymnasium,
)
from f1tenth_gym_tpu_torch.envs.vector_env import (
    F110VectorEnv,
    register_gymnasium_vector,
)

register_gymnasium()
register_gymnasium_vector()

__all__ = ["GYMNASIUM_ID", "F110Env", "F110GymnasiumEnv", "F110VectorEnv",
           "register_gymnasium", "register_gymnasium_vector"]
