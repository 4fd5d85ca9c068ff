from f1tenth_gym_tpu_torch.envs.gym_api import (
    GYMNASIUM_ID,
    F110Env,
    F110GymnasiumEnv,
    register_gymnasium,
)

register_gymnasium()

__all__ = ["GYMNASIUM_ID", "F110Env", "F110GymnasiumEnv",
           "register_gymnasium"]
