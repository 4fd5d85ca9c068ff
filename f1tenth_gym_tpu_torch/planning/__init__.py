from f1tenth_gym_tpu_torch.planning.adversarial import FlippyPlanner, flippy_action
from f1tenth_gym_tpu_torch.planning.pure_pursuit import (
    PurePursuitPlanner,
    first_point_on_trajectory_intersecting_circle,
    get_actuation,
    nearest_point_on_trajectory,
    pure_pursuit_plan,
)

__all__ = [
    "PurePursuitPlanner",
    "pure_pursuit_plan",
    "nearest_point_on_trajectory",
    "first_point_on_trajectory_intersecting_circle",
    "get_actuation",
    "FlippyPlanner",
    "flippy_action",
]
