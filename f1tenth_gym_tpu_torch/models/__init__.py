"""Vehicle dynamics model families.

Port of ``f1tenth_gym_tpu/models/__init__.py``: a registry keyed by name
over the port's ``ops/dynamics.py``. Each model maps ``(x7, u2, params) ->
dx7`` in the shared 7-state layout [x, y, steer, vel, yaw, yaw_rate, slip],
on tensors with any leading batch axes.
"""

from f1tenth_gym_tpu_torch.config import MODEL_KS, MODEL_ST
from f1tenth_gym_tpu_torch.ops.dynamics import (
    vehicle_dynamics_ks7,
    vehicle_dynamics_st,
)

MODEL_REGISTRY = {
    MODEL_ST: vehicle_dynamics_st,
    MODEL_KS: vehicle_dynamics_ks7,
}


def get_model(name: str):
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model '{name}'; available: {sorted(MODEL_REGISTRY)}"
        ) from None


__all__ = ["MODEL_REGISTRY", "get_model", "MODEL_ST", "MODEL_KS"]
