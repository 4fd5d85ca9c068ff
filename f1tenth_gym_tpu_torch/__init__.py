"""f1tenth_gym_tpu_torch — the F1TENTH racing simulator on PyTorch and CUDA.

A port of the JAX package ``f1tenth_gym_tpu`` (which stays the reference)
to PyTorch, with its TPU kernels rewritten by hand for NVIDIA Hopper. It
imports torch, numpy and scipy only. Entry points run on the card unless
the caller passes ``device="cpu"``.
"""

from f1tenth_gym_tpu_torch.version import __version__
from f1tenth_gym_tpu_torch.config import (
    DEFAULT_PARAMS,
    INTEGRATOR_EULER,
    INTEGRATOR_RK4,
    MODEL_KS,
    MODEL_ST,
    Integrator,
    SimConfig,
    resolve_device,
)
from f1tenth_gym_tpu_torch.core.env import (
    env_reset,
    env_step,
    init_state,
    make_env_fns,
)
from f1tenth_gym_tpu_torch.core.simulator import sim_step
from f1tenth_gym_tpu_torch.ops.lidar import make_scan_tables
from f1tenth_gym_tpu_torch.parallel.vector import (
    batch_reset,
    batch_step,
    make_autoreset_step,
    make_generator,
    sort_envs_for_locality,
    uniform_pose_sampler,
)
from f1tenth_gym_tpu_torch.scan_sim import ScanSimulator2D
from f1tenth_gym_tpu_torch.state import MapData, ScanTables, SimState, VehicleParams
from f1tenth_gym_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from f1tenth_gym_tpu_torch.utils.map_loader import load_map, make_map_data

__all__ = [
    "__version__",
    "DEFAULT_PARAMS",
    "INTEGRATOR_EULER",
    "INTEGRATOR_RK4",
    "Integrator",
    "MODEL_KS",
    "MODEL_ST",
    "MapData",
    "ScanSimulator2D",
    "ScanTables",
    "SimConfig",
    "SimState",
    "VehicleParams",
    "batch_reset",
    "batch_step",
    "env_reset",
    "env_step",
    "init_state",
    "load_map",
    "load_pytree",
    "make_autoreset_step",
    "make_env_fns",
    "make_generator",
    "make_map_data",
    "make_scan_tables",
    "resolve_device",
    "save_pytree",
    "sim_step",
    "sort_envs_for_locality",
    "uniform_pose_sampler",
]
