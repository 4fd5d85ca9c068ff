"""Numeric kernels: dynamics, lidar, collision and the scan kernel's host
side, under the names of the JAX package's ``ops/__init__.py``."""

from f1tenth_gym_tpu_torch.ops.dynamics import (
    accl_constraints,
    euler_step,
    pid,
    rk4_step,
    steering_constraint,
    vehicle_dynamics_ks5,
    vehicle_dynamics_ks7,
    vehicle_dynamics_st,
)
from f1tenth_gym_tpu_torch.ops.lidar import (
    add_scan_noise,
    beam_theta_indices,
    check_ttc,
    dt_lookup,
    get_scan,
    make_scan_tables,
)
from f1tenth_gym_tpu_torch.ops.collision import (
    collision_multiple,
    collision_pairwise,
    get_vertices,
    ray_cast_opponents,
)
from f1tenth_gym_tpu_torch.ops.scan_kernel import (
    build_seg_table,
    scan_pallas,
    scan_pallas_vmappable,
)

__all__ = [
    "accl_constraints",
    "steering_constraint",
    "vehicle_dynamics_ks5",
    "vehicle_dynamics_ks7",
    "vehicle_dynamics_st",
    "pid",
    "euler_step",
    "rk4_step",
    "make_scan_tables",
    "dt_lookup",
    "beam_theta_indices",
    "get_scan",
    "add_scan_noise",
    "check_ttc",
    "get_vertices",
    "collision_pairwise",
    "collision_multiple",
    "ray_cast_opponents",
    "build_seg_table",
    "scan_pallas",
    "scan_pallas_vmappable",
]
