"""Containers of the port: dataclasses of tensors with an explicit env axis.

Port of ``f1tenth_gym_tpu/state.py`` (``VehicleParams``, ``MapData``,
``ScanTables``, ``SimState`` and the ``IX_*`` state layout). The JAX
package stores one env per pytree and gets its env axis from ``vmap``;
here every per-env leaf of ``SimState`` carries a leading E axis and every
per-agent leaf an A axis after it, because a hand-written kernel cannot be
vmapped.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from f1tenth_gym_tpu_torch.config import DEFAULT_PARAMS, resolve_device

# State vector layout (reference: base_classes.py:97 comment)
#   [x, y, steer_angle, vel, yaw_angle, yaw_rate, slip_angle]
IX_X = 0
IX_Y = 1
IX_STEER = 2
IX_VEL = 3
IX_YAW = 4
IX_YAW_RATE = 5
IX_SLIP = 6
STATE_DIM = 7


@dataclasses.dataclass
class VehicleParams:
    """The 18 vehicle parameters of the reference (f110_env.py:130).

    Each leaf is a 0-d tensor, an (A,) tensor of per-agent values or an
    (E, 1) tensor of per-env values (what ``vmap`` over params gives in the
    JAX package; ``examples/param_sweep.py`` steps so); all broadcast
    against (E, A) state tensors through the dynamics, the collision boxes
    and the step. The scan tables take width, lf and lr once, as scalars.
    """

    mu: torch.Tensor
    C_Sf: torch.Tensor
    C_Sr: torch.Tensor
    lf: torch.Tensor
    lr: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor
    I: torch.Tensor
    s_min: torch.Tensor
    s_max: torch.Tensor
    sv_min: torch.Tensor
    sv_max: torch.Tensor
    v_switch: torch.Tensor
    a_max: torch.Tensor
    v_min: torch.Tensor
    v_max: torch.Tensor
    width: torch.Tensor
    length: torch.Tensor

    @classmethod
    def create(cls, params: Optional[Dict[str, Any]] = None,
               dtype=torch.float32, device=None) -> "VehicleParams":
        dev = resolve_device(device)
        d = dict(DEFAULT_PARAMS)
        if params:
            d.update(params)
        return cls(**{k: torch.as_tensor(d[k], dtype=dtype, device=dev)
                      for k in DEFAULT_PARAMS})

    def replace_params(self, params: Dict[str, Any],
                       agent_idx: int = -1) -> "VehicleParams":
        """A copy with ``params`` updated (state.py:77-98 of the JAX
        package): every agent's value when ``agent_idx`` < 0, else only
        that agent's entry of an (A,) leaf. A 0-d leaf cannot take a
        per-agent value: create the params with (A,) leaves first."""
        updates = {}
        for k, v in params.items():
            cur = getattr(self, k)
            new = torch.as_tensor(v, dtype=cur.dtype, device=cur.device)
            if agent_idx < 0:
                updates[k] = new.expand(cur.shape).clone()
            else:
                if cur.dim() == 0:
                    raise ValueError(
                        f"Per-agent update of scalar param '{k}': create "
                        "VehicleParams with (A,)-shaped leaves first")
                leaf = cur.clone()
                leaf[agent_idx] = new
                updates[k] = leaf
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass
class MapData:
    """Occupancy map raster, its distance transform and the scan tables.

    Tensor fields live on the map's device. ``tile_meta_host`` is the
    host copy of ``tile_meta`` ([x0, y0, 1/tile_size, nx, ny, kind]); the
    decisions that depend on the pack are taken on it when the map is
    built, never with a device read inside a step.
    """

    dt: torch.Tensor          # (H, W) distance-to-obstacle in meters
    orig_x: torch.Tensor      # 0-d
    orig_y: torch.Tensor
    orig_c: torch.Tensor      # cos(origin theta)
    orig_s: torch.Tensor      # sin(origin theta)
    resolution: torch.Tensor  # 0-d, m/cell
    segments: Optional[torch.Tensor] = None      # (K, 4) sim dtype
    seg_table: Optional[torch.Tensor] = None     # (Kf, 8) f32
    # culled window pack (ops/culling.py TileTables, v9)
    tile_tables: Optional[torch.Tensor] = None   # (n_blocks, Kt, 8) f32
    tile_ngroups: Optional[torch.Tensor] = None  # (n_blocks + 1,) i32
    tile_meta: Optional[torch.Tensor] = None     # (6,) f32
    tile_blockmap: Optional[torch.Tensor] = None  # (4 * n_tiles,) i32
    tile_ext: Optional[torch.Tensor] = None      # (n_blocks, 64) i32
    cull_eligible: Optional[torch.Tensor] = None  # (H, W) uint8
    tile_meta_host: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        # erosion guard (ops/pallas_scan.py:478-486): an erosion-gated pack
        # (meta slot 5 == 8) is only exact with its eligibility raster
        if (self.tile_tables is not None and self.cull_eligible is None
                and self.tile_meta_host is not None
                and self.tile_meta_host[5] >= 8):
            raise ValueError(
                "erosion-gated culling pack used without its eligibility "
                "raster: MapData.cull_eligible is required")

    @property
    def height(self) -> int:
        return self.dt.shape[0]

    @property
    def width(self) -> int:
        return self.dt.shape[1]

    @property
    def device(self) -> torch.device:
        return self.dt.device


@dataclasses.dataclass
class ScanTables:
    """Precomputed LiDAR geometry (laser_models.py:378-381,
    base_classes.py:125-158)."""

    sines: torch.Tensor            # (theta_dis,)
    cosines: torch.Tensor          # (theta_dis,)
    scan_angles: torch.Tensor      # (num_beams,)
    beam_cosines: torch.Tensor     # (num_beams,)
    side_distances: torch.Tensor   # (num_beams,)
    fov: torch.Tensor              # 0-d
    theta_index_increment: torch.Tensor
    max_range: torch.Tensor
    eps: torch.Tensor
    scan_std: torch.Tensor
    ttc_thresh: torch.Tensor
    lidar_dist: torch.Tensor


@dataclasses.dataclass
class SimState:
    """Dynamic state of E envs of A agents each.

    Per-agent leaves are (E, A, ...), per-env leaves (E, ...).
    """

    x: torch.Tensor            # (E, A, 7)
    steer_buf: torch.Tensor    # (E, A, 2) steering delay FIFO
    collisions: torch.Tensor   # (E, A) float 0/1
    collision_idx: torch.Tensor  # (E, A) float, -1 when not colliding
    scans: torch.Tensor        # (E, A, num_beams)
    lap_times: torch.Tensor    # (E, A)
    lap_counts: torch.Tensor   # (E, A)
    toggle_list: torch.Tensor  # (E, A)
    near_starts: torch.Tensor  # (E, A) bool
    start_xs: torch.Tensor     # (E, A)
    start_ys: torch.Tensor     # (E, A)
    start_thetas: torch.Tensor  # (E, A)
    start_rot: torch.Tensor    # (E, 2, 2)
    current_time: torch.Tensor  # (E,)
    steps: torch.Tensor        # (E,) int32

    @property
    def num_envs(self) -> int:
        return self.x.shape[0]

    @property
    def num_agents(self) -> int:
        return self.x.shape[1]

    @property
    def poses(self) -> torch.Tensor:
        """(E, A, 3) [x, y, yaw] poses."""
        return self.x[..., [IX_X, IX_Y, IX_YAW]]

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "SimState":
        """Apply ``fn`` to every leaf (all leaves lead with the E axis)."""
        return SimState(**{f.name: fn(getattr(self, f.name))
                           for f in dataclasses.fields(self)})
