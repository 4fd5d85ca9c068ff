"""Static simulation configuration, default vehicle parameters, devices.

Port of ``f1tenth_gym_tpu/config.py`` (``SimConfig``, ``DEFAULT_PARAMS``,
the ``Integrator`` shim and the LiDAR defaults). The scan engines are ``"march"`` (distance-field
sphere marching, exact against the reference), ``"segments"`` (the
ray/segment scan of ``ops/segments.py`` in torch ops), ``"kernel"`` (the
hand-written CUDA ray/segment sweep of ``ops/scan_kernel.py``, plain torch
on CPU tensors) and ``"auto"``, which resolves to ``"kernel"`` on a CUDA
device when the map has a segment table and to ``"march"`` otherwise
(mirrors ``config.py:93-103`` and ``core/simulator.py:157-164``).
``"pallas"``, the JAX package's name for the kernel engine, is taken as
``"kernel"``, so code written against that package runs unchanged.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

INTEGRATOR_RK4 = "rk4"
INTEGRATOR_EULER = "euler"


class Integrator(enum.Enum):
    """Drop-in shim for reference user code that passes
    ``Integrator.RK4`` / ``Integrator.Euler`` (base_classes.py:40-42)."""

    RK4 = INTEGRATOR_RK4
    Euler = INTEGRATOR_EULER

    @property
    def name_str(self) -> str:
        return self.value


MODEL_ST = "st"  # 7-state single-track with the |v|<0.5 kinematic switch
MODEL_KS = "ks"  # kinematic bicycle embedded in the 7-state layout

SCAN_ENGINES = ("march", "segments", "kernel", "auto")


def canonical_scan_engine(name: str) -> str:
    """The port's name of scan engine ``name`` ("pallas", the JAX
    package's name, is "kernel"); raises on unknown names."""
    engine = "kernel" if name == "pallas" else name
    if engine not in SCAN_ENGINES:
        raise ValueError(f"unknown scan engine '{name}'; use one of "
                         f"{SCAN_ENGINES} or 'pallas'")
    return engine


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Hashable, static env configuration (shapes and control flow)."""

    num_agents: int = 2
    num_beams: int = 1080
    theta_dis: int = 2000
    ego_idx: int = 0
    integrator: str = INTEGRATOR_RK4
    model: str = MODEL_ST
    # cap on sphere-marching iterations (ops/lidar.py get_scan)
    max_march_iters: int = 1024
    # "march" | "segments" | "kernel" ("pallas") | "auto" (module docstring)
    scan_engine: str = "march"
    scan_noise: bool = True
    # reference quirk: every car's rng shares one seed, so all agents of an
    # env draw the same noise vector each step
    shared_agent_noise: bool = True
    dtype: str = "float32"

    def __post_init__(self):
        object.__setattr__(self, "scan_engine",
                           canonical_scan_engine(self.scan_engine))

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def resolved_scan_engine(self, device, has_seg_table: bool) -> str:
        """The engine ``"auto"`` resolves to for maps on ``device``."""
        if self.scan_engine != "auto":
            return self.scan_engine
        is_cuda = torch.device(device).type == "cuda"
        return "kernel" if is_cuda and has_seg_table else "march"


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when CUDA is asked for and absent:
    nothing quietly continues on the CPU unless the caller said ``"cpu"``.
    A CUDA device without an index gets the current one, so the result
    compares equal to the ``.device`` of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# Default vehicle parameter dict — values from reference f110_env.py:130.
DEFAULT_PARAMS = {
    "mu": 1.0489,
    "C_Sf": 4.718,
    "C_Sr": 5.4562,
    "lf": 0.15875,
    "lr": 0.17145,
    "h": 0.074,
    "m": 3.74,
    "I": 0.04712,
    "s_min": -0.4189,
    "s_max": 0.4189,
    "sv_min": -3.2,
    "sv_max": 3.2,
    "v_switch": 7.319,
    "a_max": 9.51,
    "v_min": -5.0,
    "v_max": 20.0,
    "width": 0.31,
    "length": 0.58,
}

# LiDAR defaults (reference: ScanSimulator2D.__init__, laser_models.py:360;
# RaceCar defaults, base_classes.py:69).
DEFAULT_FOV = 4.7
DEFAULT_MAX_RANGE = 30.0
DEFAULT_EPS = 0.0001
DEFAULT_SCAN_STD = 0.01
DEFAULT_TTC_THRESH = 0.005  # base_classes.py:115
DEFAULT_TIMESTEP = 0.01
DEFAULT_SEED = 12345
