"""The opponent clip of the racing step: each agent's scan clipped by the
other agents' car boxes.

``opp_clip`` is what ``core/simulator.py::sim_step`` calls once its scans
and the iTTC zeroing are done. For tensors on the card it launches the
hand-written CUDA kernel ``csrc/opp_clip_kernel.cu`` (K3; see its header
for the design and the bound on the H100): one launch that computes
``ray_cast_opponents`` (``ops/collision.py``) bit for bit, in float32 and
float64, and picks every agent's opponents itself. For tensors on the CPU
it runs the plain version ``opp_clip_plain``: the opponents' boxes
gathered and ``ray_cast_opponents`` as it is, the pass the step made
before the kernel existed.

K3 replaces no TPU kernel: the JAX package clips with XLA ops in
``ray_cast_opponents``, and its Pallas ``_overlay_kernel`` (the port's K2,
``ops/overlay_kernel.py``) leaves out that pass's collinear fallback and
rounds windows otherwise.

The kernel is declared in ``utils/cuda_build.py`` (``K3``), which builds
it with ``nvcc`` at its first launch and binds it with ``ctypes``;
importing this module builds nothing.
"""

from __future__ import annotations

import torch

from f1tenth_gym_tpu_torch.ops import collision as col_ops
from f1tenth_gym_tpu_torch.state import IX_X, IX_Y, IX_YAW, ScanTables
from f1tenth_gym_tpu_torch.utils import cuda_build

_DTYPES = (torch.float32, torch.float64)


def opp_clip_plain(x: torch.Tensor, scans: torch.Tensor,
                   vertices: torch.Tensor, tables: ScanTables
                   ) -> torch.Tensor:
    """The clip in torch ops, on any device: x (..., A, 7) the states
    after the iTTC zeroing, scans (..., A, B), vertices (..., A, 4, 2)
    every agent's box from before it. Row i of ``opp_idx``: the agents
    other than i, ascending, made on the tensors' device so that indexing
    copies nothing to the card."""
    A = x.shape[-2]
    poses = torch.stack([x[..., IX_X], x[..., IX_Y], x[..., IX_YAW]], -1)
    k = torch.arange(A - 1, device=x.device)
    opp_idx = k + (k >= torch.arange(A, device=x.device)[:, None])
    return col_ops.ray_cast_opponents(poses, scans,
                                      vertices[..., opp_idx, :, :], tables)


# --------------------------------------------------------------------------
# CUDA kernel: build, launch (declared in utils/cuda_build.py)
# --------------------------------------------------------------------------

KERNEL = cuda_build.K3


def build_cuda() -> str:
    """Compile ``csrc/opp_clip_kernel.cu`` for sm_90a into ``_build/``;
    returns the compiler's resource report (``utils/cuda_build.py``)."""
    return KERNEL.build()


def _check_inputs(x, scans, vertices, tables):
    """What K3 takes: one float dtype and device for all four, contiguous,
    at least two agents and two beams, shapes that agree."""
    angles = tables.scan_angles
    dev, dt = scans.device, scans.dtype
    if dt not in _DTYPES:
        raise ValueError(f"opponent clip: scans are {dt}, need float32 or "
                         "float64")
    for name, t in (("x", x), ("vertices", vertices),
                    ("scan_angles", angles)):
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"opponent clip: {name} is {t.dtype} on "
                             f"{t.device}, the scans {dt} on {dev}")
    for name, t in (("scans", scans), ("x", x), ("vertices", vertices),
                    ("scan_angles", angles)):
        if not t.is_contiguous():
            raise ValueError(f"opponent clip: {name} is not contiguous")
    lead, B = scans.shape[:-1], scans.shape[-1]
    if (scans.dim() < 2 or x.shape[:-1] != lead
            or x.shape[-1] <= max(IX_X, IX_Y, IX_YAW)
            or vertices.shape != lead + (4, 2) or angles.shape != (B,)):
        raise ValueError(
            f"opponent clip: shapes x {tuple(x.shape)}, scans "
            f"{tuple(scans.shape)}, vertices {tuple(vertices.shape)}, "
            f"scan_angles {tuple(angles.shape)} do not agree")
    if lead[-1] < 2 or B < 2:
        raise ValueError(f"opponent clip: {lead[-1]} agents and {B} beams; "
                         "needs two of each")


def _opp_clip_cuda(x, scans, vertices, tables) -> torch.Tensor:
    out = torch.empty_like(scans)
    B = scans.shape[-1]
    f64 = scans.dtype == torch.float64
    vec = (B % (2 if f64 else 4) == 0
           and not (scans.data_ptr() | out.data_ptr()) % 16)
    KERNEL.launch(
        scans.device, scans.data_ptr(), x.data_ptr(), vertices.data_ptr(),
        tables.scan_angles.data_ptr(), out.data_ptr(), scans.numel() // B,
        scans.shape[-2], B, x.shape[-1], IX_X, IX_Y, IX_YAW, int(f64),
        int(vec))
    opp_clip.launches += 1
    return out


def occupancy(n_scans: int, agents: int, num_beams: int,
              dtype=torch.float32) -> dict:
    """K3's launch at this shape on the current card: resident blocks an
    SM, grid blocks, scans a block, and waves (grid over resident
    blocks)."""
    return KERNEL.occupancy(int(dtype == torch.float64), n_scans, agents,
                            num_beams)


def opp_clip(x: torch.Tensor, scans: torch.Tensor, vertices: torch.Tensor,
             tables: ScanTables) -> torch.Tensor:
    """Scans clipped by the opponents' boxes (laser_models.py:282-346):
    x (..., A, 7) the states after the iTTC zeroing (the scan pose is x,
    y and yaw), scans (..., A, B), vertices (..., A, 4, 2) every agent's
    box from before the zeroing, A >= 2; each agent's opponents are the
    other agents of its env. Returns new scans. K3 for tensors on the
    card, ``opp_clip_plain`` for tensors on the CPU; ``opp_clip.launches``
    counts kernel launches."""
    _check_inputs(x, scans, vertices, tables)
    if scans.device.type == "cuda":
        return _opp_clip_cuda(x, scans, vertices, tables)
    if scans.device.type == "cpu":
        return opp_clip_plain(x, scans, vertices, tables)
    raise ValueError(f"no opponent clip kernel for device {scans.device}")


opp_clip.launches = 0
