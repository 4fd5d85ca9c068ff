"""Opponent overlay: scans clipped by the opponents' car boxes.

Port of ``f1tenth_gym_tpu/ops/pallas_scan.py``: the host side of
``overlay_opponents_pallas`` (:838-941) and the Pallas kernel
``_overlay_kernel`` (:712-811), which becomes the hand-written CUDA C++
kernel ``csrc/overlay_kernel.cu`` (see its header for the design and the
bound on the H100). As in the JAX package, the racing step does not run
it: the step clips by opponents with ``ops/collision.py::
ray_cast_opponents``, which keeps the reference's collinear fallback that
this kernel omits. It is the independent implementation that path is
tested against.

One call is three steps:

* ``prepare_overlay`` flattens the batch and builds, in f32 and in the
  operation order of pallas_scan.py:849-937, each opponent's blocked-view
  window in closed form (``round`` half to even, the JAX package's
  ``jnp.round``, not the half-down rounding of ``ray_cast_opponents``),
  the edge rows in the segment-table format with the window in slots 6
  and 7, the per-scan scalars and the cos/sin(n * angle_inc) fan;
* ``overlay`` runs the clip on what ``prepare_overlay`` made: the CUDA
  kernel for tensors on the card, the plain version ``overlay_plain`` for
  tensors on the CPU (and only there: a CUDA tensor launches the kernel or
  raises);
* ``overlay_opponents`` chains the two and restores the batch shape.

The kernel is declared in ``utils/cuda_build.py`` (``K2``), which builds
it with ``nvcc`` at its first launch and binds it with ``ctypes``;
importing this module builds nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.state import ScanTables
from f1tenth_gym_tpu_torch.utils import cuda_build

@dataclasses.dataclass
class OverlayInputs:
    """Everything the clip reads, made by ``prepare_overlay``."""

    scans: torch.Tensor  # (n, B) f32 scans to clip
    rows: torch.Tensor   # (n, 4 * O, 8) f32 [nx, ny, c, tx, ty, w, lo, hi]
    scal: torch.Tensor   # (n, 4) f32 [ox, oy, cos(theta0), sin(theta0)]
    fan: torch.Tensor    # (2, B) f32 rows cos(n * inc), sin(n * inc)

    def window_pairs(self) -> int:
        """(beam, edge) pairs inside a blocked-view window: the pairs whose
        hit test runs."""
        lo, hi = self.rows[..., 6], self.rows[..., 7]
        return int(torch.clamp(hi - lo + 1.0, min=0.0).double().sum())


def prepare_overlay(scans: torch.Tensor, pose: torch.Tensor,
                    opp_vertices: torch.Tensor, tables: ScanTables,
                    num_beams: int) -> OverlayInputs:
    """Host side of overlay_opponents_pallas (pallas_scan.py:838-941).

    scans (n, B); pose (n, 3), the scan pose after the iTTC zeroing;
    opp_vertices (n, O, 4, 2), the opponents' boxes from before it.
    Each scan gets its 4 * O edge rows and no more: the TPU layout's
    padding to groups of 8 rows is not needed, since the kernel loops over
    the rows it is given.
    """
    f32 = torch.float32
    n, O = opp_vertices.shape[0], opp_vertices.shape[-3]
    p = pose.reshape(-1, 3).to(f32)
    ov = opp_vertices.reshape(-1, O, 4, 2).to(f32)
    fov = tables.fov.to(f32)
    angle_inc = fov / (num_beams - 1)

    # blocked-view windows (get_blocked_view_indices in closed form): the
    # nearest beam of each vertex angle on the uniform grid, then the span
    vecs = ov - p[:, None, None, 0:2]
    vert_ang = torch.atan2(vecs[..., 1], vecs[..., 0])      # (n, O, 4)
    theta = p[:, 2]
    ego = torch.atan2(torch.sin(theta), torch.cos(theta))[:, None, None]
    diff = ego - vert_ang
    diff = torch.where(diff > np.pi, diff - 2 * np.pi, diff)
    diff = torch.where(diff < -np.pi, diff + 2 * np.pi, diff)
    awx = -diff
    idx = torch.clamp(torch.round((awx + fov / 2.0) / angle_inc),
                      0, num_beams - 1)
    lo = idx.amin(-1)                                      # (n, O)
    hi = idx.amax(-1)

    # edge rows in the segment-table format
    va = ov
    vb = torch.roll(ov, shifts=-1, dims=-2)
    ex = vb[..., 0] - va[..., 0]
    ey = vb[..., 1] - va[..., 1]
    len2 = torch.clamp(ex * ex + ey * ey, min=1e-20)
    ln = torch.sqrt(len2)
    rnx = -ey / ln
    rny = ex / ln
    rc = rnx * va[..., 0] + rny * va[..., 1]
    rtx = ex / len2
    rty = ey / len2
    rw0 = (va[..., 0] * ex + va[..., 1] * ey) / len2
    rows = torch.stack([rnx, rny, rc, rtx, rty, -rw0,
                        lo[..., None].expand_as(rnx),
                        hi[..., None].expand_as(rnx)], -1).reshape(n, 4 * O, 8)

    # per-scan scalars for the beam directions by angle addition: the
    # opponent pass uses the continuous angles theta - fov/2 + n * inc
    theta0 = theta - fov / 2.0
    scal = torch.stack([p[:, 0], p[:, 1], torch.cos(theta0),
                        torch.sin(theta0)], -1)
    n_idx = torch.arange(num_beams, dtype=f32, device=p.device)
    fan = torch.stack([torch.cos(n_idx * angle_inc),
                       torch.sin(n_idx * angle_inc)])
    return OverlayInputs(
        scans=scans.reshape(-1, num_beams).to(f32).contiguous(),
        rows=rows.contiguous(), scal=scal.contiguous(), fan=fan.contiguous())


# --------------------------------------------------------------------------
# plain torch version (the kernel's reference, and the CPU path)
# --------------------------------------------------------------------------

def overlay_plain(w: OverlayInputs) -> torch.Tensor:
    """The kernel's computation in torch ops, per (scan, edge, beam):
    (n, B) clipped scans. Scans are taken in chunks so the temporaries
    stay bounded."""
    n, B = w.scans.shape
    E = w.rows.shape[1]
    dev = w.scans.device
    beam = torch.arange(B, dtype=torch.float32, device=dev)
    cnb, snb = w.fan[0], w.fan[1]
    out = torch.empty_like(w.scans)
    chunk = max(1, (1 << 24) // max(1, E * B))
    for i0 in range(0, n, chunk):
        rows = w.rows[i0:i0 + chunk, :, :, None]        # (c, E, 8, 1)
        nx, ny, c, tx, ty, wn, lo, hi = (rows[:, :, k] for k in range(8))
        ox, oy, ca, sa = (w.scal[i0:i0 + chunk, k, None, None]
                          for k in range(4))
        num = c - ox * nx - oy * ny                      # (c, E, 1)
        num = torch.where(torch.abs(num) < 1e-12, 1e-12, num)
        inv = 1.0 / num
        uo = ox * tx + oy * ty + wn
        dx = ca * cnb - sa * snb                         # (c, 1, B)
        dy = sa * cnb + ca * snb
        den = nx * dx + ny * dy                          # (c, E, B)
        s = den * inv
        b = uo * s + tx * dx + ty * dy
        q = torch.minimum(b, s - b)
        ok = (q >= 0) & (beam >= lo) & (beam <= hi)
        smax = torch.where(ok, s, 0.0).amax(1)           # (c, B)
        cur = w.scans[i0:i0 + chunk]
        out[i0:i0 + chunk] = torch.where(
            smax > 0, torch.minimum(cur, 1.0 / torch.clamp(smax, min=1e-9)),
            cur)
    return out


# --------------------------------------------------------------------------
# CUDA kernel: build, launch (declared in utils/cuda_build.py)
# --------------------------------------------------------------------------

KERNEL = cuda_build.K2


def build_cuda() -> str:
    """Compile ``csrc/overlay_kernel.cu`` for sm_90a into ``_build/``;
    returns the compiler's resource report (``utils/cuda_build.py``)."""
    return KERNEL.build()


def _check_cuda_inputs(w: OverlayInputs):
    dev = w.scans.device
    for name in ("scans", "rows", "scal", "fan"):
        t = getattr(w, name)
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"overlay kernel input {name}: need a contiguous "
                             f"float32 tensor on {dev}, got {t.dtype} on "
                             f"{t.device}")
    if w.rows.data_ptr() % 16:
        raise ValueError("overlay kernel input rows is not 16-byte aligned")
    n, B = w.scans.shape
    if (w.rows.shape[0] != n or w.rows.shape[2] != 8
            or w.scal.shape != (n, 4) or w.fan.shape != (2, B)):
        raise ValueError("overlay kernel inputs have inconsistent shapes")


def _overlay_cuda(w: OverlayInputs) -> torch.Tensor:
    _check_cuda_inputs(w)
    n, B = w.scans.shape
    out = torch.empty_like(w.scans)
    if n == 0:
        return out
    vec4 = B % 4 == 0 and not (w.scans.data_ptr() | out.data_ptr()) % 16
    KERNEL.launch(w.scans.device, w.scans.data_ptr(), w.rows.data_ptr(),
                  w.scal.data_ptr(), w.fan.data_ptr(), out.data_ptr(), n, B,
                  w.rows.shape[1], int(vec4))
    overlay.launches += 1
    return out


def occupancy(n_scans: int, num_beams: int) -> dict:
    """The kernel's launch at this shape on the current card: resident
    blocks an SM, grid blocks, and waves (grid over resident blocks)."""
    return KERNEL.occupancy(n_scans, num_beams)


def overlay(w: OverlayInputs) -> torch.Tensor:
    """The clip on ``w``'s device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. ``overlay.launches`` counts kernel
    launches."""
    if w.scans.device.type == "cuda":
        return _overlay_cuda(w)
    if w.scans.device.type == "cpu":
        return overlay_plain(w)
    raise ValueError(f"no overlay kernel for device {w.scans.device}")


overlay.launches = 0


def overlay_opponents(scans: torch.Tensor, pose: torch.Tensor,
                      opp_vertices: torch.Tensor, tables: ScanTables,
                      num_beams: int, device=None) -> torch.Tensor:
    """Scans clipped by the opponents' boxes (laser_models.py:282-346
    without the collinear fallback).

    scans (..., B); pose (..., 3); opp_vertices (..., O, 4, 2). Any
    leading batch axes, e.g. (envs, agents), go through one call, which is
    what ``overlay_opponents_vmappable`` exists for in the JAX package.
    ``device`` (default: the card) must hold ``tables``; the inputs are
    moved there. Returns the clipped scans in the dtype of ``scans``.
    """
    dev = resolve_device(device)
    if tables.fov.device != dev:
        raise ValueError(f"scan tables are on {tables.fov.device}, the "
                         f"overlay asked for {dev}")
    batch_shape = scans.shape[:-1]
    O = opp_vertices.shape[-3]
    w = prepare_overlay(scans.to(dev).reshape(-1, num_beams),
                        pose.to(dev).reshape(-1, 3),
                        opp_vertices.to(dev).reshape(-1, O, 4, 2), tables,
                        num_beams)
    return overlay(w).reshape(*batch_shape, num_beams).to(scans.dtype)
