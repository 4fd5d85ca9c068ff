"""Culled ray/segment LiDAR scan: host side, plain torch version, CUDA kernel.

Port of ``f1tenth_gym_tpu/ops/pallas_scan.py``: ``GROUP``,
``build_seg_table`` (:128-165), ``select_windows`` (:410-468) and the host
side of ``_scan_pallas`` (:492-667). The Pallas kernel ``_scan_kernel``
becomes the hand-written CUDA C++ kernel ``csrc/scan_kernel.cu`` (see its
header for the design and the bound on the H100).

One call is three steps:

* ``prepare`` flattens and pads the poses, computes the per-scan scalars
  (ti0, inc, cos/sin(alpha)) and the cos/sin(n*beta) fan tables in f32 in
  the order of pallas_scan.py:545-564, selects each 8-scan subgroup's
  culled window (``select_windows``) and applies the eligibility gate of
  erosion-fused packs (:595-615);
* ``sweep`` runs the sweep on what ``prepare`` made: the CUDA kernel for
  tensors on the card, the plain version ``sweep_plain`` for tensors on
  the CPU (and only there: a CUDA tensor launches the kernel or raises);
* ``scan`` chains the two and unpads; ``scan_pallas`` and
  ``scan_pallas_vmappable`` do the same behind the JAX package's
  signatures.

The kernel takes the JAX kernel's phase mask (``phases``: ``"dirs"``,
``"dirs,sweep"``, ``"dirs,out"`` or ``"dirs,sweep,out"``, the production
run) and its launch knobs: ``chunk`` beams a warp, ``warps`` chunks a
block, the row skip on or off (``sweep``), and ``sub``, the scans of a
subgroup that share one table choice (``prepare``). A masked variant
stores what its phases compute, so that it can be held against
``sweep_plain(w, phases)``: the beams' direction x-components
(``"dirs"``), the raw accumulator, the max inverse range before the
epilogue (``"dirs,sweep"``), or ``max_range`` (``"dirs,out"``, the
epilogue on a zero accumulator). The JAX kernel's other knob, EA (scans
per Pallas program, ``F1TENTH_PALLAS_EA``), has no counterpart: a launch
here is one block per (scan, group of beam chunks).

The kernel skips the rows whose arc, seen from the scan origin, misses a
warp's beam chunk. ``skip_keep`` transcribes its keep test in plain torch,
``sweep_kept`` sweeps only the kept pairs, ``pair_counts`` counts the
swept, kept and hitting pairs and ``rows_read`` the table rows the sweep
reads: tests and measurements use them, the main path does not.

The kernel is declared in ``utils/cuda_build.py`` (``K1``), which builds
it with ``nvcc`` at its first launch and binds it with ``ctypes``;
importing this module builds nothing.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.state import MapData, ScanTables
from f1tenth_gym_tpu_torch.utils import cuda_build
from f1tenth_gym_tpu_torch.utils.profiling import annotate

TWO_PI = 2.0 * np.pi
GROUP = 8   # segment rows per group (the pack's row format)
SUB = 8     # scans per table-selection subgroup (the default)
SUBS = (1, 2, 4, 8, 16)  # the subgroup sizes the kernel is built for
# the CUDA kernel's row skip (csrc/scan_kernel.cu states the error budget)
CHUNK = 128         # beams a warp, 4 a lane
SKIP_DELTA = 1e-3   # rad: a chunk's sector is widened by this on each side
SKIP_EPS = 0.05     # m: rows whose line passes nearer the origin are kept
SKIP_RATIO = 1000   # rows longer than this times that distance are kept
MAX_WARPS = 16      # beam chunks a block (the kernel's kMaxWarps)
# the phase mask's bits (the kernel's kDirs, kSweep, kOut)
PHASE_BITS = {"dirs": 1, "sweep": 2, "out": 4}
FULL_PHASES = "dirs,sweep,out"


def build_seg_table(segments: np.ndarray) -> np.ndarray:
    """(K, 4) [ax, ay, bx, by] -> (Kp, 8) f32 kernel table, built in f64.

    Rows: [nx, ny, c, txn, tyn, -w0n, 0, 0] with n the UNIT normal (so
    num = c - n.o is a signed distance in meters) and the tangent scaled by
    1/|e|^2 so the along-segment hit parameter lies in [0, 1]. Padding and
    degenerate rows get n = 0, c = 1 and -w0n = 10: they never match.
    """
    segs = np.asarray(segments, np.float64)
    # drop the far-away padding rows up front: every row costs sweep time
    segs = segs[segs[:, 0] < 1e6]
    ax, ay, bx, by = segs.T
    ex, ey = bx - ax, by - ay
    len2 = ex * ex + ey * ey
    ok = len2 > 0
    len2 = np.where(ok, len2, 1.0)
    ln = np.sqrt(len2)
    nx, ny = -ey / ln, ex / ln
    c = nx * ax + ny * ay
    txn, tyn = ex / len2, ey / len2
    w0n = (ax * ex + ay * ey) / len2
    out = np.stack([nx, ny, c, txn, tyn, -w0n,
                    np.zeros_like(c), np.zeros_like(c)], 1)
    out[~ok] = 0.0
    out[~ok, 2] = 1.0
    out[~ok, 5] = 10.0
    k = len(out)
    kp = ((k + GROUP - 1) // GROUP) * GROUP
    if kp > k:
        pad = np.zeros((kp - k, 8))
        pad[:, 2] = 1.0
        pad[:, 5] = 10.0
        out = np.concatenate([out, pad], 0)
    return out.astype(np.float32)


def window_tiers(tig, tjg, blockmap, nx, ny):
    """The selection cascade of ``select_windows``: for the 1x1, 2x2, 4x4
    and 8x8 tiers in that order, (use, blk), each (nsub,): whether the
    subgroup takes that tier, and the tier's block at its lower-left tile
    (-1: none). A subgroup that takes none sweeps the full table."""
    T = blockmap.shape[0] // 4
    ti_lo, ti_hi = tig.min(-1).values, tig.max(-1).values
    tj_lo, tj_hi = tjg.min(-1).values, tjg.max(-1).values
    in_grid = (ti_lo >= 0) & (tj_lo >= 0) & (ti_hi < nx) & (tj_hi < ny)
    sx = ti_hi - ti_lo
    sy = tj_hi - tj_lo
    tidx = torch.clamp(tj_lo * nx + ti_lo, 0, T - 1)
    blk2 = blockmap[tidx].long()
    blk1 = blockmap[T + tidx].long()
    blk4 = blockmap[2 * T + tidx].long()
    blk8 = blockmap[3 * T + tidx].long()
    use1 = in_grid & (sx == 0) & (sy == 0) & (blk1 >= 0)
    use2 = in_grid & (sx <= 1) & (sy <= 1) & (blk2 >= 0) & ~use1
    use4 = in_grid & (sx <= 3) & (sy <= 3) & (blk4 >= 0) & ~use1 & ~use2
    use8 = (in_grid & (sx <= 7) & (sy <= 7) & (blk8 >= 0)
            & ~use1 & ~use2 & ~use4)
    return (use1, blk1), (use2, blk2), (use4, blk4), (use8, blk8)


def select_windows(tig, tjg, blockmap, tile_ngroups, tile_ext, nx, ny,
                   full_ng):
    """Per-subgroup culled-window choice (pallas_scan.py:410-468).

    tig/tjg: (nsub, sub) int64 tile indices of each subgroup's scans.
    Picks the tightest v9 window tier indexed by the subgroup's lower-left
    tile: 1x1 when all its scans share a tile, 2x2 when they span <= 1
    tile per axis, 4x4 for spread <= 3, 8x8 for spread <= 7, else the full
    set (also on the blockmap sentinel -1).

    Returns (bid, ng, est, ecnt): bid (nsub,) 0 = full table else 1 +
    block; ng (nsub,) shared group count; est/ecnt (nsub, sub) per-scan
    extras start and count in group units.
    """
    (use1, blk1), (use2, blk2), (use4, blk4), (use8, blk8) = window_tiers(
        tig, tjg, blockmap, nx, ny)
    ti_lo, tj_lo = tig.min(-1).values, tjg.min(-1).values
    none = torch.full_like(blk1, -1)
    blk = torch.where(use1, blk1, torch.where(
        use2, blk2, torch.where(use4, blk4, torch.where(use8, blk8, none))))
    bid = torch.where(blk >= 0, 1 + blk, 0)
    blk_c = torch.clamp(blk, min=0)
    ng = torch.where(blk >= 0, tile_ngroups[1 + blk_c].long(), full_ng)
    # per-scan member index within the selected window tier
    w = torch.where(use1, 1, torch.where(use2, 2, torch.where(use4, 4, 8)))
    m = (tjg - tj_lo[:, None]) * w[:, None] + (tig - ti_lo[:, None])
    m = torch.clamp(m, 0, 63)
    if tile_ext is None:     # pack has no split blocks: extras all empty
        est = ecnt = torch.zeros_like(tig)
    else:
        packed = tile_ext[blk_c[:, None], m].long()
        packed = torch.where(blk[:, None] >= 0, packed, 0)
        est = packed // 256
        ecnt = packed % 256
    return bid, ng, est, ecnt


@dataclasses.dataclass
class SweepInputs:
    """Everything the sweep reads, made by ``prepare``; n_pad % sub == 0."""

    scal: torch.Tensor   # (n_pad, 8) f32 [ox, oy, ti0, inc, ca, sa, maxr, 0]
    fan: torch.Tensor    # (2, num_beams) f32 rows cos(n*beta), sin(n*beta)
    full: torch.Tensor   # (Kf, 8) f32 full table
    tabs: torch.Tensor   # (n_blocks, Kt, 8) f32 window blocks
    bid: torch.Tensor    # (nsub,) i32: 0 = full table, else 1 + block
    ng: torch.Tensor     # (nsub,) i32 shared group count
    est: torch.Tensor    # (n_pad,) i32 extras start (groups)
    ecnt: torch.Tensor   # (n_pad,) i32 extras count (groups)
    has_extras: bool     # the pack has split blocks
    inv_td: float        # f32(1 / theta_dis)
    bin_to_rad: float    # f32(2 pi / (theta_dis - 1))
    sub: int = SUB       # scans a subgroup (one table choice)

    @property
    def num_beams(self) -> int:
        return self.fan.shape[1]

    def swept_rows(self) -> torch.Tensor:
        """(n_pad,) table rows each scan sweeps with this selection."""
        shared = self.ng.long().repeat_interleave(self.sub)
        extra = self.ecnt.long() if self.has_extras else 0
        return (shared + extra) * GROUP


def _f32(x: float) -> float:
    return float(np.float32(x))


def prepare(pose: torch.Tensor, seg_table: torch.Tensor, tables: ScanTables,
            num_beams: int, theta_dis: int,
            tile_tables: Optional[torch.Tensor] = None,
            tile_ngroups: Optional[torch.Tensor] = None,
            tile_meta: Optional[torch.Tensor] = None,
            tile_meta_host=None,
            tile_blockmap: Optional[torch.Tensor] = None,
            tile_ext: Optional[torch.Tensor] = None,
            elig_raster: Optional[torch.Tensor] = None,
            elig_meta: Optional[torch.Tensor] = None,
            sub: int = SUB) -> SweepInputs:
    """Host side of _scan_pallas (pallas_scan.py:530-621) for (n, 3) poses;
    ``sub`` scans a subgroup (one of SUBS; the JAX kernel's
    ``F1TENTH_PALLAS_SUB``)."""
    if sub not in SUBS:
        raise ValueError(f"subgroup size {sub}: the kernel is built for "
                         f"{SUBS}")
    f32 = torch.float32
    dev = pose.device
    p = pose.reshape(-1, 3).to(f32)
    n = p.shape[0]
    n_pad = ((n + sub - 1) // sub) * sub
    if n_pad > n:
        p = torch.cat([p, p[-1:].expand(n_pad - n, 3)], 0)

    fov = tables.fov.to(f32)
    angle_inc = fov / (num_beams - 1)
    theta = p[:, 2]
    ti0 = theta_dis * (theta - fov / 2.0) / torch.tensor(TWO_PI, dtype=f32)
    ti0 = torch.remainder(torch.remainder(ti0, theta_dis) + theta_dis,
                          theta_dis)
    # Python floats and CPU scalars enter the ops as scalars: no copy to
    # the card, so the host never waits for it here
    bin_to_rad = _f32(TWO_PI / (theta_dis - 1))
    inc_val = torch.tensor(theta_dis, dtype=f32) * angle_inc \
        / torch.tensor(TWO_PI, dtype=f32)
    alpha = ti0 * bin_to_rad
    beta = inc_val * bin_to_rad
    n_idx = torch.arange(num_beams, dtype=f32, device=dev)
    fan = torch.stack([torch.cos(n_idx * beta), torch.sin(n_idx * beta)])
    zeros = torch.zeros_like(ti0)
    scal = torch.stack(
        [p[:, 0], p[:, 1], ti0, inc_val.expand(n_pad), torch.cos(alpha),
         torch.sin(alpha), tables.max_range.to(f32).expand(n_pad), zeros],
        -1).contiguous()

    nsub = n_pad // sub
    Kf = seg_table.shape[0]
    if tile_tables is None:
        tabs = torch.zeros((1, GROUP, 8), dtype=f32, device=dev)
        tabs[:, :, 2] = 1.0   # never-matching rows (see build_seg_table)
        tabs[:, :, 5] = 10.0
        bid = torch.zeros(nsub, dtype=torch.long, device=dev)
        ng = torch.full((nsub,), Kf // GROUP, dtype=torch.long, device=dev)
        est = ecnt = torch.zeros(n_pad, dtype=torch.long, device=dev)
    else:
        if tile_blockmap is None or tile_meta_host is None:
            raise ValueError("v9 tile tables need tile_blockmap and "
                             "tile_meta_host alongside tile_tables")
        tabs = tile_tables
        x0, y0, inv_ts = tile_meta[0], tile_meta[1], tile_meta[2]
        nx, ny = int(tile_meta_host[3]), int(tile_meta_host[4])
        ti = torch.floor((p[:, 0] - x0) * inv_ts).long()
        tj = torch.floor((p[:, 1] - y0) * inv_ts).long()
        with annotate("scan.select_windows"):
            bid, ng, est, ecnt = select_windows(
                ti.view(nsub, sub), tj.view(nsub, sub), tile_blockmap,
                tile_ngroups, tile_ext, nx, ny, Kf // GROUP)
        if elig_raster is not None:
            # erosion-gated pack: the culled tables are only proven for
            # scan origins on eligible cells; a subgroup with any other
            # scan sweeps the full table, so culled == full for every pose
            ex = torch.floor((p[:, 0] - elig_meta[0]) / elig_meta[2]).long()
            ey = torch.floor((p[:, 1] - elig_meta[1]) / elig_meta[2]).long()
            Hm, Wm = elig_raster.shape
            inb = (ex >= 0) & (ex < Wm) & (ey >= 0) & (ey < Hm)
            ok = inb & (elig_raster[torch.clamp(ey, 0, Hm - 1),
                                    torch.clamp(ex, 0, Wm - 1)] > 0)
            ok_sub = ok.view(nsub, sub).all(-1)
            bid = torch.where(ok_sub, bid, 0)
            ng = torch.where(ok_sub, ng, Kf // GROUP)
            est = torch.where(ok_sub[:, None], est, 0)
            ecnt = torch.where(ok_sub[:, None], ecnt, 0)
        est = est.reshape(-1)
        ecnt = ecnt.reshape(-1)
    i32 = torch.int32
    return SweepInputs(
        scal=scal, fan=fan.contiguous(), full=seg_table.to(f32).contiguous(),
        tabs=tabs.contiguous(), bid=bid.to(i32), ng=ng.to(i32),
        est=est.to(i32), ecnt=ecnt.to(i32), has_extras=tile_ext is not None,
        inv_td=_f32(1.0 / theta_dis), bin_to_rad=bin_to_rad, sub=sub)


# --------------------------------------------------------------------------
# plain torch version (the kernel's reference, and the CPU path)
# --------------------------------------------------------------------------

def _beam_dirs(w: SweepInputs):
    """(n_pad, B) beam directions, pallas_scan.py:238-250 operation order."""
    ti0, inc, ca, sa = (w.scal[:, i:i + 1] for i in (2, 3, 4, 5))
    beam = torch.arange(w.num_beams, dtype=torch.float32,
                        device=w.scal.device)
    cnb, snb = w.fan[0], w.fan[1]
    t = ti0 + beam * inc
    k = torch.floor(t * w.inv_td)
    g = (t - torch.floor(t) + k) * w.bin_to_rad
    cg = 1.0 - 0.5 * g * g
    cos_t = ca * cnb - sa * snb
    sin_t = sa * cnb + ca * snb
    return cos_t * cg + sin_t * g, sin_t * cg - cos_t * g


def _hits(rows, ox, oy, dx, dy):
    """(s, q) (n, B, R) of the hit test of beams (n, B) against rows
    (n, R, 8): s the inverse range, and the hit counts where q >= 0."""
    nx, ny, c, tx, ty, wn = (rows[..., i] for i in range(6))
    num = c - ox * nx - oy * ny
    num = torch.where(torch.abs(num) < 1e-12, 1e-12, num)
    inv = 1.0 / num
    uo = ox * tx + oy * ty + wn
    dxe, dye = dx[:, :, None], dy[:, :, None]
    den = nx[:, None, :] * dxe + ny[:, None, :] * dye
    s = den * inv[:, None, :]
    ud = tx[:, None, :] * dxe + ty[:, None, :] * dye
    b = uo[:, None, :] * s + ud
    return s, torch.minimum(b, s - b)


def _accumulate(acc, rows, valid, ox, oy, dx, dy):
    """acc (n, B) = max(acc, max over rows (n, R, 8) where valid (n, R))."""
    s, q = _hits(rows, ox, oy, dx, dy)
    sc = torch.where((q >= 0) & valid[:, None, :], s, 0.0)
    return torch.maximum(acc, sc.amax(-1))


def phase_mask(phases: str) -> int:
    """The kernel's phase bits of a JAX phase mask ("dirs,sweep,out" in
    production); raises without "dirs" or on an unknown phase."""
    parts = {p.strip() for p in phases.split(",")}
    if "dirs" not in parts or not parts <= set(PHASE_BITS):
        raise ValueError(f"phase mask {phases!r}: need 'dirs', optionally "
                         "with 'sweep' and 'out'")
    return sum(PHASE_BITS[p] for p in parts)


def _finish(acc: torch.Tensor, w: SweepInputs) -> torch.Tensor:
    """The epilogue: ranges min(1 / max(acc, 1e-9), max_range)."""
    return torch.minimum(1.0 / torch.clamp(acc, min=1e-9), w.scal[:, 6:7])


def sweep_plain(w: SweepInputs, phases: str = FULL_PHASES) -> torch.Tensor:
    """The kernel's computation in torch ops: (n_pad, B) ranges, or what
    the masked kernel stores under ``phases`` (module docstring)."""
    mask = phase_mask(phases)
    if mask & PHASE_BITS["sweep"]:
        acc = sweep_acc(w)
    elif mask & PHASE_BITS["out"]:
        acc = torch.zeros((w.scal.shape[0], w.num_beams),
                          dtype=torch.float32, device=w.scal.device)
    else:
        return _beam_dirs(w)[0]
    return _finish(acc, w) if mask & PHASE_BITS["out"] else acc


def sweep_acc(w: SweepInputs) -> torch.Tensor:
    """The sweep's accumulator, (n_pad, B): per (scan, beam) the max
    inverse range over the scan's rows, before the epilogue.

    Each subgroup's table is gathered from the selected block (or the full
    table), masked to its ``ng`` groups, then each scan's extras range;
    rows are taken in chunks so the (scan, beam, row) temporaries stay
    bounded.
    """
    n_pad, B = w.scal.shape[0], w.num_beams
    dev = w.scal.device
    dx, dy = _beam_dirs(w)
    ox, oy = w.scal[:, 0:1], w.scal[:, 1:2]
    acc = torch.zeros((n_pad, B), dtype=torch.float32, device=dev)
    sub_of = torch.arange(n_pad, device=dev) // w.sub
    bid = w.bid.long()[sub_of]
    blk = torch.clamp(bid - 1, min=0)
    Kf, Kt = w.full.shape[0], w.tabs.shape[1]
    chunk = max(GROUP, (1 << 24) // max(1, n_pad * B) // GROUP * GROUP)

    def gather(r):  # r (n_pad, R) row indices -> (n_pad, R, 8)
        from_full = w.full[torch.clamp(r, max=Kf - 1)]
        from_tab = w.tabs[blk[:, None], torch.clamp(r, max=Kt - 1)]
        return torch.where((bid == 0)[:, None, None], from_full, from_tab)

    shared_rows = (w.ng.long() * GROUP)[sub_of]
    for r0 in range(0, int(shared_rows.max()), chunk):
        r = torch.arange(r0, r0 + chunk, device=dev).expand(n_pad, chunk)
        acc = _accumulate(acc, gather(r), r < shared_rows[:, None],
                          ox, oy, dx, dy)
    if w.has_extras:
        e0 = w.est.long() * GROUP
        en = w.ecnt.long() * GROUP
        for r0 in range(0, int(en.max()), chunk):
            off = torch.arange(r0, r0 + chunk, device=dev).expand(n_pad, chunk)
            acc = _accumulate(acc, gather(e0[:, None] + off),
                              off < en[:, None], ox, oy, dx, dy)
    return acc


# --------------------------------------------------------------------------
# the kernel's row skip, as plain torch (tests and measurement only: the
# main path runs the kernel, and sweep_plain tests every pair)
# --------------------------------------------------------------------------

def _row_index(w: SweepInputs):
    """Each scan's rows in the kernel's order (its subgroup's shared rows,
    then its own extras) as (bid (n_pad,), g (n_pad, R), valid (n_pad, R)):
    row g of the full table where bid == 0, else of block bid - 1."""
    n_pad = w.scal.shape[0]
    dev = w.scal.device
    sub_of = torch.arange(n_pad, device=dev) // w.sub
    bid = w.bid.long()[sub_of]
    n_sh = (w.ng.long() * GROUP)[sub_of]
    n_ex = (w.ecnt.long() * GROUP if w.has_extras
            else torch.zeros_like(n_sh))
    e0 = w.est.long() * GROUP
    n_rows = n_sh + n_ex
    i = torch.arange(max(1, int(n_rows.max())), device=dev).expand(n_pad, -1)
    g = torch.where(i < n_sh[:, None], i, e0[:, None] + i - n_sh[:, None])
    return bid, g, i < n_rows[:, None]


def scan_rows(w: SweepInputs):
    """Each scan's rows in the kernel's order: its subgroup's shared rows,
    then its own extras. Returns rows (n_pad, R, 8) and valid (n_pad, R)."""
    bid, g, valid = _row_index(w)
    blk = torch.clamp(bid - 1, min=0)
    Kf, Kt = w.full.shape[0], w.tabs.shape[1]
    rows = torch.where((bid == 0)[:, None, None],
                       w.full[torch.clamp(g, max=Kf - 1)],
                       w.tabs[blk[:, None], torch.clamp(g, max=Kt - 1)])
    return rows, valid


def rows_read(w: SweepInputs) -> int:
    """Distinct table rows the sweep reads: each (table, row) that some
    scan sweeps, counted once."""
    bid, g, valid = _row_index(w)
    stride = max(w.full.shape[0], w.tabs.shape[1])
    ids = bid[:, None] * stride + g
    return int(torch.unique(ids[valid]).numel())


def _cross(ux, uy, vx, vy):
    return ux * vy - uy * vx


def _in_arc(vx, vy, px, py, qx, qy):
    """v inside the counter-clockwise arc from p to q (under pi)."""
    return (_cross(px, py, vx, vy) >= 0) & (_cross(vx, vy, qx, qy) >= 0)


def skip_keep(w: SweepInputs, rows: torch.Tensor, valid: torch.Tensor,
              chunk: int = CHUNK) -> torch.Tensor:
    """The kernel's keep test (csrc/scan_kernel.cu), in its f32 operation
    order: (n_pad, n_chunks, R) bool, True where the warp of beam chunk c
    (``chunk`` beams a warp) of a scan runs the hit test on row r
    (``rows``/``valid`` from ``scan_rows``)."""
    ox, oy = w.scal[:, 0:1], w.scal[:, 1:2]
    nx, ny, c, tx, ty, wn = (rows[..., i] for i in range(6))
    num = c - ox * nx - oy * ny
    dist = torch.abs(num)
    num = torch.where(dist < 1e-12, 1e-12, num)
    uo = ox * tx + oy * ty + wn
    t2 = tx * tx + ty * ty
    drop = t2 == 0
    always = ~drop & ((dist < _f32(SKIP_EPS))
                      | (dist * dist * t2 < _f32(SKIP_RATIO ** -2)))
    # directions to the row's ends u = 0 and u = 1: perp(q0), perp(q1),
    # counter-clockwise from p to q
    q0x, q0y = uo * nx + num * tx, uo * ny + num * ty
    um1 = uo - 1.0
    q1x, q1y = um1 * nx + num * tx, um1 * ny + num * ty
    ccw = num < 0
    px, py = torch.where(ccw, -q0y, -q1y), torch.where(ccw, q0x, q1x)
    qx, qy = torch.where(ccw, -q1y, -q0y), torch.where(ccw, q1x, q0x)

    # each chunk's sector: first to last beam, widened by SKIP_DELTA
    dx, dy = _beam_dirs(w)
    B = w.num_beams
    first = torch.arange(0, B, chunk, device=dx.device)
    last = torch.clamp(first + chunk, max=B) - 1
    f0x, f0y, f1x, f1y = dx[:, first], dy[:, first], dx[:, last], dy[:, last]
    cd, sd = _f32(np.cos(SKIP_DELTA)), _f32(np.sin(SKIP_DELTA))
    s0x = (f0x * cd + f0y * sd)[..., None]
    s0y = (f0y * cd - f0x * sd)[..., None]
    s1x = (f1x * cd - f1y * sd)[..., None]
    s1y = (f1y * cd + f1x * sd)[..., None]
    skip = (f0x * f1x + f0y * f1y > 0) & (_cross(f0x, f0y, f1x, f1y) >= 0)

    px, py, qx, qy = (v[:, None, :] for v in (px, py, qx, qy))
    meets = (_in_arc(s0x, s0y, px, py, qx, qy)
             | _in_arc(px, py, s0x, s0y, s1x, s1y))
    arc = (~drop & ~always)[:, None, :]
    keep = always[:, None, :] | (arc & meets)
    return torch.where(skip[..., None], keep, True) & valid[:, None, :]


def sweep_kept(w: SweepInputs, chunk: int = CHUNK) -> torch.Tensor:
    """``sweep_plain`` restricted to the pairs the kernel's skip keeps:
    (n_pad, B) ranges, equal to ``sweep_plain`` wherever the skip is
    sound."""
    rows, valid = scan_rows(w)
    keep = skip_keep(w, rows, valid, chunk)
    dx, dy = _beam_dirs(w)
    ox, oy = w.scal[:, 0:1], w.scal[:, 1:2]
    acc = torch.zeros_like(dx)
    for ci, b0 in enumerate(range(0, w.num_beams, chunk)):
        sl = slice(b0, b0 + chunk)
        acc[:, sl] = _accumulate(acc[:, sl], rows, keep[:, ci], ox, oy,
                                 dx[:, sl], dy[:, sl])
    return _finish(acc, w)


def pair_counts(w: SweepInputs, chunk: int = CHUNK) -> dict:
    """(scan, beam, row) pair counts of one sweep: ``swept``, every pair
    of the scans' row lists (what ``sweep_plain`` tests); ``kept``, the
    pairs the kernel's skip tests; ``hit``, the pairs whose hit test passes
    with s > 0 (the beam inside the row's arc: the least work);
    ``missed``, hit pairs the skip drops, 0 when it is sound; ``chunk``
    beams a warp."""
    rows, valid = scan_rows(w)
    keep = skip_keep(w, rows, valid, chunk)
    dx, dy = _beam_dirs(w)
    ox, oy = w.scal[:, 0:1], w.scal[:, 1:2]
    n_pad, R = valid.shape
    B = w.num_beams
    chunk_of = torch.arange(B, device=dx.device) // chunk
    width = torch.bincount(chunk_of).to(torch.float64)
    out = dict(swept=int(valid.sum()) * B,
               kept=int((keep.to(torch.float64) * width[:, None]).sum()),
               hit=0, missed=0)
    ns = max(1, (1 << 24) // (B * min(R, 256)))
    for i0 in range(0, n_pad, ns):
        for r0 in range(0, R, 256):
            sl, rs = slice(i0, i0 + ns), slice(r0, r0 + 256)
            s, q = _hits(rows[sl, rs], ox[sl], oy[sl], dx[sl], dy[sl])
            hit = (q >= 0) & (s > 0) & valid[sl, None, rs]
            out["hit"] += int(hit.sum())
            out["missed"] += int((hit & ~keep[sl][:, chunk_of, rs]).sum())
    return out


# --------------------------------------------------------------------------
# CUDA kernel: build, launch (declared in utils/cuda_build.py)
# --------------------------------------------------------------------------

KERNEL = cuda_build.K1


def build_cuda() -> str:
    """Compile ``csrc/scan_kernel.cu`` for sm_90a into ``_build/``; returns
    the compiler's resource report (``utils/cuda_build.py``)."""
    return KERNEL.build()


def resources(report: str) -> dict:
    """{(phase bits, sub): {registers, smem_bytes, spill_bytes}} of each
    kernel instantiation in ``build_cuda``'s report."""
    out, key = {}, None
    inst = re.compile(re.escape(KERNEL.trace_name) + r"ILi(\d+)ELi(\d+)E")
    for line in report.splitlines():
        m = inst.search(line)
        if "Compiling entry function" in line:
            key = (int(m.group(1)), int(m.group(2))) if m else None
        elif key is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out.setdefault(key, {})["spill_bytes"] = int(st) + int(ld)
        elif key is not None and "registers" in line:
            out.setdefault(key, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[key]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def _check_cuda_inputs(w: SweepInputs):
    dev = w.scal.device
    spec = [("scal", torch.float32), ("fan", torch.float32),
            ("full", torch.float32), ("tabs", torch.float32),
            ("bid", torch.int32), ("ng", torch.int32),
            ("est", torch.int32), ("ecnt", torch.int32)]
    for name, dtype in spec:
        t = getattr(w, name)
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"scan kernel input {name}: need a contiguous "
                             f"{dtype} tensor on {dev}, got {t.dtype} on "
                             f"{t.device}")
    for name in ("full", "tabs"):
        if getattr(w, name).data_ptr() % 16:
            raise ValueError(f"scan kernel input {name} is not 16-byte aligned")
    n_pad = w.scal.shape[0]
    if (w.sub not in SUBS or n_pad % w.sub or w.scal.shape[1] != 8
            or w.bid.shape[0] != n_pad // w.sub or w.est.shape[0] != n_pad
            or w.full.shape[1] != 8 or w.tabs.shape[2] != 8):
        raise ValueError("scan kernel inputs have inconsistent shapes")


def warps_per_block(num_beams: int, chunk: int = CHUNK) -> int:
    """Beam chunks (warps) a block: all of a scan's chunks when they fit
    MAX_WARPS, else an even split."""
    n = -(-num_beams // chunk)
    return -(-n // -(-n // MAX_WARPS))


def launch_shape(num_beams: int, chunk: Optional[int] = None,
                 warps: Optional[int] = None):
    """(chunk, warps, blocks a scan) of a launch, the defaults filled in:
    CHUNK beams a warp and ``warps_per_block``; raises on knobs the kernel
    does not take (chunk a multiple of 4 up to 128, 1 to MAX_WARPS
    warps)."""
    chunk = CHUNK if chunk is None else int(chunk)
    if chunk <= 0 or chunk > 128 or chunk % 4:
        raise ValueError(f"chunk {chunk}: need a multiple of 4, at most 128")
    warps = warps_per_block(num_beams, chunk) if warps is None else int(warps)
    if not 0 < warps <= MAX_WARPS:
        raise ValueError(f"warps {warps}: need 1 to {MAX_WARPS}")
    n_chunks = -(-num_beams // chunk)
    return chunk, warps, -(-n_chunks // warps)


def _sweep_cuda(w: SweepInputs, skip: bool = True,
                chunk: Optional[int] = None, warps: Optional[int] = None,
                phases: str = FULL_PHASES) -> torch.Tensor:
    """The kernel on ``w`` (knobs as ``sweep``); ``skip=False`` turns its
    row skip off (every pair tested, the same result), to measure what the
    skip saves."""
    mask = phase_mask(phases)
    _check_cuda_inputs(w)
    n_pad, B = w.scal.shape[0], w.num_beams
    chunk, warps, _ = launch_shape(B, chunk, warps)
    out = torch.empty((n_pad, B), dtype=torch.float32, device=w.scal.device)
    KERNEL.launch(
        w.scal.device, w.scal.data_ptr(), w.fan.data_ptr(),
        w.full.data_ptr(), w.tabs.data_ptr(), w.tabs.shape[1],
        w.bid.data_ptr(), w.ng.data_ptr(), w.est.data_ptr(),
        w.ecnt.data_ptr(), int(w.has_extras), out.data_ptr(), n_pad, B,
        w.inv_td, w.bin_to_rad, chunk, warps, int(skip), _f32(SKIP_EPS),
        _f32(SKIP_RATIO ** -2), _f32(np.cos(SKIP_DELTA)),
        _f32(np.sin(SKIP_DELTA)), mask, w.sub)
    sweep.launches += 1
    return out


def occupancy(n_scans: int, num_beams: int, chunk: Optional[int] = None,
              warps: Optional[int] = None, phases: str = FULL_PHASES,
              sub: int = SUB) -> dict:
    """The kernel's launch at this shape on the current card: resident
    blocks an SM, grid blocks, and waves (grid over resident blocks)."""
    chunk, warps, _ = launch_shape(num_beams, chunk, warps)
    return dict(threads_per_block=32 * warps, **KERNEL.occupancy(
        n_scans, num_beams, chunk, warps, phase_mask(phases), sub))


def sweep(w: SweepInputs, chunk: Optional[int] = None,
          warps: Optional[int] = None, skip: bool = True,
          phases: str = FULL_PHASES) -> torch.Tensor:
    """The sweep on ``w``'s device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. ``sweep.launches`` counts kernel
    launches.

    ``chunk`` beams a warp (default CHUNK), ``warps`` chunks a block
    (default ``warps_per_block``) and ``skip``, the row skip, change no
    output bit; ``phases`` masks the kernel's phases (module docstring).
    The plain version takes the same knobs and checks them."""
    if w.scal.device.type == "cuda":
        return _sweep_cuda(w, skip, chunk, warps, phases)
    if w.scal.device.type == "cpu":
        launch_shape(w.num_beams, chunk, warps)
        # the full mask calls sweep_plain(w), as code that wraps it expects
        return (sweep_plain(w) if phases == FULL_PHASES
                else sweep_plain(w, phases))
    raise ValueError(f"no scan kernel for device {w.scal.device}")


sweep.launches = 0


def elig_meta(m: MapData) -> torch.Tensor:
    """[orig_x, orig_y, resolution] in f32: the eligibility raster's grid."""
    return torch.stack([m.orig_x, m.orig_y, m.resolution]).to(torch.float32)


def prepare_map(pose: torch.Tensor, m: MapData, tables: ScanTables,
                num_beams: int, theta_dis: int, culled: bool = True,
                sub: int = SUB) -> SweepInputs:
    """``prepare`` with the tables of ``m`` (its culled pack when
    ``culled`` and present, else the full table only)."""
    if m.seg_table is None:
        raise ValueError("the kernel scan needs MapData.seg_table: load the "
                         "map with extract_segments=True")
    kw = {}
    if culled and m.tile_tables is not None:
        kw = dict(tile_tables=m.tile_tables, tile_ngroups=m.tile_ngroups,
                  tile_meta=m.tile_meta, tile_meta_host=m.tile_meta_host,
                  tile_blockmap=m.tile_blockmap, tile_ext=m.tile_ext)
        if m.cull_eligible is not None:
            kw.update(elig_raster=m.cull_eligible, elig_meta=elig_meta(m))
    return prepare(pose, m.seg_table, tables, num_beams, theta_dis, sub=sub,
                   **kw)


def scan(pose: torch.Tensor, m: MapData, tables: ScanTables, num_beams: int,
         theta_dis: int, culled: bool = True, device=None,
         sub: int = SUB) -> torch.Tensor:
    """Batched LiDAR scan: pose (..., 3) -> ranges (..., num_beams).

    ``device`` (default: the card) must be the map's device; the poses are
    moved there. ``culled=False`` sweeps the full table for every scan;
    ``sub`` scans share a table choice.
    """
    dev = resolve_device(device)
    if m.device != dev:
        raise ValueError(f"map tensors are on {m.device}, scan asked for {dev}")
    batch_shape = pose.shape[:-1]
    flat = pose.to(dev).reshape(-1, 3)
    n = flat.shape[0]
    with annotate("scan.prepare"):
        w = prepare_map(flat, m, tables, num_beams, theta_dis, culled, sub)
    with annotate("scan.k1"):
        out = sweep(w)
    return out[:n].reshape(*batch_shape, num_beams).to(pose.dtype)


def scan_pallas(pose: torch.Tensor, seg_table: torch.Tensor,
                tables: ScanTables, num_beams: int, theta_dis: int,
                interpret: bool = False, phases: str = "dirs,sweep,out",
                tile_tables: Optional[torch.Tensor] = None,
                tile_ngroups: Optional[torch.Tensor] = None,
                tile_meta: Optional[torch.Tensor] = None,
                tile_blockmap: Optional[torch.Tensor] = None,
                tile_ext: Optional[torch.Tensor] = None,
                elig_raster: Optional[torch.Tensor] = None,
                elig_meta: Optional[torch.Tensor] = None,
                sub: int = SUB) -> torch.Tensor:
    """The JAX package's ``scan_pallas`` (pallas_scan.py:471) on
    ``prepare`` and ``sweep``: pose (..., 3) -> ranges (..., num_beams) on
    the poses' device. ``interpret=True`` runs the plain version
    ``sweep_plain`` (on any device), as Pallas' interpret mode runs the
    kernel's body. ``phases`` is the JAX kernel's debug mask: a masked
    call returns what the masked kernel stores (module docstring) in
    place of the ranges. ``sub`` scans share a table choice (the JAX
    kernel's ``F1TENTH_PALLAS_SUB``). An erosion-gated pack
    (``tile_meta[5] >= 8``) without its eligibility raster raises, as in
    the JAX package."""
    phase_mask(phases)
    meta_host = None
    if tile_meta is not None:
        meta_host = tuple(float(v) for v in tile_meta.cpu())
        if elig_raster is None and meta_host[5] >= 8:
            raise ValueError(
                "erosion-gated culling pack used without its eligibility "
                "raster: pass elig_raster/elig_meta (MapData.cull_eligible "
                "+ [orig_x, orig_y, resolution]) to scan_pallas")
    batch_shape = pose.shape[:-1]
    flat = pose.reshape(-1, 3)
    w = prepare(flat, seg_table, tables, num_beams, theta_dis,
                tile_tables=tile_tables, tile_ngroups=tile_ngroups,
                tile_meta=tile_meta, tile_meta_host=meta_host,
                tile_blockmap=tile_blockmap, tile_ext=tile_ext,
                elig_raster=elig_raster, elig_meta=elig_meta, sub=sub)
    out = sweep_plain(w, phases) if interpret else sweep(w, phases=phases)
    return out[:flat.shape[0]].reshape(*batch_shape, num_beams).to(pose.dtype)


def scan_pallas_vmappable(pose, seg_table, tables, num_beams, theta_dis,
                          interpret=False, tile_tables=None,
                          tile_ngroups=None, tile_meta=None,
                          tile_blockmap=None, tile_ext=None,
                          elig_raster=None, elig_meta=None):
    """The JAX package's ``scan_pallas_vmappable`` (pallas_scan.py:670),
    whose custom vmap rule folds every batch axis into one kernel call:
    here ``scan_pallas`` on any leading batch axes is that one call."""
    return scan_pallas(pose, seg_table, tables, num_beams, theta_dis,
                       interpret=interpret, tile_tables=tile_tables,
                       tile_ngroups=tile_ngroups, tile_meta=tile_meta,
                       tile_blockmap=tile_blockmap, tile_ext=tile_ext,
                       elig_raster=elig_raster, elig_meta=elig_meta)
