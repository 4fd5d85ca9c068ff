"""Exact conservative per-tile segment-visibility culling for the scan engines.

Port of ``f1tenth_gym_tpu/ops/culling.py``, whole; the pack format (v9
``TileTables``, 8-row groups) is unchanged, so packs built from no
component seed or one compare byte for byte with the JAX package's. A
list of seeds (a multi-track world's corridors) is the port's own: each
seed's component gets an erosion certificate of its own
(``_refine_components``).

The LiDAR kernel (ops/scan_kernel.py) sweeps every wall segment for every
beam. On corridor maps most segments are occluded by nearer walls from
any given pose, so the sweep wastes most of its work. This module
precomputes, per map tile, a PROVABLY sufficient segment subset: scans from
any pose inside the tile are bit-identical against the subset and the full
set. The kernel then selects the subset for each 8-scan subgroup.

Two conservative-exact tests, computed once per map on the host:

* range: a segment whose distance from the tile exceeds max_range can never
  return a hit below the max-range clamp;
* umbra: segment S is occluded from tile T if some other wall segment W
  properly blocks the sightline p->q for EVERY tile corner p and BOTH
  endpoints q of S. Convexity makes the corner/endpoint test exact: the
  shadow of W from a point q ({p : pq crosses W}) is a convex cone, so
  containing all 4 corners of T means containing all of T; symmetrically
  the umbra of W w.r.t. T (the intersection of the corner shadows) is
  convex, so containing both endpoints of S means containing all of S.
  Every blocked sightline registers a valid kernel hit on W strictly
  before S, hence removing S never changes any beam's min distance.

Both tests only ever REMOVE provably invisible segments (strict float64
inequalities with margin; degenerate/tangent cases count as visible), so
the culled scan equals the full scan exactly — no sampling.

There is no counterpart in the reference (its marching engine walks the
distance-transform raster, laser_models.py:106-146); this is work
reduction for the segment formulation.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np

# strict-crossing margin on f64 cross-product PRODUCTS (coords are O(100) m,
# cross products O(1e3), products O(1e6); f64 noise is ~1e-10 — margin 1e-6
# only ever misclassifies truly tangent sightlines as NOT blocked: safe)
_EPS = 1e-6


class TileTables(NamedTuple):
    """Packed multi-window segment tables for the scan kernel (v9).

    Four window TIERS — 2x2, 1x1, 4x4, 8x8 tiles, all indexed by
    LOWER-LEFT tile — cover each 8-scan kernel subgroup with the tightest
    window containing it (else the full set). The wide 8x8 tier exists
    for MULTI-TRACK worlds: a freshly-reset env that teleported to its
    start grid still sweeps one track's segments instead of the whole
    world's.

    v9 SPLIT LAYOUT: a window's table is not necessarily just the
    UNION of its member tiles' visible sets. Where it pays, the block is
    laid out as

        [ common = INTERSECTION over member tiles | extras(tile 0) |
          extras(tile 1) | ... ]          (each part padded to 8 rows)

    and every SCAN sweeps ``common`` plus ONLY its own tile's extras
    range — i.e. exactly its tile's 1x1 visible set — while the whole
    subgroup still shares one block. Windows whose split total
    would exceed ``split_cap_groups`` keep the plain union layout
    (extras counts 0). Blocks are DEDUPED by content: ``blockmap`` sends
    window (tier, lower-left tile) -> block index (or -1 = use the full
    table), so identical visible sets across adjacent tiles share
    storage.

    tables  (n_blocks, Kmax, 8) f32 kernel rows (deduped blocks)
    ngroups (n_blocks + 1,) i32: [0] the FULL set's group count;
            [1 + b] block b's group count — the COMMON part for split
            blocks, the whole union for union-layout blocks (always >= 1:
            empty sets keep one padding group).
    blockmap (4 * n_tiles,) i32: window -> block, tiers stacked in the
            v8 order [2x2 | 1x1 | 4x4 | 8x8]; -1 = full-table sentinel.
    ext     (n_blocks, 64) i32: per (block, member-tile m) packed
            ``start * 256 + count`` extras range in GROUP units from the
            block start (m = (tj - tj_lo) * w + (ti - ti_lo), row-major
            over the w x w window); 0 for union-layout blocks, for 1x1
            blocks, and for members with no extras.

    The full fallback table is NOT stored here (the kernel carries it as
    its own input, so multi-map worlds don't pad the windows to the full
    set's row count).
    """

    tables: np.ndarray     # (n_blocks, Kmax, 8) f32 kernel rows
    ngroups: np.ndarray    # (n_blocks + 1,) i32 group counts (see above)
    blockmap: np.ndarray   # (4*n_tiles,) i32 window -> block / -1
    ext: np.ndarray        # (n_blocks, 64) i32 packed extras ranges
    x0: float              # grid origin (world frame)
    y0: float
    tile_size: float
    nx: int                # grid dims
    ny: int
    neighborhood: int      # meta slot: 7 = plain pack, 8 = erosion-gated
    # (H, W) uint8 runtime-eligibility raster for erosion-fused packs
    # (see erosion_refine): scans from cells with 0 here MUST fall back to
    # the full table (the scan gathers it per scan origin). None for
    # packs built without erosion fusion.
    eligible: Optional[np.ndarray] = None


def _cross(ax, ay, bx, by):
    return ax * by - ay * bx


def _blocked_native(segs, occ, corners, max_range, tile_size):
    """C++ umbra sweep (native/visibility.cpp); None when unavailable."""
    import ctypes

    from f1tenth_gym_tpu_torch.utils.native import load as _load_native

    lib = _load_native()
    if lib is None or not hasattr(lib, "tile_blocked_mask"):
        return None
    segs = np.ascontiguousarray(segs, np.float64)
    occ = np.ascontiguousarray(occ, np.float64)
    corners = np.ascontiguousarray(corners, np.float64)
    T, K, Kw = len(corners), len(segs), len(occ)
    out = np.zeros((T, K), np.uint8)
    lib.tile_blocked_mask(
        segs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ctypes.c_int(K),
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ctypes.c_int(Kw),
        corners.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int(T), ctypes.c_double(max_range),
        ctypes.c_double(tile_size * np.sqrt(2.0)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return out.astype(bool)


def tile_visibility(
    segs: np.ndarray,
    max_range: float,
    tile_size: float,
    bbox: Tuple[float, float, float, float],
    occluders: np.ndarray = None,
) -> Tuple[np.ndarray, int, int, float, float]:
    """Per-tile visible-segment masks.

    segs: (K, 4) [ax, ay, bx, by] world-frame wall segments (no padding).
    occluders: optional (Kw, 4) segment set to test blocking against
    (default: segs itself). Occluders may be any genuine wall geometry —
    e.g. the UNSPLIT originals when segs are split pieces — because a
    blocked sightline p->q implies a kernel hit strictly before q, and the
    strictly-decreasing-t descent through culled blockers always grounds
    out in an unculled table segment (each segment crosses a beam at most
    once, so the descent cannot revisit one).
    Returns (vis (n_tiles, K) bool in j-major tile order, nx, ny, x0, y0).

    Tile squares are grown by ~2 mm on every side before the visibility
    proofs, so the kernel's f32 tile assignment floor((x - x0) * inv_ts)
    (ops/scan_kernel.py) may round a pose sitting exactly on a tile
    boundary to either neighbor: both neighbors' grown squares contain the
    pose, so whichever table is selected still provably covers it.
    """
    segs = np.asarray(segs, np.float64)
    occ = segs if occluders is None else np.asarray(occluders, np.float64)
    K = len(segs)
    grow = 2e-3  # meters; >> f32 ulp of O(100 m) coordinates (~1e-5)
    xmin, ymin, xmax, ymax = bbox
    nx = max(1, int(np.ceil((xmax - xmin) / tile_size)))
    ny = max(1, int(np.ceil((ymax - ymin) / tile_size)))
    ti = np.arange(nx) * tile_size + xmin
    tj = np.arange(ny) * tile_size + ymin
    cx, cy = np.meshgrid(ti, tj)  # (ny, nx), j-major
    # (T, 4, 2) epsilon-grown tile corners
    g, tg = grow, tile_size + grow
    corners = np.stack(
        [
            np.stack([cx - g, cy - g], -1),
            np.stack([cx + tg, cy - g], -1),
            np.stack([cx + tg, cy + tg], -1),
            np.stack([cx - g, cy + tg], -1),
        ],
        axis=2,
    ).reshape(-1, 4, 2)
    T = len(corners)

    a = segs[:, 0:2]
    b = segs[:, 2:4]

    # --- range cull: dist(tile center, segment) - half-diagonal > max_range
    center = corners.mean(1)  # (T, 2)
    e = b - a  # (K, 2)
    len2 = np.maximum((e * e).sum(-1), 1e-30)
    ap = center[:, None, :] - a[None, :, :]  # (T, K, 2)
    u = np.clip((ap * e[None]).sum(-1) / len2[None], 0.0, 1.0)
    closest = a[None] + u[..., None] * e[None]
    d = np.hypot(*(center[:, None, :] - closest).transpose(2, 0, 1))
    half_diag = (tile_size + 2 * grow) * np.sqrt(2.0) / 2.0
    vis = d - half_diag <= max_range  # (T, K)

    # --- umbra cull: blocked(T, S) = any W properly crossing all 8
    # corner->endpoint sightlines. Native C++ sweep when built (early-exit
    # + range-pruned + OpenMP over tiles; minutes -> seconds on the
    # K >= 700 venue maps), else the vectorized numpy loop over occluders.
    blocked = _blocked_native(segs, occ, corners, max_range,
                              tile_size + 2 * grow)
    if blocked is not None:
        return vis & ~blocked, nx, ny, float(xmin), float(ymin)
    q = np.stack([a, b], axis=1)  # (K, 2, 2) endpoints
    p = corners  # (T, 4, 2)
    qp = q[None, None, :, :, :] - p[:, :, None, None, :]  # (T, 4, K, 2, 2)
    blocked = np.zeros((T, K), bool)
    oa, ob = occ[:, 0:2], occ[:, 2:4]
    oe = ob - oa
    olen2 = (oe * oe).sum(-1)
    order = np.argsort(-olen2)  # long walls block the most: test them first
    for w in order:
        w1, w2 = oa[w], ob[w]
        ew = oe[w]
        if olen2[w] < 1e-12:
            continue
        # d3: which side of W each corner is on; d4: each endpoint
        d3 = _cross(ew[0], ew[1], p[..., 0] - w1[0], p[..., 1] - w1[1])  # (T,4)
        d4 = _cross(ew[0], ew[1], q[..., 0] - w1[0], q[..., 1] - w1[1])  # (K,2)
        straddle_w = d3[:, :, None, None] * d4[None, None, :, :] < -_EPS
        # d1/d2: W endpoints on opposite sides of each sightline p->q
        w1p = w1[None, None, :] - p  # (T, 4, 2)
        w2p = w2[None, None, :] - p
        d1 = _cross(
            qp[..., 0], qp[..., 1],
            w1p[:, :, None, None, 0], w1p[:, :, None, None, 1],
        )
        d2 = _cross(
            qp[..., 0], qp[..., 1],
            w2p[:, :, None, None, 0], w2p[:, :, None, None, 1],
        )
        crossing = (d1 * d2 < -_EPS) & straddle_w  # (T, 4, K, 2)
        # self-occlusion is impossible by strictness: an endpoint q lying ON
        # its own occluder gives d4 exactly 0, failing the straddle test
        blocked |= crossing.all(axis=(1, 3))  # (T, K)
    return vis & ~blocked, nx, ny, float(xmin), float(ymin)


# ---------------------------------------------------------------------------
# Erosion-based occluder FUSION
# ---------------------------------------------------------------------------
#
# The umbra test above is single-occluder: segment S is culled only when ONE
# wall W blocks every corner->endpoint sightline. On corridor maps the
# provable per-point visible set under that test is ~6 groups while the
# exact point-visible set is ~1.5 (docs/performance.md window-granularity
# table) — the gap is CUMULATIVE occlusion by several walls, which no
# single-W test can see, and naive per-sightline unions are unsound (gaps
# between occluders can be visible from tile interior points even when all
# corner sightlines are blocked).
#
# The sound fusion tool is volumetric, built on one lemma:
#
#   EROSION LEMMA. Let V be any region ("virtual solid"). If the segment
#   [c, q] contains a point x with B(x, r) subset of V, then for EVERY
#   viewpoint p with |p - c| <= r the segment [p, q] intersects V:
#   the point y = x + t*(p - c) (t* = the parameter of x on [c, q]) lies
#   on [p, q] and |y - x| = t*|p - c| <= r.
#
# So blocking proven from the tile-subcell CENTER against V eroded by the
# subcell circumradius holds for every pose in the subcell. V must be chosen
# so that "[p, q] intersects V deeply" implies "[p, q] crosses a TABLE
# SEGMENT strictly before q" (that is what makes removing S exact for the
# kernel's min-over-segments):
#
#   * The traced wall segments form CLOSED LOOPS (contour boundaries). For
#     a loop L, crossing from strictly-outside its polygon interior I(L) to
#     strictly-inside crosses one of L's segments.
#   * Fix an ELIGIBILITY raster E: free cells of one distinguished free
#     component whose centers are provably clear of every segment (with
#     several seeds, one certificate per component: _refine_components). A loop
#     is usable as "type-out" if NO eligible cell is inside I(L) (then
#     I(L) is virtual solid: an eligible p is outside, a deep point y is
#     inside -> crossing), or "type-in" if ALL eligible cells are inside
#     (then the EXTERIOR is virtual solid). V = the union of those regions,
#     shrunk 2.5 cells away from every segment so raster containment at
#     cell centers extends to full cells.
#
# Thin-wall maps (the reference example map: walls 2-3 cells thick) get
# their occluding bulk back this way: the infield interior and the outside
# region are virtual solid even though the raster walls are paper-thin.
#
# The per-(tile, segment) test then marches rays: subdivide S's angular
# extent from the subcell center c into pieces of width dtheta; for each
# piece, walk the central ray and accept when a sample x at distance d has
#
#   depth_V(x) >= r_subcell + 2*d*sin(dtheta/4) + slack,   d <= dmin(c,
#                                                          piece) - margin
#
# (the 2nd term covers the whole ray fan of the piece at distance d; the
# dmin bound keeps x strictly before every hit on S). Every quantity is
# conservative, so culled scans stay BIT-IDENTICAL to the full sweep — for
# ELIGIBLE poses. Ineligible poses (wrong component, within ~2.5 cells of
# a wall, off-grid) are handled at runtime: the scan gathers the
# eligibility raster at each scan origin and falls back to the full table
# for subgroups containing any ineligible scan, so end-to-end exactness
# holds for every pose unconditionally.

_ELIG_SEG_CELLS = 2.5   # eligibility: cell centers this far from segments
_CORE_SEG_CELLS = 2.5   # V shrink: core cells this far from segments
_DEPTH_SLACK_CELLS = 1.5  # raster center-vs-point association slack
# operating point of the JAX package's parameter sweep on the example map
# (occupancy-weighted groups/tile 9.91 umbra-only -> 6.26; finer settings
# saturate at 6.19 for 2x the host build time):
_PIECE_DTHETA = 0.04    # rad, angular piece width for the ray fan
_MARCH_STEP_CELLS = 1.5
_MARCH_CAP_M = 16.0     # rays needing deeper proofs keep the segment


def _reconstruct_loops(segs: np.ndarray):
    """(K, 4) segments -> list of index arrays forming CLOSED loops.

    The contour tracers emit consecutive polyline segments whose endpoints
    match exactly (verified on all bundled maps), so loops reconstruct by
    exact endpoint lookup. Open chains and ambiguous junctions are dropped
    (they simply contribute no occluder bulk — conservative)."""
    start = {}
    for i, (ax, ay, _, _) in enumerate(segs):
        start.setdefault((ax, ay), []).append(i)
    loops = []
    seen = set()
    for i in range(len(segs)):
        if i in seen:
            continue
        chain = [i]
        seen.add(i)
        j = i
        while True:
            nxt = start.get((segs[j, 2], segs[j, 3]), [])
            nxt = [n for n in nxt if n not in seen or n == chain[0]]
            if len(nxt) != 1:
                chain = None
                break
            j = nxt[0]
            if j == chain[0]:
                loops.append(np.asarray(chain))
                break
            chain.append(j)
            seen.add(j)
    return loops


def _scanline_interior(loop_segs: np.ndarray, H: int, W: int,
                       x0: float, y0: float, res: float,
                       r0: int = 0, c0: int = 0) -> np.ndarray:
    """Even-odd interior mask of one closed polyline, at the centers of
    the H x W raster cells from cell (r0, c0) on."""
    ys = y0 + (np.arange(r0, r0 + H) + 0.5) * res
    diff = np.zeros((H, W + 1), np.int32)
    for ax, ay, bx, by in loop_segs:
        if ay == by:
            continue
        ylo, yhi = (ay, by) if ay < by else (by, ay)
        rows = np.nonzero((ys >= ylo) & (ys < yhi))[0]
        if not len(rows):
            continue
        t = (ys[rows] - ay) / (by - ay)
        xi = ax + t * (bx - ax)
        # cells whose CENTER x0 + (c + .5) res < xi get one crossing
        ci = np.clip(np.ceil((xi - x0) / res - 0.5).astype(np.int64) - c0,
                     0, W)
        np.add.at(diff[:, 0], rows, 1)
        np.add.at(diff, (rows, ci), -1)
    return (np.cumsum(diff[:, :W], axis=1) % 2).astype(bool)


def _rasterize_segments(segs: np.ndarray, H: int, W: int,
                        x0: float, y0: float, res: float) -> np.ndarray:
    """Mark every cell a segment passes through (samples every 0.4 cells:
    any segment point is within ~0.9 cells of a marked cell center)."""
    mark = np.zeros((H, W), bool)
    step = 0.4 * res
    for ax, ay, bx, by in segs:
        n = max(2, int(np.ceil(np.hypot(bx - ax, by - ay) / step)) + 1)
        t = np.linspace(0.0, 1.0, n)
        cx = np.floor((ax + t * (bx - ax) - x0) / res).astype(np.int64)
        cy = np.floor((ay + t * (by - ay) - y0) / res).astype(np.int64)
        ok = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
        mark[cy[ok], cx[ok]] = True
    return mark


def _seed_points(component_seed) -> Optional[np.ndarray]:
    """``component_seed`` as (n, 2) world (x, y) rows: None, one (x, y),
    or a sequence of them."""
    if component_seed is None:
        return None
    return np.asarray(component_seed, np.float64).reshape(-1, 2)


def erosion_refine(
    segs: np.ndarray,
    vis: np.ndarray,
    nx: int,
    ny: int,
    x0t: float,
    y0t: float,
    tile_size: float,
    bitmap: np.ndarray,
    resolution: float,
    origin,
    component_seed=None,
    subcenters: int = 3,
):
    """Refine per-tile visibility with erosion-fused occluders.

    segs: (K, 4) the table segments; vis: (n_tiles, K) current visibility
    (j-major, from tile_visibility); bitmap: the loaded occupancy raster
    (0 = wall, >0 = free, already flipped to world orientation);
    component_seed: world (x, y) picking the distinguished free component
    (default: the component with the most near-wall area — the corridor),
    or a sequence of them: then each seed's component is certified on its
    own (``_refine_components``), as a multi-track world's corridors are.

    Returns (vis', eligible) with vis' <= vis elementwise and eligible an
    (H, W) uint8 raster for the runtime gate, or (vis, None) when fusion
    is unavailable (rotated map origin, no closed loops, empty eligibility).
    ``erosion_refine.components`` counts the components certified.
    """
    from scipy import ndimage

    if abs(float(origin[2])) > 1e-9:
        return vis, None  # raster<->world rotation unsupported; skip
    H, W = bitmap.shape
    x0, y0 = float(origin[0]), float(origin[1])
    res = float(resolution)

    loops = _reconstruct_loops(segs)
    loops = [ix for ix in loops if len(ix) >= 3]
    if not loops:
        return vis, None

    free = bitmap > 0
    seg_mark = _rasterize_segments(segs, H, W, x0, y0, res)
    d_seg = ndimage.distance_transform_edt(~seg_mark)  # cells

    labels, nlab = ndimage.label(free)
    if nlab == 0:
        return vis, None
    seeds = _seed_points(component_seed)
    centers, r_i = _subcenters(nx, ny, x0t, y0t, tile_size, subcenters)
    if seeds is not None and len(seeds) > 1:
        return _refine_components(segs, vis, nx, ny, x0t, y0t, tile_size,
                                  loops, free, labels, d_seg, seeds, centers,
                                  r_i, x0, y0, res)
    if seeds is not None:
        ci = int(np.floor((seeds[0, 0] - x0) / res))
        ri = int(np.floor((seeds[0, 1] - y0) / res))
        if not (0 <= ri < H and 0 <= ci < W) or labels[ri, ci] == 0:
            return vis, None
        lab = labels[ri, ci]
    else:
        # corridor heuristic: the component with the most near-wall cells
        d_occ = ndimage.distance_transform_edt(free) * res
        near = (d_occ <= 1.0) & free
        counts = np.bincount(labels[near], minlength=nlab + 1)
        counts[0] = 0
        lab = int(np.argmax(counts))
    eligible = (labels == lab) & (d_seg >= _ELIG_SEG_CELLS)
    if not eligible.any():
        return vis, None

    # --- virtual solid V from certified loop interiors/exteriors
    V = np.zeros((H, W), bool)
    usable = 0
    for ix in loops:
        interior = _scanline_interior(segs[ix], H, W, x0, y0, res)
        if not (eligible & interior).any():
            V |= interior                 # type-out: no eligible pose inside
            usable += 1
        elif not (eligible & ~interior).any():
            V |= ~interior                # type-in: every eligible pose inside
            usable += 1
    if not usable:
        return vis, None
    core = V & (d_seg >= _CORE_SEG_CELLS)
    depth = (ndimage.distance_transform_edt(core)
             - _DEPTH_SLACK_CELLS) * res   # meters, conservative
    np.maximum(depth, 0.0, out=depth)

    tt, kk = np.nonzero(vis)
    if not len(tt):
        return vis, None
    blocked = _march_blocked(segs, tt, kk, centers, r_i, depth, x0, y0, res)
    vis = vis.copy()
    vis[tt[blocked], kk[blocked]] = False
    erosion_refine.components += 1
    return vis, eligible.astype(np.uint8)


erosion_refine.components = 0


def _subcenters(nx, ny, x0t, y0t, tile_size, sc):
    """((T, sc*sc, 2) world centers of each tile's sc x sc subcells, the
    subcell circumradius, grown as tile_visibility grows the tiles)."""
    sub = tile_size / sc
    r_i = sub * np.sqrt(2.0) / 2.0 + 2e-3 * np.sqrt(2.0)
    ti = np.arange(nx) * tile_size + x0t
    tj = np.arange(ny) * tile_size + y0t
    cxg, cyg = np.meshgrid(ti, tj)            # (ny, nx)
    offs = (np.arange(sc) + 0.5) * sub
    ox, oy = np.meshgrid(offs, offs)
    centers = (np.stack([cxg, cyg], -1).reshape(-1, 1, 2)
               + np.stack([ox.ravel(), oy.ravel()], -1)[None])  # (T, S2, 2)
    return centers, r_i


def _march_blocked(segs, tt, kk, centers, r_i, depth, x0, y0, res,
                   r0: int = 0, c0: int = 0) -> np.ndarray:
    """(M,) bool: candidate (tile tt, segment kk) is proven blocked from
    every subcell of the tile by the virtual solid whose depth field (m)
    is ``depth``, raster cells from (r0, c0) on (module comment above)."""
    H, W = depth.shape
    a = segs[:, 0:2]
    e = segs[:, 2:4] - a
    S2 = centers.shape[1]
    # flat (cand, subcenter) axis
    C = centers[tt]                            # (M, S2, 2)
    A_ = a[kk][:, None, :]
    E_ = e[kk][:, None, :]
    ca = A_ - C                                # (M, S2, 2) c->a
    cb = ca + E_
    tha = np.arctan2(ca[..., 1], ca[..., 0])
    thb = np.arctan2(cb[..., 1], cb[..., 0])
    width = thb - tha
    width = (width + np.pi) % (2 * np.pi) - np.pi   # short way, (-pi, pi)
    # distance c -> segment
    len2 = np.maximum((E_ * E_).sum(-1), 1e-30)
    u = np.clip(-(ca * E_).sum(-1) / len2, 0.0, 1.0)
    foot = ca + u[..., None] * E_
    dmin_seg = np.hypot(foot[..., 0], foot[..., 1])
    testable = (np.abs(width) > 1e-9) & (dmin_seg > r_i + 0.05)

    n_pieces = np.where(
        testable,
        np.ceil(np.abs(width) / _PIECE_DTHETA).astype(np.int64), 0)
    n_pieces = np.minimum(n_pieces, 64)

    # blocked status per (M, S2); untestable -> NOT blocked
    blocked_cs = np.zeros(tt.shape[0] * S2, bool)

    flat_np = n_pieces.ravel()
    pid = np.nonzero(flat_np > 0)[0]           # (cand,sub) with pieces
    if len(pid):
        reps = flat_np[pid]
        owner = np.repeat(pid, reps)           # piece -> (cand,sub) row
        within = np.concatenate([np.arange(r) for r in reps])
        cw = C.reshape(-1, 2)
        caw = ca.reshape(-1, 2)
        ew = np.broadcast_to(E_, (len(tt), S2, 2)).reshape(-1, 2)
        thaw = tha.ravel()
        wdw = width.ravel()
        npw = flat_np
        # piece boundary angles + central angle
        t0 = thaw[owner] + wdw[owner] * within / npw[owner]
        t1 = thaw[owner] + wdw[owner] * (within + 1) / npw[owner]
        tc = 0.5 * (t0 + t1)
        half = 0.5 * np.abs(wdw[owner]) / npw[owner]
        # piece endpoints on S: ray/line intersection per boundary angle
        def _hit(th):
            d = np.stack([np.cos(th), np.sin(th)], -1)
            den = ew[owner, 0] * d[:, 1] - ew[owner, 1] * d[:, 0]
            den = np.where(np.abs(den) < 1e-30, 1e-30, den)
            uu = (caw[owner, 0] * d[:, 1] - caw[owner, 1] * d[:, 0]) / -den
            uu = np.clip(uu, 0.0, 1.0)
            return caw[owner] + uu[:, None] * ew[owner]   # c-relative
        q0 = _hit(t0)
        q1 = _hit(t1)
        pe = q1 - q0
        pl2 = np.maximum((pe * pe).sum(-1), 1e-30)
        uf = np.clip(-(q0 * pe).sum(-1) / pl2, 0.0, 1.0)
        pf = q0 + uf[:, None] * pe
        dmin_piece = np.minimum(
            np.hypot(pf[:, 0], pf[:, 1]),
            np.minimum(np.hypot(q0[:, 0], q0[:, 1]),
                       np.hypot(q1[:, 0], q1[:, 1])))
        dmax_march = np.minimum(dmin_piece - res, _MARCH_CAP_M)

        dirx = np.cos(tc)
        diry = np.sin(tc)
        cxw = cw[owner, 0]
        cyw = cw[owner, 1]
        sin4 = np.sin(half / 2.0)

        h = _MARCH_STEP_CELLS * res
        max_steps = int(np.ceil(_MARCH_CAP_M / h))
        alive = np.arange(len(owner))
        piece_blocked = np.zeros(len(owner), bool)
        for j in range(max_steps):
            if not len(alive):
                break
            d = (j + 0.5) * h
            live = d <= dmax_march[alive]
            alive = alive[live]
            if not len(alive):
                break
            px = cxw[alive] + d * dirx[alive]
            py = cyw[alive] + d * diry[alive]
            ci_ = np.floor((px - x0) / res).astype(np.int64) - c0
            ri_ = np.floor((py - y0) / res).astype(np.int64) - r0
            inb = (ci_ >= 0) & (ci_ < W) & (ri_ >= 0) & (ri_ < H)
            dep = np.where(inb, depth[np.clip(ri_, 0, H - 1),
                                      np.clip(ci_, 0, W - 1)], 0.0)
            hitmask = dep >= r_i + 2.0 * d * sin4[alive]
            piece_blocked[alive[hitmask]] = True
            alive = alive[~hitmask]

        # (cand, sub) blocked iff EVERY piece blocked
        good = np.ones(tt.shape[0] * S2, bool)
        np.logical_and.at(good, owner, piece_blocked)
        blocked_cs[pid] = good[pid]

    return blocked_cs.reshape(-1, S2).all(-1)   # all subcenters


def _cell_box(pts: np.ndarray, x0: float, y0: float, res: float, H: int,
              W: int):
    """(r0, r1, c0, c1): the raster cells whose centers may lie in the
    bounding box of the (n, 2) world points, clipped to the raster."""
    c0 = int(np.floor((pts[:, 0].min() - x0) / res)) - 1
    c1 = int(np.floor((pts[:, 0].max() - x0) / res)) + 2
    r0 = int(np.floor((pts[:, 1].min() - y0) / res)) - 1
    r1 = int(np.floor((pts[:, 1].max() - y0) / res)) + 2
    return max(r0, 0), min(r1, H), max(c0, 0), min(c1, W)


def _touched_tiles(el: np.ndarray, r0: int, c0: int, x0: float, y0: float,
                   res: float, nx: int, ny: int, x0t: float, y0t: float,
                   tile_size: float) -> np.ndarray:
    """(T,) bool: the tiles whose squares, grown as tile_visibility grows
    them, meet an eligible cell of ``el`` (raster cells from (r0, c0) on)
    grown by 1 mm: the tiles the kernel may assign a scan from such a
    cell to, whatever the f32 rounding of its pose."""
    rr, cc = np.nonzero(el)
    slack = 2e-3 + 1e-3
    xa = x0 + (cc + c0) * res
    ya = y0 + (rr + r0) * res
    touched = np.zeros((ny, nx), bool)
    i_lo = np.floor((xa - slack - x0t) / tile_size).astype(np.int64)
    i_hi = np.floor((xa + res + slack - x0t) / tile_size).astype(np.int64)
    j_lo = np.floor((ya - slack - y0t) / tile_size).astype(np.int64)
    j_hi = np.floor((ya + res + slack - y0t) / tile_size).astype(np.int64)
    for i in (i_lo, i_hi):
        for j in (j_lo, j_hi):
            ok = (i >= 0) & (i < nx) & (j >= 0) & (j < ny)
            touched[j[ok], i[ok]] = True
    return touched.ravel()


def _refine_components(segs, vis, nx, ny, x0t, y0t, tile_size, loops, free,
                       labels, d_seg, seeds, centers, r_i, x0, y0, res):
    """erosion_refine for several seeds: one certificate per component.

    Component k's eligible cells E_k are its cells >= _ELIG_SEG_CELLS from
    every segment; each loop is classified against E_k alone (type-out
    when no cell of E_k lies inside, type-in when every one does), which
    gives k's own virtual solid V_k: for a track's corridor, the exterior
    of its outer wall, its infield and every other track. The march of a
    (tile, segment) candidate runs under V_k for every k whose eligible
    cells the tile may hold a scan from (``_touched_tiles``), and the
    segment leaves the tile only when every such k proves it blocked: the
    erosion lemma holds for the poses on k's side of V_k's loops, which
    E_k's poses are. Tiles no component touches hold no eligible scan,
    so no scan takes a window for its own tile there: their sets are left
    empty, which keeps them from widening the windows they share with
    touched tiles. The eligibility raster is the union of the certified
    components' cells.

    The kernel's f32 hit test can let a beam through the vertex shared by
    two wall segments (both end tests fail). A certificate proves a
    segment blocked by the wall's geometry, so such a beam can reach what
    the certificate culled: it passes into the solid behind the vertex
    and the full table's next hit is a face of that same wall body. So a
    tile that keeps any face of a wall body keeps every face of it that
    its umbra set holds (``_wall_faces``), and the culled scan meets the
    full table's hit behind a leaking vertex too.

    Each loop's even-odd interior is computed once, on the cells of its
    bounding box; each component's depth field only on its own bounding
    box grown by a tile, the march's reach and a margin (the crop's edge
    counts as outside V_k, which only shortens the depths).
    """
    from scipy import ndimage

    H, W = labels.shape
    labs = []
    for sx, sy in seeds:
        ci = int(np.floor((sx - x0) / res))
        ri = int(np.floor((sy - y0) / res))
        if 0 <= ri < H and 0 <= ci < W and labels[ri, ci] != 0 \
                and labels[ri, ci] not in labs:
            labs.append(int(labels[ri, ci]))
    boxes = ndimage.find_objects(labels)
    interiors = []
    for ix in loops:
        ls = segs[ix]
        r0, r1, c0, c1 = _cell_box(ls.reshape(-1, 2), x0, y0, res, H, W)
        interiors.append((r0, c0, _scanline_interior(
            ls, r1 - r0, c1 - c0, x0, y0, res, r0, c0)))
    pad = int(np.ceil((tile_size + _MARCH_CAP_M + 1.0) / res))
    eligible = np.zeros((H, W), bool)
    n_touch = np.zeros(nx * ny, np.int32)
    n_blocked = np.zeros(vis.shape, np.int32)
    certified = 0
    for lab in labs:
        rs, cs = boxes[lab - 1]
        R0, R1 = max(rs.start - pad, 0), min(rs.stop + pad, H)
        C0, C1 = max(cs.start - pad, 0), min(cs.stop + pad, W)
        el = ((labels[R0:R1, C0:C1] == lab)
              & (d_seg[R0:R1, C0:C1] >= _ELIG_SEG_CELLS))
        n_el = int(el.sum())
        if not n_el:
            continue
        V = np.zeros(el.shape, bool)
        for r0, c0, inside in interiors:
            a0, a1 = max(r0, R0), min(r0 + inside.shape[0], R1)
            b0, b1 = max(c0, C0), min(c0 + inside.shape[1], C1)
            if a0 >= a1 or b0 >= b1:
                continue                  # type-out, and outside the crop
            part = inside[a0 - r0:a1 - r0, b0 - c0:b1 - c0]
            win = (slice(a0 - R0, a1 - R0), slice(b0 - C0, b1 - C0))
            n_in = int((el[win] & part).sum())
            if n_in == 0:
                V[win] |= part            # type-out: no eligible pose inside
            elif n_in == n_el:
                out = np.ones(el.shape, bool)   # type-in: the exterior
                out[win] = ~part
                V |= out
        core = np.pad(V & (d_seg[R0:R1, C0:C1] >= _CORE_SEG_CELLS), 1)
        depth = (ndimage.distance_transform_edt(core)[1:-1, 1:-1]
                 - _DEPTH_SLACK_CELLS) * res   # meters, conservative
        np.maximum(depth, 0.0, out=depth)
        touched = _touched_tiles(el, R0, C0, x0, y0, res, nx, ny, x0t, y0t,
                                 tile_size)
        tt, kk = np.nonzero(vis & touched[:, None])
        blocked = _march_blocked(segs, tt, kk, centers, r_i, depth, x0, y0,
                                 res, R0, C0)
        n_touch[touched] += 1
        n_blocked[tt[blocked], kk[blocked]] += 1
        eligible[R0:R1, C0:C1] |= el
        certified += 1
    if not certified:
        return vis, None
    erosion_refine.components += certified
    kept = vis & (n_blocked < n_touch[:, None])
    faces = _wall_faces(segs, free, x0, y0, res).astype(np.float32)
    bodies = (kept.astype(np.float32) @ faces) > 0       # (T, n_bodies)
    kept |= vis & ((bodies.astype(np.float32) @ faces.T) > 0)
    return kept, eligible.astype(np.uint8)


_FACE_CELLS = np.arange(1, 13) * 0.25   # _wall_faces' normal offsets


def _wall_faces(segs, free, x0, y0, res) -> np.ndarray:
    """(K, n_bodies) bool: segment k is a face of wall body b (a
    connected component of wall cells, 8-connected) found on either side
    of the segment within 3 cells, every quarter cell: the traced
    contours lie within their simplification tolerance (1.5 cells) of the
    raster boundary. A segment near two bodies counts as a face of both,
    which only keeps more faces."""
    from scipy import ndimage

    body, n_bodies = ndimage.label(~free, structure=np.ones((3, 3), bool))
    H, W = body.shape
    a = segs[:, 0:2]
    e = segs[:, 2:4] - a
    nrm = np.stack([-e[:, 1], e[:, 0]], -1) / np.maximum(
        np.hypot(e[:, 0], e[:, 1]), 1e-12)[:, None]
    out = np.zeros((len(segs), n_bodies + 1), bool)
    rows = np.arange(len(segs))
    for f in (0.0, 0.25, 0.5, 0.75, 1.0):
        p = a + f * e
        for d in np.concatenate([-_FACE_CELLS, _FACE_CELLS]):
            q = p + (d * res) * nrm
            ci = np.floor((q[:, 0] - x0) / res).astype(np.int64)
            ri = np.floor((q[:, 1] - y0) / res).astype(np.int64)
            ok = (ci >= 0) & (ci < W) & (ri >= 0) & (ri < H)
            out[rows[ok], body[ri[ok], ci[ok]]] = True
    return out[:, 1:]


def split_segments(segs: np.ndarray, max_len: float) -> np.ndarray:
    """Split (K, 4) segments into collinear pieces of length <= max_len.

    Exact: a hit on a piece is a hit on the original at the same distance
    (shared endpoints count for both pieces via the kernel's inclusive
    0 <= w <= 1 bounds). Splitting lets partially-occluded long walls be
    culled piecewise.
    """
    segs = np.asarray(segs, np.float64)
    out = []
    for ax, ay, bx, by in segs:
        n = max(1, int(np.ceil(np.hypot(bx - ax, by - ay) / max_len)))
        ts = np.linspace(0.0, 1.0, n + 1)
        xs = ax + (bx - ax) * ts
        ys = ay + (by - ay) * ts
        for i in range(n):
            out.append([xs[i], ys[i], xs[i + 1], ys[i + 1]])
    return np.asarray(out)


def _window_union(v: np.ndarray, w: int) -> np.ndarray:
    """(ny, nx, K) per-tile masks -> per-LOWER-LEFT-tile union over the
    w x w tile window [i, i+w) x [j, j+w), clamped at the grid edge."""
    ny, nx, K = v.shape
    vp = np.zeros((ny + w - 1, nx + w - 1, K), bool)
    vp[:ny, :nx] = v
    u = np.zeros_like(v)
    for dj in range(w):
        for di in range(w):
            u |= vp[dj:dj + ny, di:di + nx]
    return u


def _pad_groups(n: int, GROUP: int) -> int:
    return max(1, -(-n // GROUP)) * GROUP


def build_tile_tables(
    segments: np.ndarray,
    max_range: float,
    tile_size: float = 2.5,
    neighborhood: int = 1,
    split_len: float = None,
    max_bytes: int = 1 << 30,
    split_cap_groups: int = 0,
    window_cap_groups: int = None,
    bitmap: np.ndarray = None,
    resolution: float = None,
    origin=None,
    component_seed=None,
) -> TileTables:
    """Build the packed multi-window kernel tables (v9, see TileTables).

    bitmap/resolution/origin (optional): the occupancy raster the segments
    were traced from. When provided, per-tile visibility is refined with
    EROSION-FUSED multi-occluder proofs (see erosion_refine) and the pack
    becomes eligibility-GATED: the returned ``eligible`` raster must be
    given to the scan so ineligible scan origins fall back to the full
    table. component_seed picks the distinguished free component (world
    x, y), default the corridor; a sequence of (x, y) certifies each
    seed's component on its own (erosion_refine).

    segments: (K, 4) wall segments (padding rows with coords >= 1e6 are
    dropped, matching build_seg_table). split_len (optional) splits targets
    into pieces of <= split_len so partially-occluded walls cull piecewise;
    occluders stay UNSPLIT (long walls block the most sightlines) —
    measured a net LOSS on the reference maps (visible walls inflate row
    counts more than occluded ones shrink), so default off.

    Per window the builder chooses between the v9 SPLIT layout
    (common-intersection + per-member-tile extras: every scan sweeps
    exactly its own tile's visible set) and the plain union layout —
    split wherever its total rows fit ``split_cap_groups`` groups (the
    split total exceeds the union by the duplication of segments shared
    by some-but-not-all member tiles, so wide windows on open maps fall
    back to the union). Blocks are deduped by content; ``blockmap``
    carries the window -> block indirection. Grows tile_size if the
    deduped pack would exceed max_bytes.

    window_cap_groups (optional) drops windows whose table would exceed
    that many groups to the full-table sentinel, which shrinks the pack's
    padded Kmax. Uncapped by default; sparse multi-track worlds cap.

    split_cap_groups defaults to 0 (never split, union blocks only), as
    in the JAX package; the kernel supports split blocks all the same.
    """
    from f1tenth_gym_tpu_torch.ops.scan_kernel import GROUP, build_seg_table

    orig = np.asarray(segments, np.float64)
    orig = orig[orig[:, 0] < 1e6]
    segs = split_segments(orig, split_len) if split_len else orig
    xs = np.concatenate([orig[:, 0], orig[:, 2]])
    ys = np.concatenate([orig[:, 1], orig[:, 3]])
    # walls enclose free space, so the segment bbox covers every free pose
    bbox = (xs.min() - 1e-6, ys.min() - 1e-6, xs.max() + 1e-6, ys.max() + 1e-6)

    full = build_seg_table(orig)  # (Kfull_pad, 8)
    full_rows = len(full)

    while True:
        vis, nx, ny, x0, y0 = tile_visibility(segs, max_range, tile_size,
                                              bbox, occluders=orig)
        eligible = None
        if bitmap is not None:
            vis, eligible = erosion_refine(
                segs, vis, nx, ny, x0, y0, tile_size,
                np.asarray(bitmap), resolution, origin,
                component_seed=component_seed)
        T = nx * ny
        v = vis.reshape(ny, nx, -1)

        # --- plan every window as index sets (cheap), dedupe by content,
        # and only then materialize unique blocks
        plans = {}          # content key -> (block_idx, layout tuple)
        blockmap = np.full(4 * T, -1, np.int32)
        order = []          # unique layouts in first-seen order

        def plan_window(tier_slot, t, members):
            """members: list of (m_index, (K,) bool mask) for in-grid tiles
            of the w x w window at lower-left tile t."""
            union = np.zeros(v.shape[-1], bool)
            for _, mk in members:
                union |= mk
            u_idx = np.flatnonzero(union)
            union_rows = _pad_groups(len(u_idx), GROUP)
            common = union.copy()
            for _, mk in members:
                common &= mk
            c_idx = np.flatnonzero(common)
            ex = [(m, np.flatnonzero(mk & ~common)) for m, mk in members]
            split_rows = _pad_groups(len(c_idx), GROUP) + sum(
                _pad_groups(len(e), GROUP) if len(e) else 0 for _, e in ex)
            # split whenever it fits the cap: the objective is the PER-SCAN
            # sweep (common + own extras = exactly the scan's tile set),
            # not block size — a split block bigger than the full table
            # still sweeps far fewer groups per scan
            use_split = (split_rows <= split_cap_groups * GROUP
                         and any(len(e) for _, e in ex))
            if not use_split and union_rows >= full_rows:
                return          # culling bought nothing: full-table sentinel
            rows_needed = split_rows if use_split else union_rows
            if window_cap_groups and rows_needed > window_cap_groups * GROUP:
                return          # oversized window: cheaper as a fallback
            if use_split:
                key = (b"s", c_idx.tobytes(),
                       tuple((m, e.tobytes()) for m, e in ex))
                layout = ("split", c_idx, ex)
            else:
                key = (b"u", u_idx.tobytes())
                layout = ("union", u_idx, [])
            got = plans.get(key)
            if got is None:
                got = len(order)
                plans[key] = got
                order.append(layout)
            blockmap[tier_slot * T + t] = got

        valid = np.zeros((ny + 8, nx + 8), bool)
        valid[:ny, :nx] = True
        vp = np.zeros((ny + 8, nx + 8, v.shape[-1]), bool)
        vp[:ny, :nx] = v
        for tier_slot, w in ((0, 2), (1, 1), (2, 4), (3, 8)):
            for j in range(ny):
                for i in range(nx):
                    members = []
                    for dj in range(w):
                        for di in range(w):
                            if valid[j + dj, i + di]:
                                members.append((dj * w + di,
                                                vp[j + dj, i + di]))
                    plan_window(tier_slot, j * nx + i, members)

        # block sizes -> Kmax; bytes check with the DEDUPED block count
        def block_rows(layout):
            kind, c_idx, ex = layout
            if kind == "union":
                return _pad_groups(len(c_idx), GROUP)
            return _pad_groups(len(c_idx), GROUP) + sum(
                _pad_groups(len(e), GROUP) if len(e) else 0 for _, e in ex)

        kmax_pad = max([GROUP] + [block_rows(pl) for pl in order])
        if len(order) * kmax_pad * 32 <= max_bytes:
            break
        tile_size *= 1.5  # coarser grid: fewer tables, bigger each

    n_blocks = max(1, len(order))
    tables = np.zeros((n_blocks, kmax_pad, 8), np.float32)
    # empty-group padding rows: never-valid (see build_seg_table)
    tables[:, :, 2] = 1.0
    tables[:, :, 5] = 10.0
    ngroups = np.zeros(n_blocks + 1, np.int32)
    ngroups[0] = full_rows // GROUP
    ngroups[1:] = 1                   # empty blocks keep one padding group
    ext = np.zeros((n_blocks, 64), np.int32)

    built = {}

    def seg_rows(idx):
        if len(idx) == 0:
            return None
        key = idx.tobytes()
        tab = built.get(key)
        if tab is None:
            tab = build_seg_table(segs[idx])
            built[key] = tab
        return tab

    for b, (kind, c_idx, ex) in enumerate(order):
        ctab = seg_rows(c_idx)
        pos = 0
        if ctab is not None:
            tables[b, :len(ctab)] = ctab
            pos = len(ctab)
        ngroups[1 + b] = max(1, pos // GROUP)
        pos = max(GROUP, pos)         # empty common still owns 1 pad group
        if kind == "split":
            for m, e_idx in ex:
                etab = seg_rows(e_idx)
                if etab is None:
                    continue          # no extras for this member: cnt 0
                tables[b, pos:pos + len(etab)] = etab
                ext[b, m] = (pos // GROUP) * 256 + len(etab) // GROUP
                pos += len(etab)

    return TileTables(
        tables=tables,
        ngroups=ngroups,
        blockmap=blockmap,
        ext=ext,
        x0=x0,
        y0=y0,
        tile_size=float(tile_size),
        nx=nx,
        ny=ny,
        neighborhood=8 if eligible is not None else 7,
        eligible=eligible,
    )


def pack_cache_key(segments, max_range, tile_size, neighborhood,
                   split_cap_groups, window_cap_groups, bitmap, resolution,
                   origin, component_seed) -> str:
    """The pack cache's key of build_tile_tables_cached's arguments. A
    list of seeds is hashed only when it holds more than one, so a map
    built from no seed or one keeps the key it has always had."""
    segs = np.ascontiguousarray(np.asarray(segments, np.float64))
    h = hashlib.sha1(b"tile-tables-v10")  # bump on algorithm changes
    h.update(segs.tobytes())
    h.update(np.float64([max_range, tile_size, neighborhood,
                         split_cap_groups,
                         window_cap_groups or 0]).tobytes())
    if bitmap is not None:
        h.update(np.ascontiguousarray(bitmap, np.uint8).tobytes())
        h.update(np.float64([resolution, *origin]).tobytes())
        seeds = _seed_points(component_seed)
        if seeds is not None and len(seeds) > 1:
            h.update(b"component-seeds")
            h.update(seeds.tobytes())
        else:
            h.update(np.float64((np.nan, np.nan) if seeds is None
                                else seeds[0]).tobytes())
    return h.hexdigest()[:16]


def build_tile_tables_cached(
    segments: np.ndarray,
    max_range: float,
    tile_size: float = 2.5,
    neighborhood: int = 1,
    cache_dir: Optional[str] = None,
    split_cap_groups: int = 0,
    window_cap_groups: int = None,
    bitmap: np.ndarray = None,
    resolution: float = None,
    origin=None,
    component_seed=None,
) -> TileTables:
    """build_tile_tables with an npz disk cache.

    The umbra sweep is O(tiles x K^2) host work; per-map results are
    immutable, so they are keyed by a hash of (segments, parameters)
    (``pack_cache_key``) and reused across processes. cache_dir=None means
    $F1TENTH_TORCH_CACHE, or else ``f1tenth_gym_tpu_torch/_build/map_cache``.
    """
    segs = np.ascontiguousarray(np.asarray(segments, np.float64))
    key = pack_cache_key(segs, max_range, tile_size, neighborhood,
                         split_cap_groups, window_cap_groups, bitmap,
                         resolution, origin, component_seed)
    cache_dir = cache_dir or os.environ.get(
        "F1TENTH_TORCH_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))), "_build", "map_cache"),
    )
    path = os.path.join(cache_dir, f"tiles_{key}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return TileTables(
            tables=z["tables"], ngroups=z["ngroups"],
            blockmap=z["blockmap"], ext=z["ext"], x0=float(z["x0"]),
            y0=float(z["y0"]), tile_size=float(z["tile_size"]),
            nx=int(z["nx"]), ny=int(z["ny"]),
            neighborhood=int(z["neighborhood"]),
            eligible=z["eligible"] if "eligible" in z.files else None,
        )
    tt = build_tile_tables(segs, max_range, tile_size=tile_size,
                           neighborhood=neighborhood,
                           split_cap_groups=split_cap_groups,
                           window_cap_groups=window_cap_groups,
                           bitmap=bitmap, resolution=resolution,
                           origin=origin, component_seed=component_seed)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}.npz"  # np.savez appends .npz itself
    extra = {} if tt.eligible is None else {"eligible": tt.eligible}
    np.savez(tmp[:-4], tables=tt.tables, ngroups=tt.ngroups,
             blockmap=tt.blockmap, ext=tt.ext, x0=tt.x0,
             y0=tt.y0, tile_size=tt.tile_size, nx=tt.nx, ny=tt.ny,
             neighborhood=tt.neighborhood, **extra)
    os.replace(tmp, path)
    return tt
