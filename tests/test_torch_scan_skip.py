"""PyTorch port: the scan kernel's row skip, as plain torch, on the CPU.

The CUDA kernel (csrc/scan_kernel.cu) runs the hit test of a warp's
128-beam chunk only on the rows whose arc, seen from the scan origin, meets
the chunk's sector widened by SKIP_DELTA; rows whose line passes nearer the
origin than SKIP_EPS, or which are longer than SKIP_RATIO times that
distance, are always kept. ``ops/scan_kernel.py::skip_keep`` transcribes
that test in the kernel's f32 operation order. The skip is sound when every
(scan, beam, row) pair whose hit test passes with s > 0 is kept
(``pair_counts(w)["missed"] == 0``): a dropped pair could only add 0 to
the range's max. Then the plain sweep restricted to the kept pairs
(``sweep_kept``) equals ``sweep_plain`` bit for bit, and so does the
kernel on the card (chip_smoke.py holds it to ``sweep_plain``).

Here: fixtures on a room of walls at the origin, at example_map's
coordinates (~80 m out) and 25 km out (the arc's ends come from the hit
test's own terms, so the budget does not depend on the map's extent): the
origin on a wall line (the |num| < 1e-12 clamp), at a shared vertex, 1 mm
from a wall, padding rows, a fan that crosses +-pi, and a LUT position
that wraps past theta_dis inside a chunk; origins near the walls, 25 km
out; a wall long against its distance (SKIP_RATIO). 1080 beams
throughout. The bundled maps:
tests/test_torch_scan_skip_map.py (example_map) and
tests/test_torch_scan_kernel.py (berlin, compact's split pack).
"""

import numpy as np
import pytest
import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

NB, TD = 1080, 2000
FOV = 4.7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables():
    return P.make_scan_tables(num_beams=NB, device="cpu")


def assert_sound(w):
    counts = sk.pair_counts(w)
    assert counts["hit"] > 0
    assert counts["missed"] == 0, counts
    assert counts["kept"] < counts["swept"]
    assert torch.equal(sk.sweep_kept(w), sk.sweep_plain(w))
    return counts


def rows_read_loop(w):
    """``sk.rows_read`` by a loop over the subgroups and their scans."""
    want = set()
    for sub, (b, ng) in enumerate(zip(w.bid.tolist(), w.ng.tolist())):
        want |= {(b, r) for r in range(ng * sk.GROUP)}
        for i in range(sub * sk.SUB, (sub + 1) * sk.SUB):
            if w.has_extras:
                e0, en = int(w.est[i]) * sk.GROUP, int(w.ecnt[i]) * sk.GROUP
                want |= {(b, e0 + r) for r in range(en)}
    return len(want)


# --------------------------------------------------------------------------
# fixtures on a room of walls
# --------------------------------------------------------------------------

# a 10 m x 6 m room, its long walls split in two, a pillar and a diagonal
# wall; 11 segments, so the table ends in 5 padding rows
ROOM = np.array([
    [-5, -3, 0, -3], [0, -3, 5, -3], [5, -3, 5, 3], [5, 3, 0, 3],
    [0, 3, -5, 3], [-5, 3, -5, -3],
    [1, 0, 2, 0], [2, 0, 2, 1], [2, 1, 1, 1], [1, 1, 1, 0],
    [-3, -2, -1, 1.5],
], np.float64)


def _theta_wrapping_lut(ti0):
    """The heading whose first beam sits at LUT position ti0."""
    return ti0 / TD * 2 * np.pi + FOV / 2


FIXTURES = {
    # x, y, theta in the room's frame; the wall line y = -3 holds the
    # first, so |num| = 0 < 1e-12 there
    "on_wall_line": [(2.5, -3.0, 1.2), (-1.0, -3.0, 2.0), (7.0, -3.0, 3.0)],
    "shared_vertex": [(0.0, -3.0, 1.57), (5.0, 3.0, -2.4), (2.0, 1.0, 0.3),
                      (1.0, 0.0, -2.0)],
    "one_mm": [(3.0, -2.999, 0.4), (4.999, 0.5, 2.9), (1.5, -0.001, 1.57),
               (-2.000868, -0.249504, 0.9)],
    "fan_across_pi": [(0.0, -1.5, np.pi), (-4.0, 0.0, -np.pi + 0.01),
                      (3.5, 2.0, np.pi - 0.3)],
    "lut_wraps": [(-4.0, -2.0, _theta_wrapping_lut(1950.0)),
                  (4.0, 2.0, _theta_wrapping_lut(1999.5)),
                  (0.0, 2.5, _theta_wrapping_lut(1900.25))],
}


FAR = (20000.0, 15000.0)   # 25 km from the map's origin


@pytest.mark.parametrize("offset", [(0.0, 0.0), (-75.0, -40.0), FAR],
                         ids=["at_origin", "example_map_coords", "25_km"])
@pytest.mark.parametrize("family", sorted(FIXTURES))
def test_room_fixtures(tables, family, offset):
    off = np.array(offset)
    table = sk.build_seg_table(ROOM + np.tile(off, 2))
    assert table.shape[0] == 16 and (table[11:, 3:5] == 0).all()
    poses = np.array(FIXTURES[family], np.float64)
    poses[:, :2] += off
    poses = torch.tensor(poses, dtype=torch.float32)
    w = sk.prepare(poses, torch.as_tensor(table), tables, NB, TD)
    if family == "on_wall_line":
        # the origin sits exactly on the wall line: the kernel's clamp
        num = (w.full[0, 2] - w.scal[:3, 0] * w.full[0, 0]
               - w.scal[:3, 1] * w.full[0, 1])
        assert bool((num.abs() < 1e-12).all())
    if family == "lut_wraps":
        t = w.scal[:3, 2:3] + torch.arange(sk.CHUNK) * w.scal[:3, 3:4]
        assert bool((t.max(-1).values >= TD).all())
    rows, valid = sk.scan_rows(w)
    keep = sk.skip_keep(w, rows, valid)
    assert not bool(keep[:, :, 11:16].any())   # padding rows: dropped
    assert_sound(w)


def near_walls(walls, n, d_lo, d_hi, off, seed):
    """(n, 3) f32 poses d_lo to d_hi m (log-uniform) from a random wall of
    ``walls``, past its ends by up to a fifth of its length, shifted by
    ``off``, every heading."""
    rng = np.random.default_rng(seed)
    seg = walls[rng.integers(0, len(walls), n)]
    u = rng.uniform(-0.2, 1.2, n)
    a, e = seg[:, :2], seg[:, 2:] - seg[:, :2]
    nrm = np.stack([-e[:, 1], e[:, 0]], 1) / np.linalg.norm(e, axis=1)[:, None]
    d = np.exp(rng.uniform(np.log(d_lo), np.log(d_hi), n))
    side = rng.choice([-1.0, 1.0], n)
    xy = a + u[:, None] * e + (side * d)[:, None] * nrm + np.asarray(off)
    poses = np.concatenate([xy, rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    return torch.tensor(poses, dtype=torch.float32)


def test_room_random_near_walls(tables):
    """304 origins 0.1 mm to 20 cm from a random wall of the room, at
    example_map's coordinates, every heading."""
    off = (-75.0, -40.0)
    table = sk.build_seg_table(ROOM + np.tile(off, 2))
    w = sk.prepare(near_walls(ROOM, 304, 1e-4, 0.2, off, 9),
                   torch.as_tensor(table), tables, NB, TD)
    assert_sound(w)


def test_room_far_from_map_origin(tables):
    """2048 origins 5 to 30 cm from the room's walls, 25 km out: f32 steps
    of 2 mm there, against a margin of 1e-3 rad (50 to 300 um at these
    distances). The arc's ends come from the hit test's own num and uo, so
    their rounding is the hit test's."""
    table = sk.build_seg_table(ROOM + np.tile(FAR, 2))
    w = sk.prepare(near_walls(ROOM, 2048, 0.05, 0.3, FAR, 11),
                   torch.as_tensor(table), tables, NB, TD)
    assert_sound(w)


def test_long_wall_kept(tables):
    """A 300 m wall seen from 5 cm to 1 m: where it is longer than
    SKIP_RATIO times its distance, every warp keeps it; everywhere the
    skip stays sound."""
    wall = np.array([[-150.0, 0.0, 150.0, 0.0], [-150.0, 5.0, -150.0, 0.0]])
    table = sk.build_seg_table(wall)
    poses = near_walls(wall[:1], 256, 0.05, 1.0, (0.0, 0.0), 3)
    w = sk.prepare(poses, torch.as_tensor(table), tables, NB, TD)
    rows, valid = sk.scan_rows(w)
    keep = sk.skip_keep(w, rows, valid)
    long_ = poses[:, 1].abs() * sk.SKIP_RATIO < 299.0
    assert 0 < int(long_.sum()) < len(poses)
    assert bool(keep[long_, :, 0].all())
    assert not bool(keep[~long_, :, 0].all())
    assert_sound(w)


@pytest.mark.parametrize("beams,warps", [(1080, 9), (108, 1), (256, 2),
                                         (2048, 16), (2200, 9)])
def test_warps_per_block(beams, warps):
    assert sk.warps_per_block(beams) == warps
