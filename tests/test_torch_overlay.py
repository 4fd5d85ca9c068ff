"""PyTorch port: the opponent overlay (ops/overlay_kernel.py) on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py holds it to the plain
version there, bit for bit); here the plain version, which is what a CPU
tensor runs, is held to the JAX Pallas overlay in interpret mode and to the
port's XLA-style opponent pass ``ray_cast_opponents``.

Tolerances: 1e-4 m against the JAX overlay, which computes the same f32
formulas in the same order, but XLA on the CPU contracts multiply-adds
into FMAs and its trig may differ by an ulp, so a beam's window or its
nearest edge can round the other way only at that size. 2e-3 m against
``ray_cast_opponents``, the JAX package's own bar for the two passes
(tests/test_pallas_scan.py:111-149): the windows agree but the
intersection is written in another form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.ops.collision import get_vertices as j_vertices
from f1tenth_gym_tpu.ops.pallas_scan import overlay_opponents_pallas
from f1tenth_gym_tpu_torch.ops import collision as col_ops
from f1tenth_gym_tpu_torch.ops import overlay_kernel as ok

NB, TD = 256, 2000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables():
    return P.make_scan_tables(num_beams=NB, device="cpu")


@pytest.fixture(scope="module")
def jtables():
    return J.make_scan_tables(num_beams=NB, dtype=jnp.float32)


def _ensemble(n, O, seed=0):
    """Scan poses, opponent boxes 0.5-12 m away in every direction and
    random scans: the draw of tests/test_pallas_scan.py:123-138."""
    rng = np.random.default_rng(seed)
    poses = np.stack([rng.uniform(-6, 6, n), rng.uniform(-6, 6, n),
                      rng.uniform(0, 2 * np.pi, n)], axis=1).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (n, O))
    dist = rng.uniform(0.5, 12.0, (n, O))
    opp_poses = np.stack(
        [poses[:, None, 0] + dist * np.cos(ang),
         poses[:, None, 1] + dist * np.sin(ang),
         rng.uniform(0, 2 * np.pi, (n, O))], axis=-1).astype(np.float32)
    verts = np.array(j_vertices(jnp.asarray(opp_poses), jnp.float32(0.58),
                                  jnp.float32(0.31)))     # (n, O, 4, 2)
    scans = rng.uniform(2.0, 30.0, (n, NB)).astype(np.float32)
    return poses, verts, scans


def _point(tables):
    """A point opponent 1.2 m out on beam 130's centre angle: every edge
    has zero length."""
    phi = float(tables.scan_angles[130])
    return np.tile(np.array([[1.2 * np.cos(phi), 1.2 * np.sin(phi)]],
                            np.float32), (4, 1))


# a box whose near edge lies on the scan origin's x axis
BOX = np.array([[1.0, 0.0], [1.5, 0.0], [1.5, 0.3], [1.0, 0.3]], np.float32)


@pytest.fixture(scope="module")
def fuzz(jtables, tables):
    """The n = 40, O = 3 ensemble, then two scans from the origin (pose
    zero, 25 m everywhere) with three copies of the point opponent and of
    BOX, and the JAX overlay of all 42 (one interpret-mode build for the
    module)."""
    poses, verts, scans = _ensemble(40, 3)
    poses = np.concatenate([poses, np.zeros((2, 3), np.float32)])
    verts = np.concatenate([verts, np.stack([[_point(tables)] * 3,
                                             [BOX] * 3])])
    scans = np.concatenate([scans, np.full((2, NB), 25.0, np.float32)])
    want = np.asarray(overlay_opponents_pallas(
        jnp.asarray(scans), jnp.asarray(poses), jnp.asarray(verts), jtables,
        NB, TD, interpret=True))
    return poses, verts, scans, want


def _overlay(tables, scans, poses, verts):
    return ok.overlay_opponents(torch.as_tensor(scans), torch.as_tensor(poses),
                                torch.as_tensor(verts), tables, NB,
                                device="cpu").numpy()


def _ray_cast(tables, scans, poses, verts):
    return col_ops.ray_cast_opponents(
        torch.as_tensor(poses), torch.as_tensor(scans),
        torch.as_tensor(verts), tables).numpy()


def test_plain_matches_jax_overlay(fuzz, tables):
    poses, verts, scans, want = fuzz
    got = _overlay(tables, scans, poses, verts)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert int((np.abs(want[:40] - scans[:40]) > 1e-3).sum()) > 50


@pytest.mark.parametrize("n,O", [(40, 3), (130, 1), (7, 5)])
def test_plain_matches_ray_cast_opponents(tables, n, O):
    """O = 3 and O = 5 fill two and three of the TPU kernel's 8-row edge
    groups; 130 scans is no multiple of its 128-scan program."""
    poses, verts, scans = _ensemble(n, O, seed=n)
    got = _overlay(tables, scans, poses, verts)
    want = _ray_cast(tables, scans, poses, verts)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert int((np.abs(got - scans) > 1e-3).sum()) > 50


def test_point_opponent_leaves_scan_unchanged(fuzz, tables):
    """The collinear pin of tests/test_pallas_scan.py:177-196. The
    reference's collinear fallback, kept by ray_cast_opponents, clips beam
    130 to the point's 1.2 m; the overlay omits the fallback and leaves
    the scan as it was, as the JAX overlay does."""
    poses, verts, scans, want = fuzz
    ref = _ray_cast(tables, scans[40:41], poses[40:41], verts[40:41, :1])
    assert np.flatnonzero(ref[0] != 25.0).tolist() == [130]
    assert ref[0, 130] == pytest.approx(1.2, abs=1e-6)
    for O in (1, 3):
        got = _overlay(tables, scans[40:41], poses[40:41], verts[40:41, :O])
        np.testing.assert_array_equal(got, 25.0)
    np.testing.assert_array_equal(want[40], 25.0)


def test_closed_box_agrees(fuzz, tables):
    """BOX supplies the distance through its other edges, so the two
    passes agree again (pallas test :198-208)."""
    poses, verts, scans, want = fuzz
    got = _overlay(tables, scans[41:], poses[41:], verts[41:, :1])
    ref = _ray_cast(tables, scans[41:], poses[41:], verts[41:, :1])
    assert float(ref.min()) == pytest.approx(1.0, abs=2e-3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[0], want[41], rtol=0, atol=1e-4)


def test_leading_axes_match_flat(tables):
    """(E, A) = (5, 2) scans, each clipped by the other agent's box, in
    one call: the same values as the flat batch."""
    poses, verts, scans = _ensemble(10, 1, seed=3)
    flat = _overlay(tables, scans, poses, verts)
    shaped = _overlay(tables, scans.reshape(5, 2, NB), poses.reshape(5, 2, 3),
                      verts.reshape(5, 2, 1, 4, 2))
    assert shaped.shape == (5, 2, NB)
    np.testing.assert_array_equal(shaped.reshape(10, NB), flat)


@pytest.mark.parametrize("O", [1, 2, 3])
def test_rows_padding_and_windows(tables, O):
    """Four edge rows an opponent and no padding rows (the TPU layout pads
    to groups of 8; the CUDA kernel loops over the rows it is given)."""
    poses, verts, scans = _ensemble(6, O, seed=O)
    w = ok.prepare_overlay(torch.as_tensor(scans), torch.as_tensor(poses),
                           torch.as_tensor(verts), tables, NB)
    assert w.rows.shape == (6, 4 * O, 8)
    lo, hi = w.rows[..., 6], w.rows[..., 7]
    assert bool(((0 <= lo) & (lo <= hi) & (hi <= NB - 1)).all())
    assert bool((lo == torch.round(lo)).all())
    # one window per opponent, on its four edges
    assert bool((lo.view(6, O, 4) == lo.view(6, O, 4)[..., :1]).all())
    assert w.window_pairs() == int((hi - lo + 1).sum())


def test_window_rounds_half_to_even(tables):
    """At an exact half-bin tie the overlay's window rounds half to even
    (jnp.round, as the JAX overlay), where ray_cast_opponents rounds half
    down (np.argmin's lower index). This vertex's bin position is 101.5
    exactly in f32, so its window is beam 102, not 101. At such a tie the
    two passes may clip different beams, which is why the comparisons
    above draw their boxes at random (ties have measure zero) and
    chip_smoke.py caps the beams they may differ on."""
    pt = np.tile(np.array([[2.0, -1.039228916168213]], np.float32), (4, 1))
    vecs = torch.as_tensor(pt[0])
    pos = ((torch.atan2(vecs[1], vecs[0]) + tables.fov / 2.0)
           / (tables.fov / (NB - 1)))
    assert float(pos) == 101.5
    w = ok.prepare_overlay(torch.full((1, NB), 25.0), torch.zeros(1, 3),
                           torch.as_tensor(pt[None, None]), tables, NB)
    assert w.rows[0, 0, 6] == w.rows[0, 0, 7] == 102.0


def test_launches_stay_zero_on_cpu(fuzz, tables):
    poses, verts, scans, _ = fuzz
    before = ok.overlay.launches
    _overlay(tables, scans, poses, verts)
    assert ok.overlay.launches == before


def test_no_fallback_on_other_devices():
    """A tensor on a device with no kernel raises; it is never run by the
    plain version."""
    w = ok.OverlayInputs(scans=torch.empty(2, 4, device="meta"),
                         rows=torch.empty(2, 8, 8, device="meta"),
                         scal=torch.empty(2, 4, device="meta"),
                         fan=torch.empty(2, 4, device="meta"))
    with pytest.raises(ValueError, match="no overlay kernel"):
        ok.overlay(w)


# The five bench beams on which the overlay kernel and ray_cast_opponents
# part by more than 2e-3 m on the card (chip_smoke.py phase ``overlay``,
# which prints each with its f32 inputs): (scan, beam, scan pose, the other
# car's box, scan value before the clip, overlay on the card,
# ray_cast_opponents on the card), 1080 beams.
GRAZES = [
    (710, 531, [-48.999786376953125, -10.032154083251953, 4.900728225708008],
     [[-48.604736328125, -10.567814826965332],
      [-48.90925598144531, -10.625855445861816],
      [-48.80066680908203, -11.195599555969238],
      [-48.49614715576172, -11.137558937072754]],
     5.262715816497803, 0.6005635261535645, 5.262715816497803),
    (1856, 583, [-50.374786376953125, -6.094654083251953, 4.962067604064941],
     [[-50.111053466796875, -6.6560869216918945],
      [-50.41143798828125, -6.7326860427856445],
      [-50.26812744140625, -7.29470157623291],
      [-49.967742919921875, -7.21810245513916]],
     11.08342456817627, 0.6202983856201172, 11.08342456817627),
    (6485, 88, [-46.25959396362305, 16.249889373779297, 5.2053327560424805],
     [[-47.06297302246094, 16.171669006347656],
      [-47.33606719970703, 16.02497100830078],
      [-47.06159973144531, 15.514022827148438],
      [-46.78850555419922, 15.660720825195312]],
     2.3239235877990723, 0.8071796298027039, 2.3239235877990723),
    (6566, 274, [-47.374786376953125, 16.405345916748047, 2.032364845275879],
     [[-47.099552154541016, 16.930395126342773],
      [-46.82199478149414, 17.068452835083008],
      [-47.08030319213867, 17.587759017944336],
      [-47.35786056518555, 17.4497013092041]],
     1.910310983657837, 0.8632989525794983, 1.910310983657837),
    (7784, 137, [-41.812286376953125, 23.905345916748047, 3.6342623233795166],
     [[-42.03937530517578, 24.613731384277344],
      [-42.185997009277344, 24.886863708496094],
      [-42.697021484375, 24.612533569335938],
      [-42.55039978027344, 24.339401245117188]],
     2.0511553287506104, 2.0511553287506104, 0.7438946962356567),
]


def _box_range_f64(pose, box, phi):
    """Nearest hit of the ray from ``pose`` at angle ``phi`` on the box's
    edges, in float64 and in the scan origin's frame; inf on a miss."""
    o = np.asarray(pose[:2], np.float64)
    d = np.array([np.cos(phi), np.sin(phi)])
    best = np.inf
    for i in range(4):
        a, b = np.asarray(box[i], np.float64), np.asarray(box[(i + 1) % 4])
        e, r = b - a, a - o
        den = d[0] * e[1] - d[1] * e[0]
        t = (r[0] * e[1] - r[1] * e[0]) / den
        u = (r[0] * d[1] - r[1] * d[0]) / den
        if t >= 0 and 0 <= u <= 1:
            best = min(best, t)
    return best


@pytest.mark.parametrize("case", GRAZES, ids=[f"scan{g[0]}" for g in GRAZES])
def test_bench_grazes_side_with_float64(case):
    """On each of the five bench beams the exact geometry, in float64,
    sides with ray_cast_opponents, and the overlay is the pass that is
    wrong. The beam passes within 5e-6 rad of a silhouette corner of a car
    0.6-0.9 m away, and its hit margin min(b, s - b) is smaller than what
    f32 can hold in the overlay's edge rows: they are in the world frame
    (w = -a.e/|e|^2 reaches 110-160 with |a| ~ 50 m on example_map, an
    f32 step of 7.6e-6 to 1.5e-5), where ray_cast_opponents works from the
    scan origin. The TPU kernel has the same formulation, which the CUDA
    kernel keeps bit for bit."""
    _, n, pose, box, scan_in, card_overlay, card_ray_cast = case
    B = 1080
    tables = P.make_scan_tables(num_beams=B, device="cpu")
    fov = float(tables.fov)
    phi = pose[2] - fov / 2 + n * (fov / (B - 1))
    va = np.asarray(box, np.float64)
    corners = np.arctan2(va[:, 1] - pose[1], va[:, 0] - pose[0])
    graze = np.abs((corners - phi + np.pi) % (2 * np.pi) - np.pi).min()
    assert graze < 5e-6
    want = min(scan_in, _box_range_f64(pose, box, phi))

    scans = torch.full((1, B), 30.0)
    scans[0, n] = scan_in
    pose_t = torch.tensor([pose], dtype=torch.float32)
    box_t = torch.tensor([[box]], dtype=torch.float32)
    got_ov = ok.overlay_opponents(scans, pose_t, box_t, tables, B,
                                  device="cpu")[0, n]
    got_rc = col_ops.ray_cast_opponents(pose_t, scans, box_t, tables)[0, n]
    # the CPU reproduces the card's values, and the two passes part
    assert float(got_ov) == pytest.approx(card_overlay, abs=1e-5)
    assert float(got_rc) == pytest.approx(card_ray_cast, abs=1e-5)
    assert float(got_rc) == pytest.approx(want, abs=1e-5)
    assert abs(float(got_ov) - want) > 2e-3

    # the overlay's rows and hit test (prepare_overlay, overlay_plain) in
    # float64: the deciding margin is under the f32 step of the row term w
    e = np.roll(va, -1, 0) - va
    len2 = (e ** 2).sum(1)
    nx, ny = -e[:, 1] / np.sqrt(len2), e[:, 0] / np.sqrt(len2)
    c = nx * va[:, 0] + ny * va[:, 1]
    tx, ty, w = e[:, 0] / len2, e[:, 1] / len2, -(va * e).sum(1) / len2
    ox, oy = pose[0], pose[1]
    dx, dy = np.cos(phi), np.sin(phi)
    s = (nx * dx + ny * dy) / (c - ox * nx - oy * ny)
    b = (ox * tx + oy * ty + w) * s + tx * dx + ty * dy
    q = np.minimum(b, s - b)
    k = int(np.argmax(q))
    assert (q[k] >= 0) == (want < scan_in)
    assert abs(q[k]) < np.spacing(np.float32(np.abs(w).max())) * abs(s[k])
