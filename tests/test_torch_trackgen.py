"""PyTorch port: the polygon fill, random track generation and the track
files (tracks/raster.py, tracks/trackgen.py, utils/image_io.py writers).

The JAX package's generator fills the corridor with cv2 and writes the
files with Pillow and PyYAML; the port does neither. Every byte downstream
depends on the raster, so the fill must equal ``cv2.fillPoly`` pixel for
pixel and the generated tracks the JAX package's exactly (float64).
Mirrors tests/test_trackgen.py for the port.
"""

import os
import subprocess
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.tracks import trackgen as J
from f1tenth_gym_tpu_torch.tracks import trackgen as T
from f1tenth_gym_tpu_torch.tracks.raster import fill_poly
from f1tenth_gym_tpu_torch.utils import image_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cv2_fill(shape, pts, color=255, base=0):
    img = np.full(shape, base, np.uint8)
    cv2.fillPoly(img, [np.asarray(pts, np.int32).reshape(-1, 1, 2)], color)
    return img


def _polygons(kind, n_polys, seed):
    """Random int32 polygons inside their raster: convex (sorted angles on
    a circle, then hulled by the sort), star-shaped (sorted angles, random
    radii: concave) or arbitrary (random points: self-intersecting)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_polys):
        h, w = (int(v) for v in rng.integers(16, 160, 2))
        n = int(rng.integers(3, 16))
        c = np.array([w / 2, h / 2])
        if kind == "arbitrary":
            pts = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)],
                           1)
        else:
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            rmax = min(h, w) / 2 - 1
            r = (np.full(n, rmax) if kind == "convex"
                 else rng.uniform(0.2 * rmax, rmax, n))
            pts = c + np.stack([r * np.cos(ang), r * np.sin(ang)], 1)
        yield (h, w), np.round(pts).astype(np.int32)


@pytest.mark.parametrize("kind,n_polys,seed", [("convex", 67, 1),
                                               ("star", 67, 2),
                                               ("arbitrary", 66, 3)])
def test_fill_poly_equals_cv2_random_polygons(kind, n_polys, seed):
    for shape, pts in _polygons(kind, n_polys, seed):
        want = _cv2_fill(shape, pts)
        got = fill_poly(np.zeros(shape, np.uint8), pts, 255)
        assert np.array_equal(got, want), (kind, shape, pts.tolist())


def test_fill_poly_degenerate_and_clipped():
    """A flat polygon, repeated vertices and the (N, 1, 2) layout."""
    for pts in ([[2, 5], [9, 5], [4, 5]], [[3, 3], [3, 3], [8, 9], [8, 9]],
                [[1, 1], [12, 2], [12, 2], [6, 11]]):
        pts = np.asarray(pts, np.int32)
        want = _cv2_fill((14, 15), pts)
        got = fill_poly(np.zeros((14, 15), np.uint8), pts.reshape(-1, 1, 2),
                        255)
        assert np.array_equal(got, want), pts.tolist()
    with pytest.raises(TypeError, match="integer"):
        fill_poly(np.zeros((4, 4)), np.zeros((3, 2)), 1)


@pytest.mark.parametrize("seed", range(16))
def test_fill_poly_equals_cv2_track_rings(seed):
    """Both offset rings of a generated track, filled as rasterize_track
    fills them (the big ring free, then the island solid)."""
    center = J.generate_centerline(np.random.default_rng(seed))
    d = np.roll(center, -1, axis=0) - center
    nrm = np.stack([-d[:, 1], d[:, 0]], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    rings = [center - nrm * 1.6, center + nrm * 1.6]
    lo = np.minimum(*(r.min(0) for r in rings)) - 2.0
    hi = np.maximum(*(r.max(0) for r in rings)) + 2.0
    shape = tuple(np.ceil((hi - lo) / 0.0625).astype(int)[::-1])
    want = np.zeros(shape, np.uint8)
    got = np.zeros(shape, np.uint8)
    for ring in rings:
        px = np.round((ring - lo) / 0.0625).astype(np.int32)
        assert np.array_equal(fill_poly(np.zeros(shape, np.uint8), px, 255),
                              _cv2_fill(shape, px))
    for ring, color in zip(sorted(rings, key=lambda r: -abs(_area(r))),
                           (255, 0)):
        px = np.round((ring - lo) / 0.0625).astype(np.int32)
        cv2.fillPoly(want, [px.reshape(-1, 1, 2)], color)
        fill_poly(got, px, color)
    assert np.array_equal(got, want)


def _area(poly):
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 8, 13, 21])
def test_track_geometry_equals_jax(seed):
    """Centerline, curvature, speed profile, raster and waypoints, exact."""
    c_j = J.generate_centerline(np.random.default_rng(seed))
    c_p = T.generate_centerline(np.random.default_rng(seed))
    assert np.array_equal(c_p, c_j)
    for a, b in zip(T._curvature(c_p), J._curvature(c_j)):
        assert np.array_equal(a, b)
    kappa = J._curvature(c_j)[1]
    assert np.array_equal(T.speed_profile(kappa), J.speed_profile(kappa))
    bm_p, res_p, org_p = T.rasterize_track(c_p, 3.2)
    bm_j, res_j, org_j = J.rasterize_track(c_j, 3.2)
    assert bm_p.dtype == bm_j.dtype and np.array_equal(bm_p, bm_j)
    assert (res_p, org_p) == (res_j, org_j)
    md_p, w_p = T.random_track_map_data(seed, dtype=torch.float64,
                                        device="cpu")
    _, w_j = J.random_track_map_data(seed, dtype=jnp.float64)
    assert np.array_equal(w_p, w_j)


def test_random_track_map_data_dt_equals_jax():
    for dtype, jdtype in ((torch.float64, jnp.float64),
                          (torch.float32, jnp.float32)):
        md_p, _ = T.random_track_map_data(7, dtype=dtype, device="cpu",
                                          track_width=2.8)
        md_j, _ = J.random_track_map_data(7, dtype=jdtype, track_width=2.8)
        want = np.asarray(md_j.dt)
        assert md_p.dt.numpy().dtype == want.dtype
        assert md_p.dt.numpy().tobytes() == want.tobytes()
        for f in ("orig_x", "orig_y", "resolution"):
            assert float(getattr(md_p, f)) == float(getattr(md_j, f))


def _read_track(d, name):
    png = np.array(Image.open(os.path.join(d, f"{name}.png")))
    with open(os.path.join(d, f"{name}.yaml")) as f:
        meta = yaml.safe_load(f)
    with open(os.path.join(d, f"{name}_centerline.csv"), "rb") as f:
        csv = f.read()
    return png, meta, csv


def test_save_track_equals_jax(tmp_path):
    """PNG pixels (read by Pillow), the yaml (read by PyYAML) and the csv
    bytes of the port's writers equal the JAX package's; the port's own
    readers read them back."""
    center = T.generate_centerline(np.random.default_rng(4), track_width=3.0)
    T.save_track(str(tmp_path / "p"), "t", center, 3.0)
    J.save_track(str(tmp_path / "j"), "t", center, 3.0)
    got, want = _read_track(tmp_path / "p", "t"), _read_track(tmp_path / "j",
                                                              "t")
    assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert got[2] == want[2]
    with open(tmp_path / "p" / "t.yaml") as f, \
            open(tmp_path / "j" / "t.yaml") as g:
        assert f.read() == g.read()   # yaml.safe_dump's layout too
    m = P.load_map(str(tmp_path / "p" / "t"), device="cpu")
    bm, _, _ = T.rasterize_track(center, 3.0)
    assert np.array_equal(image_io.read_png(str(tmp_path / "p" / "t.png")),
                          np.flipud(bm).astype(np.uint8))
    assert m.dt.shape == bm.shape


def _cli(module, out):
    return subprocess.run(
        [sys.executable, "-m", module, "--seed", "9", "--n-maps", "1",
         "--out-dir", str(out)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, cwd=ROOT)


def test_trackgen_cli_equals_jax(tmp_path):
    r = _cli("f1tenth_gym_tpu_torch.tracks.trackgen", tmp_path / "p")
    assert r.returncode == 0, r.stderr
    assert sorted(os.listdir(tmp_path / "p")) == [
        "map0.png", "map0.yaml", "map0_centerline.csv"]
    r = _cli("f1tenth_gym_tpu.tracks.trackgen", tmp_path / "j")
    assert r.returncode == 0, r.stderr
    got, want = _read_track(tmp_path / "p", "map0"), _read_track(
        tmp_path / "j", "map0")
    assert np.array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]


def test_random_track_env_steps():
    """tests/test_trackgen.py on the port: a random track in memory is
    drivable; the scans see walls; the centerline start is free."""
    m, wpts = T.random_track_map_data(seed=3, dtype=torch.float64,
                                      device="cpu")
    assert m.dt.dim() == 2 and wpts.shape[1] == 3
    params = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    tables = P.make_scan_tables(num_beams=108, dtype=torch.float64,
                                device="cpu")
    cfg = P.SimConfig(num_agents=1, num_beams=108, dtype="float64")
    d = wpts[1, :2] - wpts[0, :2]
    pose = torch.tensor([[[wpts[0, 0], wpts[0, 1],
                           float(np.arctan2(d[1], d[0]))]]], dtype=torch.float64)
    gen = P.make_generator("cpu", 0)
    s, o, r, done, info = P.batch_reset(pose, params, m, tables, cfg, 0.01,
                                        generator=gen, device="cpu")
    assert not bool(done[0])
    act = torch.tensor([[[0.0, 2.0]]], dtype=torch.float64)
    for _ in range(20):
        s, o, r, done, info = P.batch_step(s, act, params, m, tables, cfg,
                                           0.01, gen)
    scans = o["scans"].numpy()
    assert np.all(scans > 0) and scans.min() < 2.5
    assert float(s.collisions[0, 0]) == 0.0
    _, wpts2 = T.random_track_map_data(seed=4, dtype=torch.float64,
                                       device="cpu")
    assert not np.allclose(wpts[:, :2], wpts2[:, :2])


def test_write_png_gray_and_rgb(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((23, 41), (17, 9, 3), (5, 6, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / f"{len(shape)}_{shape[-1]}.png")
        image_io.write_png(path, img)
        assert np.array_equal(np.array(Image.open(path)), img)
        assert np.array_equal(image_io.read_png(path), img)
    with pytest.raises(TypeError, match="uint8"):
        image_io.write_png(path, np.zeros((3, 3)))


def test_write_map_yaml_is_safe_dump(tmp_path):
    meta = {"image": "map0.png", "resolution": 0.0625,
            "origin": [-14.5, 1e-05, 0.0], "negate": 0,
            "occupied_thresh": 0.45, "free_thresh": 0.196, "note": "1e3",
            "flag": "true", "hash": "a #b", "none": None, "big": 1e20,
            "empty": []}
    path = str(tmp_path / "m.yaml")
    image_io.write_map_yaml(path, meta)
    with open(path) as f:
        assert f.read() == yaml.safe_dump(meta)
    with open(path) as f:
        assert yaml.safe_load(f) == meta
    assert image_io.read_map_yaml(path) == meta
