"""PyTorch port: marching LiDAR, iTTC and the distance-field lookup.

The marching engine is exact against the reference: float64, the JAX
package's fixture tolerance rtol = atol = 1e-9 (tests/test_parity.py:
106-137); iTTC is a boolean and must match exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.maps import map_path
from f1tenth_gym_tpu.ops import lidar as jlidar
from f1tenth_gym_tpu_torch.ops import lidar as plidar

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables64():
    return P.make_scan_tables(dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name", ["example_map", "berlin"])
def test_march_scan_fixture(name, tables64):
    d = np.load(os.path.join(FIX, f"scans_{name}.npz"))
    m = P.load_map(map_path(name), dtype=torch.float64, device="cpu")
    got = plidar.get_scan(torch.as_tensor(d["poses"]), m, tables64, 1080, 2000)
    np.testing.assert_allclose(got.numpy(), d["scans"], rtol=1e-9, atol=1e-9)


def test_ttc_fixture(tables64):
    d = np.load(os.path.join(FIX, "ttc.npz"))
    hits = plidar.check_ttc(torch.as_tensor(d["scans"]),
                            torch.as_tensor(d["vels"]), tables64)
    np.testing.assert_array_equal(hits.numpy(), d["hits"])


def test_dt_lookup_out_of_bounds_wraps():
    """Out-of-map positions read dt[H-1, W-1] (lidar.py:21-23), and every
    lookup equals the JAX one."""
    jm = J.load_map(map_path("berlin"), ".png", dtype=jnp.float64)
    pm = P.load_map(map_path("berlin"), dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.uniform(-40.0, 40.0, 4000)
    y = rng.uniform(-50.0, 30.0, 4000)
    got = plidar.dt_lookup(torch.as_tensor(x), torch.as_tensor(y), pm).numpy()
    want = np.asarray(jlidar.dt_lookup(jnp.asarray(x), jnp.asarray(y), jm))
    np.testing.assert_array_equal(got, want)
    dt = pm.dt.numpy()
    far = plidar.dt_lookup(torch.tensor([-1e3, 1e3, -20.0], dtype=torch.float64),
                           torch.tensor([0.0, 0.0, -1e4], dtype=torch.float64), pm)
    np.testing.assert_array_equal(far.numpy(), dt[-1, -1])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_beam_theta_indices_match_jax(dtype):
    """LUT indices for headings across several turns of both signs: the
    remainder must take the divisor's sign, as jnp.mod does."""
    jt = J.make_scan_tables(num_beams=1080, dtype=jnp.dtype(dtype))
    pt = P.make_scan_tables(num_beams=1080, dtype=getattr(torch, dtype),
                            device="cpu")
    theta = np.random.default_rng(2).uniform(-20.0, 20.0, 64).astype(dtype)
    theta[:4] = [0.0, -np.pi, 2 * np.pi, -4.7]
    got = plidar.beam_theta_indices(torch.as_tensor(theta), pt, 1080, 2000)
    want = jlidar.beam_theta_indices(jnp.asarray(theta), jt, 1080, 2000)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_march_scan_matches_jax_f32():
    """f32 marching against the JAX engine on random poses: both engines
    take the same steps from the same raster; the ranges agree to f32
    round-off (median) with rare grazing-step divergences."""
    jm = J.load_map(map_path("compact"), ".png", dtype=jnp.float32)
    pm = P.load_map(map_path("compact"), device="cpu")
    jt = J.make_scan_tables(num_beams=256, dtype=jnp.float32)
    pt = P.make_scan_tables(num_beams=256, device="cpu")
    dt = pm.dt.numpy()
    res = float(pm.resolution)
    rng = np.random.default_rng(8)
    cells = np.argwhere(dt > 0.3)
    pick = cells[rng.integers(0, len(cells), 16)]
    poses = np.stack([pick[:, 1] * res + float(pm.orig_x),
                      pick[:, 0] * res + float(pm.orig_y),
                      rng.uniform(0, 2 * np.pi, 16)], 1).astype(np.float32)
    got = plidar.get_scan(torch.as_tensor(poses), pm, pt, 256, 2000).numpy()
    want = np.asarray(jlidar.get_scan(jnp.asarray(poses), jm, jt, 256, 2000))
    err = np.abs(got - want)
    assert np.median(err) < 1e-5 and np.mean(err < 1e-3) > 0.99
