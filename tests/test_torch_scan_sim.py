"""PyTorch port: the standalone ScanSimulator2D (scan_sim.py).

Mirrors tests/test_components.py:66-97 and holds the marching engine to
the JAX package's ScanSimulator2D in float64 (the same control flow in
the same precision: 1e-9 m, the parity tests' bar).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.maps import map_path
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

POSES = np.array([[0.0, 0.0, 0.3], [1.0, -1.0, 2.0], [-2.0, 3.0, 4.4]])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sim(engine, **kw):
    sim = P.ScanSimulator2D(num_beams=108, engine=engine, device="cpu", **kw)
    assert sim.set_map(map_path("example_map"), ".png")
    return sim


def test_scan_simulator_2d_api():
    sim = _sim("march", dtype=torch.float64)
    pose = np.array([0.0, 0.0, 0.0])
    s0 = sim.scan(pose)
    assert isinstance(s0, np.ndarray) and s0.shape == (108,)
    assert (s0 > 0).all() and (s0 <= 30.0 + 1e-6).all()
    assert abs(sim.get_increment() - 4.7 / 107) < 1e-12
    # noise: same seed -> identical, different draws -> different
    a = sim.scan(pose, np.random.default_rng(42))
    b = sim.scan(pose, np.random.default_rng(42))
    np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(42)
    c, d = sim.scan(pose, rng), sim.scan(pose, rng)
    assert not np.array_equal(c, d)
    # the reference's noise: the NumPy draw added to the clean scan
    np.testing.assert_array_equal(
        a, s0 + np.random.default_rng(42).normal(0.0, 0.01, size=108))
    # batched path agrees with single path
    batch = sim.scan_batch(np.stack([pose, pose + 0.1])).numpy()
    np.testing.assert_allclose(batch[0], s0, atol=1e-9)


def test_scan_batch_device_noise():
    sim = _sim("march")
    clean = sim.scan_batch(POSES)
    a = sim.scan_batch(POSES, P.make_generator("cpu", 3))
    b = sim.scan_batch(POSES, P.make_generator("cpu", 3))
    assert torch.equal(a, b) and not torch.equal(a, clean)
    noise = (a - clean).numpy()
    assert abs(noise.std() / 0.01 - 1.0) < 0.1 and np.abs(noise).max() < 0.06


def test_scan_simulator_engines_agree():
    a = _sim("march", dtype=torch.float64).scan_batch(POSES).numpy()
    b = _sim("segments", dtype=torch.float64).scan_batch(POSES).numpy()
    err = np.abs(a - b)
    # polygon-vs-raster tolerance, far inside the reference's own
    # MSE < 2.0 cross-engine bar (unittest/scan_sim.py:342)
    assert np.mean(err ** 2) < 0.5
    assert np.median(err) < 0.1


def test_march_matches_jax_scan_simulator():
    ours = _sim("march", dtype=torch.float64)
    ref = J.ScanSimulator2D(num_beams=108, engine="march", dtype=jnp.float64)
    ref.set_map(map_path("example_map"), ".png")
    np.testing.assert_allclose(ours.scan_batch(POSES).numpy(),
                               np.asarray(ref.scan_batch(POSES)),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(ours.scan(POSES[1]), ref.scan(POSES[1]),
                               rtol=0, atol=1e-9)


def test_kernel_engine_with_culling_is_the_kernel_scan():
    """engine="pallas" (taken as "kernel") with tile_culling loads the
    culled pack, and scan_batch is ops.scan_kernel.scan bit for bit."""
    sim = P.ScanSimulator2D(num_beams=108, engine="pallas", tile_culling=True,
                            device="cpu")
    assert sim.engine == "kernel"
    assert sim.set_map(map_path("compact"))
    m = sim.map_data
    assert m.tile_tables is not None and m.cull_eligible is not None
    rng = np.random.default_rng(0)
    free = np.argwhere(m.dt.numpy() > 0.3)
    cells = free[rng.integers(0, len(free), 24)]
    poses = np.stack([cells[:, 1] * float(m.resolution) + float(m.orig_x),
                      cells[:, 0] * float(m.resolution) + float(m.orig_y),
                      rng.uniform(0, 2 * np.pi, 24)], -1).astype(np.float32)
    want = sk.scan(torch.as_tensor(poses), m, sim.tables, 108, 2000,
                   device="cpu")
    got = sim.scan_batch(poses)
    assert torch.equal(got, want)
    march = _sim("march").scan_batch(poses[:4])
    assert march.shape == (4, 108)


def test_engine_and_map_checks():
    with pytest.raises(ValueError, match="unknown scan engine"):
        P.ScanSimulator2D(engine="mosaic", device="cpu")
    with pytest.raises(ValueError, match="needs an engine"):
        P.ScanSimulator2D(engine="auto", device="cpu")
    sim = P.ScanSimulator2D(num_beams=16, engine="segments", device="cpu")
    with pytest.raises(RuntimeError, match="set_map"):
        sim.scan(np.zeros(3))
    with pytest.raises(ValueError, match="extract_segments"):
        sim.set_map_data(P.load_map(map_path("compact"), device="cpu"))
