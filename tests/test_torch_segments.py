"""PyTorch port: the "segments" scan engine and the engine names.

``get_scan_segments`` is held to the JAX package's on the same segments and
poses. In float64 both compute the same expressions; XLA may contract a
multiply-add, which moves a range by ~1e-15 m, so 1e-9 m holds. In float32
a beam that grazes a segment end can take the neighbouring segment on one
side and not the other, so the bar is the kernel tests' (median < 1e-5 m,
p99.9 < 1e-3 m). The reference's own cross-engine bar, MSE < 2.0 against
the golden marching scans, holds on berlin and skirk
(tests/test_parity.py:116-141).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.ops.segments import get_scan_segments as j_segments
from f1tenth_gym_tpu.tracks.synthetic import ring_map_data as j_ring
from f1tenth_gym_tpu.tracks.synthetic import ring_start_poses
from f1tenth_gym_tpu_torch.maps import map_path
from f1tenth_gym_tpu_torch.ops.segments import get_scan_segments
from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data as p_ring

NB, TD = 108, 2000
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ring_poses(n, seed):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    r = 4.0 + rng.uniform(-1.0, 1.0, n)
    return np.stack([r * np.cos(ang), r * np.sin(ang),
                     rng.uniform(-7.0, 7.0, n)], -1)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_matches_jax_on_ring(dtype):
    jm = j_ring(size=256, radius=4.0, dtype=getattr(jnp, dtype),
                extract_segments=True)
    jt = J.make_scan_tables(num_beams=NB, dtype=getattr(jnp, dtype))
    pt = P.make_scan_tables(num_beams=NB, dtype=getattr(torch, dtype),
                            device="cpu")
    poses = _ring_poses(24, 0).astype(dtype)
    segs = np.array(jm.segments)
    want = np.asarray(j_segments(jnp.asarray(poses), jm.segments, jt, NB, TD))
    got = get_scan_segments(torch.as_tensor(poses), torch.as_tensor(segs), pt,
                            NB, TD).numpy()
    assert got.dtype == want.dtype
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    else:
        err = np.abs(got - want)
        assert np.median(err) < 1e-5 and np.percentile(err, 99.9) < 1e-3
    # the port's own ring carries the same segments
    pm = p_ring(size=256, radius=4.0, dtype=getattr(torch, dtype),
                extract_segments=True, device="cpu")
    np.testing.assert_array_equal(pm.segments.numpy(), segs)


@pytest.mark.parametrize("name", ["berlin", "skirk"])
def test_reference_fixtures_mse(name):
    d = np.load(os.path.join(FIX, f"scans_{name}.npz"))
    m = P.load_map(map_path(name), dtype=torch.float64, extract_segments=True,
                   device="cpu")
    tables = P.make_scan_tables(dtype=torch.float64, device="cpu")
    got = get_scan_segments(torch.as_tensor(d["poses"]), m.segments, tables,
                            1080, TD).numpy()
    assert np.mean((got - d["scans"]) ** 2) < 2.0


def test_env_step_matches_jax():
    """Reset and three steps of one 2-agent env with the segments engine,
    float64, no noise, against JAX env_reset/env_step."""
    jm = j_ring(size=256, radius=4.0, dtype=jnp.float64, extract_segments=True)
    pm = p_ring(size=256, radius=4.0, dtype=torch.float64,
                extract_segments=True, device="cpu")
    jt = J.make_scan_tables(num_beams=NB, dtype=jnp.float64)
    pt = P.make_scan_tables(num_beams=NB, dtype=torch.float64, device="cpu")
    jp = J.VehicleParams.create(dtype=jnp.float64)
    pp = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    kw = dict(num_agents=2, num_beams=NB, scan_engine="segments",
              scan_noise=False, dtype="float64")
    jcfg, pcfg = J.SimConfig(**kw), P.SimConfig(**kw)
    poses = ring_start_poses(2, 4.0)
    js, jobs, *_ = J.env_reset(jnp.asarray(poses), jax.random.PRNGKey(0), jp,
                               jm, jt, jcfg, 0.01)
    ps, pobs, *_ = P.env_reset(torch.as_tensor(poses)[None], pp, pm, pt, pcfg,
                               0.01)
    act = np.array([[0.1, 2.0], [-0.1, 3.0]])
    for t in range(4):
        for k in ("scans", "poses_x", "poses_y", "poses_theta",
                  "linear_vels_x", "collisions"):
            np.testing.assert_allclose(pobs[k][0].numpy(), np.asarray(jobs[k]),
                                       rtol=0, atol=1e-9, err_msg=f"{t} {k}")
        js, jobs, *_ = J.env_step(js, jnp.asarray(act), jp, jm, jt, jcfg, 0.01)
        ps, pobs, *_ = P.env_step(ps, torch.as_tensor(act)[None], pp, pm, pt,
                                  pcfg, 0.01)
    assert float(pobs["scans"].min()) < 1.6  # walls of the 3 m ring


def test_segments_engine_needs_segments():
    m = p_ring(size=128, radius=2.0, device="cpu")
    cfg = P.SimConfig(num_agents=1, num_beams=16, scan_engine="segments",
                      scan_noise=False)
    with pytest.raises(ValueError, match="extract_segments=True"):
        P.env_reset(torch.tensor([[[2.0, 0.0, 1.57]]]),
                    P.VehicleParams.create(device="cpu"), m,
                    P.make_scan_tables(num_beams=16, device="cpu"), cfg, 0.01)


def test_pallas_name_is_the_kernel_engine():
    """"pallas", the JAX package's name for the kernel engine, runs the
    kernel engine: a step with it equals a "kernel" step."""
    assert P.SimConfig(scan_engine="pallas") == P.SimConfig(scan_engine="kernel")
    with pytest.raises(ValueError, match="unknown scan engine"):
        P.SimConfig(scan_engine="mosaic")
    m = p_ring(size=256, radius=4.0, extract_segments=True, device="cpu")
    tables = P.make_scan_tables(num_beams=NB, device="cpu")
    params = P.VehicleParams.create(device="cpu")
    poses = torch.as_tensor(np.stack([ring_start_poses(2, 4.0)] * 3),
                            dtype=torch.float32)
    act = torch.tensor([[0.2, 3.0], [0.0, 2.0]]).expand(3, 2, 2)
    out = {}
    for engine in ("pallas", "kernel"):
        cfg = P.SimConfig(num_agents=2, num_beams=NB, scan_engine=engine)
        gen = P.make_generator("cpu", 5)
        s, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                              generator=gen, device="cpu")
        s, obs, *_ = P.batch_step(s, act, params, m, tables, cfg, 0.01, gen)
        out[engine] = obs["scans"]
    assert torch.equal(out["pallas"], out["kernel"])
