"""PyTorch port: body vertices, SAT collision, opponent ray cast.

Fixture tolerances are the JAX package's (tests/test_parity.py:86-161):
booleans and partner indices exact, vertices 1e-12, ray-cast ranges
rtol 1e-9, all in float64.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.ops import collision as jcol
from f1tenth_gym_tpu_torch.ops import collision as pcol

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fix(name):
    return np.load(os.path.join(FIX, name))


def test_collision_pairwise_fixture():
    d = _fix("collision.npz")
    got = pcol.collision_pairwise(torch.as_tensor(d["pairs_a"]),
                                  torch.as_tensor(d["pairs_b"]))
    np.testing.assert_array_equal(got.numpy(), d["res"])


def test_collision_multiple_fixture():
    d = _fix("collision.npz")
    cols, idx = pcol.collision_multiple(torch.as_tensor(d["multi"]))
    np.testing.assert_array_equal(cols.numpy(), d["mcol"])
    np.testing.assert_array_equal(idx.numpy(), d["midx"])


def test_get_vertices_fixture():
    d = _fix("collision.npz")
    verts = pcol.get_vertices(torch.as_tensor(d["poses"]), 0.58, 0.31)
    np.testing.assert_allclose(verts.numpy(), d["verts"], rtol=1e-12,
                               atol=1e-12)


def test_ray_cast_fixture():
    d = _fix("ray_cast.npz")
    tables = P.make_scan_tables(dtype=torch.float64, device="cpu")
    new = pcol.ray_cast_opponents(torch.as_tensor(d["poses"]),
                                  torch.as_tensor(d["scans"]),
                                  torch.as_tensor(d["opp_verts"])[:, None],
                                  tables)
    np.testing.assert_allclose(new.numpy(), d["new_scans"], rtol=1e-9,
                               atol=1e-12)


def test_random_collision_property():
    """Mirror of test_components.py::test_random_collision_property."""
    rng = np.random.default_rng(0)
    length, width = 0.32, 0.22
    base = rng.uniform(-5, 5, size=(1000, 3))
    j1 = base + rng.uniform(-0.05, 0.05, size=(1000, 3))
    j2 = base + rng.uniform(-0.05, 0.05, size=(1000, 3))
    v1 = pcol.get_vertices(torch.as_tensor(j1), length, width)
    v2 = pcol.get_vertices(torch.as_tensor(j2), length, width)
    hits = pcol.collision_pairwise(v1, v2)
    assert bool(hits.all()), f"{int((~hits).sum())} overlapping pairs missed"
    far = base.copy()
    far[:, 0] += 2.0
    v3 = pcol.get_vertices(torch.as_tensor(far), length, width)
    miss = pcol.collision_pairwise(v1, v3)
    assert not bool(miss.any()), f"{int(miss.sum())} separated pairs hit"


def test_collision_multiple_matches_jax_batched():
    """(E, A=4) random bodies: flags and the overwrite-order partner index
    of the batched port equal the vmapped JAX function."""
    rng = np.random.default_rng(5)
    poses = np.concatenate([rng.uniform(-1.0, 1.0, (64, 4, 2)),
                            rng.uniform(0, 2 * np.pi, (64, 4, 1))], -1)
    pv = pcol.get_vertices(torch.as_tensor(poses), 0.58, 0.31)
    cols, idx = pcol.collision_multiple(pv)
    jv = jcol.get_vertices(jnp.asarray(poses), 0.58, 0.31)
    jcols, jidx = jax.vmap(jcol.collision_multiple)(jv)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert 0 < cols.numpy().mean() < 1


def test_ray_cast_matches_jax_batched():
    """(E, A, O) opponents around (E, A) scanners, f64: the batched port
    against the vmapped JAX pass, rtol 1e-9 as the fixture test."""
    rng = np.random.default_rng(7)
    E, A, O, B = 6, 3, 2, 256
    poses = np.concatenate([rng.uniform(-3, 3, (E, A, 2)),
                            rng.uniform(0, 2 * np.pi, (E, A, 1))], -1)
    ang = rng.uniform(0, 2 * np.pi, (E, A, O))
    dist = rng.uniform(0.5, 8.0, (E, A, O))
    opp = np.stack([poses[..., None, 0] + dist * np.cos(ang),
                    poses[..., None, 1] + dist * np.sin(ang),
                    rng.uniform(0, 2 * np.pi, (E, A, O))], -1)
    scans = rng.uniform(2.0, 30.0, (E, A, B))
    jt = J.make_scan_tables(num_beams=B, dtype=jnp.float64)
    pt = P.make_scan_tables(num_beams=B, dtype=torch.float64, device="cpu")
    jverts = jcol.get_vertices(jnp.asarray(opp), 0.58, 0.31)
    want = jax.vmap(jax.vmap(
        lambda p, sc, ov: jcol.ray_cast_opponents(p, sc, ov, jt)))(
        jnp.asarray(poses), jnp.asarray(scans), jverts)
    pverts = pcol.get_vertices(torch.as_tensor(opp), 0.58, 0.31)
    got = pcol.ray_cast_opponents(torch.as_tensor(poses),
                                  torch.as_tensor(scans), pverts, pt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-12)
    assert (got.numpy() < scans - 1e-6).sum() > 20   # the pass fires
