"""PyTorch port: the culled LiDAR sweep (ops/scan_kernel.py) on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py holds it to the plain
version there, bit for bit); here the plain version, which is what a CPU
tensor runs, is held to the JAX Pallas kernel in interpret mode and to
itself across culled and full tables.

Tolerance against JAX: median |delta| < 1e-5 m and p99.9 < 1e-3 m. Both
compute the same f32 formulas in the same order, but XLA on the CPU may
contract multiply-adds into FMAs, so a beam grazing two segments can pick
the other one. Culled against full in the port: bit for bit, because the
culled tables provably never drop the winning segment.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.core.simulator import _elig_kwargs
from f1tenth_gym_tpu.maps import map_path
from f1tenth_gym_tpu.ops.pallas_scan import scan_pallas
from f1tenth_gym_tpu.ops.pallas_scan import select_windows as j_select
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
from test_torch_scan_skip import assert_sound, rows_read_loop

NB, TD = 256, 2000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def compact():
    """Erosion-gated union pack (the production layout) at 2.0 m tiles."""
    return P.load_map(map_path("compact"), extract_segments=True,
                      tile_culling=True, culling_tile_size=2.0, device="cpu")


@pytest.fixture(scope="module")
def compact_split():
    """Split-block pack (split cap 96): runs the per-scan extras path."""
    return P.load_map(map_path("compact"), extract_segments=True,
                      tile_culling=True, culling_tile_size=2.0,
                      culling_split_cap=96, device="cpu")


def _assert_close_to_jax(got, want):
    err = np.abs(got - want)
    assert np.median(err) < 1e-5, np.median(err)
    assert np.percentile(err, 99.9) < 1e-3, np.percentile(err, 99.9)


def _free_poses(m, n, rng, cond):
    dt = m.dt.numpy()
    res = float(m.resolution)
    cells = np.argwhere(cond(dt))
    pick = cells[rng.integers(0, len(cells), n)]
    return np.stack([pick[:, 1] * res + float(m.orig_x),
                     pick[:, 0] * res + float(m.orig_y),
                     rng.uniform(0, 2 * np.pi, n)], 1).astype(np.float32)


def _clustered(m, n_groups, rng, spread_m=0.5):
    """Groups of 8 scans within spread_m of an eligible corridor cell."""
    dt = m.dt.numpy()
    elig = m.cull_eligible.numpy()
    res = float(m.resolution)
    cells = np.argwhere((dt > 0.3) & (elig > 0))
    out = []
    for _ in range(n_groups):
        ctr = cells[rng.integers(0, len(cells))]
        for _ in range(sk.SUB):
            cc = ctr + rng.uniform(-spread_m / res, spread_m / res, 2)
            out.append([cc[1] * res + float(m.orig_x),
                        cc[0] * res + float(m.orig_y),
                        rng.uniform(0, 2 * np.pi)])
    return np.asarray(out, np.float32)


def _scan(m, poses, tables, culled=True):
    return sk.scan(torch.as_tensor(poses), m, tables, NB, TD, culled=culled,
                   device="cpu").numpy()


def test_plain_matches_jax_kernel_ring():
    from f1tenth_gym_tpu.tracks.synthetic import ring_map_data as j_ring
    from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data as p_ring

    jm = j_ring(size=256, radius=4.0, dtype=jnp.float32, extract_segments=True)
    pm = p_ring(size=256, radius=4.0, extract_segments=True, device="cpu")
    jt = J.make_scan_tables(num_beams=NB, dtype=jnp.float32)
    pt = P.make_scan_tables(num_beams=NB, device="cpu")
    rng = np.random.default_rng(0)
    ang = rng.uniform(0, 2 * np.pi, 24)
    r = 4.0 + rng.uniform(-1.0, 1.0, 24)
    poses = np.stack([r * np.cos(ang), r * np.sin(ang),
                      rng.uniform(-7.0, 7.0, 24)], -1).astype(np.float32)
    want = np.asarray(scan_pallas(jnp.asarray(poses), jm.seg_table, jt, NB,
                                  TD, interpret=True))
    _assert_close_to_jax(_scan(pm, poses, pt), want)


def test_plain_matches_jax_kernel_culled_compact(compact):
    jm = J.load_map(map_path("compact"), ".png", extract_segments=True,
                    tile_culling=True, culling_tile_size=2.0)
    jt = J.make_scan_tables(num_beams=NB, dtype=jnp.float32)
    pt = P.make_scan_tables(num_beams=NB, device="cpu")
    rng = np.random.default_rng(1)
    poses = np.concatenate([_clustered(compact, 3, rng),
                            _free_poses(compact, 8, rng, lambda d: d > 0.05)])
    want = np.asarray(scan_pallas(
        jnp.asarray(poses), jm.seg_table, jt, NB, TD, interpret=True,
        tile_tables=jm.tile_tables, tile_ngroups=jm.tile_ngroups,
        tile_meta=jm.tile_meta, tile_blockmap=jm.tile_blockmap,
        tile_ext=jm.tile_ext, **_elig_kwargs(jm)))
    w = sk.prepare_map(torch.as_tensor(poses), compact, pt, NB, TD)
    assert int((w.bid > 0).sum()) >= 2   # culled windows were selected
    _assert_close_to_jax(_scan(compact, poses, pt), want)


def _pose_family(name, m, rng):
    dt = m.dt.numpy()
    elig = m.cull_eligible.numpy()
    if name == "clustered":
        return _clustered(m, 6, rng)
    if name == "near_wall":     # ineligible: near-wall band, other components
        return _free_poses(m, 16, rng, lambda d: (d > 0.05) & (elig == 0))
    if name == "tiers":         # spreads that pick the 1x1, 2x2, 4x4 tiers
        return np.concatenate([_clustered(m, 2, rng, s)
                               for s in (0.1, 0.8, 2.5)])
    # mixed: anywhere free, a few far off the tile grid
    p = _free_poses(m, 32, rng, lambda d: d > 0.05)
    p[::7, :2] += 50.0
    return p


@pytest.mark.parametrize("family", ["clustered", "near_wall", "tiers", "mixed"])
def test_culled_equals_full_bitwise(compact, family):
    tables = P.make_scan_tables(num_beams=NB, device="cpu")
    poses = _pose_family(family, compact, np.random.default_rng(11))
    w = sk.prepare_map(torch.as_tensor(poses), compact, tables, NB, TD)
    if family in ("clustered", "tiers"):
        assert int((w.bid > 0).sum()) >= 2
    full = _scan(compact, poses, tables, culled=False)
    cull = _scan(compact, poses, tables)
    assert np.array_equal(full, cull)


def test_split_pack_extras_bitwise(compact_split):
    m = compact_split
    assert m.tile_ext is not None
    tables = P.make_scan_tables(num_beams=NB, device="cpu")
    rng = np.random.default_rng(12)
    poses = np.concatenate([_clustered(m, 6, rng, 1.5),
                            _pose_family("mixed", m, rng)])
    w = sk.prepare_map(torch.as_tensor(poses), m, tables, NB, TD)
    assert w.has_extras and int(w.ecnt.sum()) > 0   # extras were swept
    assert np.array_equal(_scan(m, poses, tables, culled=False),
                          _scan(m, poses, tables))


def test_split_pack_vertex_leak(compact_split):
    """Where culled and full may differ: one subgroup of bench-sampler
    poses on the split pack, whose beam 566 of scan 7 runs through the
    shared vertex of two walls 5.03 m out and fails both f32 hit tests
    (b < 0 on one segment, b > s on the other). The full sweep then hits a
    wall 17.09 m out that the culled table rightly left out, and the
    culled sweep one further still. Both overshoot the march (4.93 m): the
    culled table dropped no visible wall. Exact comparisons: the values
    are the f32 results of the kernel's formulation."""
    from f1tenth_gym_tpu_torch.ops import lidar as lidar_ops

    m = compact_split
    tables = P.make_scan_tables(num_beams=1080, device="cpu")
    poses = torch.tensor(LEAK_POSES, dtype=torch.float32)
    full = sk.scan(poses, m, tables, 1080, TD, culled=False, device="cpu")
    cull = sk.scan(poses, m, tables, 1080, TD, device="cpu")
    diff = (full != cull).nonzero().tolist()
    assert diff == [[7, 566]]
    march = lidar_ops.get_scan(poses[7:8], m, tables, 1080, TD)[0, 566]
    assert float(march) < 5.0 < float(full[7, 566]) - 12.0
    assert float(cull[7, 566]) > float(full[7, 566])


LEAK_POSES = [
    [1.215126, 12.3654785, 4.0489645], [2.1146092, 12.334983, 4.0489645],
    [0.52762604, 12.5529785, 3.7279782], [1.3700552, 12.236256, 3.7279782],
    [0.59012604, 11.3654785, 3.8178763], [1.293091, 11.927475, 3.8178763],
    [0.84012604, 11.6154785, 3.6344597], [1.5654424, 12.148316, 3.6344597],
]


def test_skip_sound_split_pack(compact_split):
    """The CUDA kernel's row skip (tests/test_torch_scan_skip.py) on the
    split pack at 1080 beams: clustered subgroups whose scans sweep their
    extras, and the subgroup of test_split_pack_vertex_leak."""
    m = compact_split
    tables = P.make_scan_tables(num_beams=1080, device="cpu")
    poses = np.concatenate([_clustered(m, 4, np.random.default_rng(21), 1.5),
                            np.asarray(LEAK_POSES, np.float32)])
    for culled in (True, False):
        w = sk.prepare_map(torch.as_tensor(poses), m, tables, 1080, TD,
                           culled=culled)
        if culled:
            assert int(w.ecnt.sum()) > 0
        assert_sound(w)


def test_rows_read_split_pack(compact_split):
    """``rows_read`` on the split pack: shared rows and extras, each
    (table, row) once."""
    m = compact_split
    tables = P.make_scan_tables(num_beams=NB, device="cpu")
    poses = np.concatenate([_clustered(m, 4, np.random.default_rng(21), 1.5),
                            np.asarray(LEAK_POSES, np.float32)])
    w = sk.prepare_map(torch.as_tensor(poses), m, tables, NB, TD)
    assert int(w.ecnt.sum()) > 0
    assert sk.rows_read(w) == rows_read_loop(w)


def test_skip_sound_berlin_full():
    m = P.load_map(map_path("berlin"), extract_segments=True, device="cpu")
    tables = P.make_scan_tables(num_beams=1080, device="cpu")
    poses = P.uniform_pose_sampler(m, clearance=0.3)(
        P.make_generator("cpu", 3), (48,))
    w = sk.prepare_map(poses, m, tables, 1080, TD, culled=False)
    assert int((w.bid > 0).sum()) == 0
    assert_sound(w)


def test_select_windows_matches_jax(compact_split):
    m = compact_split
    rng = np.random.default_rng(13)
    nx, ny = int(m.tile_meta_host[3]), int(m.tile_meta_host[4])
    base = np.stack([rng.integers(-1, nx + 1, 200),
                     rng.integers(-1, ny + 1, 200)], -1)
    spread = rng.integers(0, 9, (200, 1, 1))
    tij = base[:, None, :] + rng.integers(0, 9, (200, 8, 2)) % (spread + 1)
    ti, tj = tij[..., 0], tij[..., 1]
    got = sk.select_windows(torch.as_tensor(ti), torch.as_tensor(tj),
                            m.tile_blockmap, m.tile_ngroups, m.tile_ext,
                            nx, ny, m.seg_table.shape[0] // sk.GROUP)
    want = j_select(ti, tj, m.tile_blockmap.numpy(), m.tile_ngroups.numpy(),
                    m.tile_ext.numpy(), nx, ny,
                    m.seg_table.shape[0] // sk.GROUP)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    assert (got[0] > 0).any() and (got[0] == 0).any()


def test_batch_shapes_and_padding(compact):
    tables = P.make_scan_tables(num_beams=NB, device="cpu")
    poses = _pose_family("clustered", compact, np.random.default_rng(3))[:10]
    flat = _scan(compact, poses, tables)
    assert flat.shape == (10, NB)
    shaped = _scan(compact, poses.reshape(5, 2, 3), tables)
    assert shaped.shape == (5, 2, NB)
    np.testing.assert_array_equal(flat.reshape(5, 2, NB), shaped)
    one = _scan(compact, poses[3], tables)
    np.testing.assert_array_equal(one, flat[3])
    w = sk.prepare_map(torch.as_tensor(poses), compact, tables, NB, TD)
    assert w.scal.shape[0] == 16 and w.bid.shape[0] == 2


def test_erosion_guard_raises(compact):
    assert compact.tile_meta_host[5] >= 8
    with pytest.raises(ValueError, match="eligibility"):
        dataclasses.replace(compact, cull_eligible=None)


def test_launches_stay_zero_on_cpu(compact):
    tables = P.make_scan_tables(num_beams=NB, device="cpu")
    before = sk.sweep.launches
    _scan(compact, _pose_family("mixed", compact, np.random.default_rng(4)),
          tables)
    assert sk.sweep.launches == before


@pytest.mark.parametrize("name", ["berlin", "skirk"])
def test_kernel_scan_against_reference_fixtures(name):
    """The reference's own cross-engine bar (unittest/scan_sim.py:342):
    MSE < 2.0 against the golden marching scans, 1080 beams."""
    import os

    d = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "fixtures", f"scans_{name}.npz"))
    m = P.load_map(map_path(name), extract_segments=True, device="cpu")
    tables = P.make_scan_tables(device="cpu")
    got = sk.scan(torch.as_tensor(d["poses"]), m, tables, 1080, TD,
                  device="cpu").numpy()
    assert np.mean((got - d["scans"]) ** 2) < 2.0
