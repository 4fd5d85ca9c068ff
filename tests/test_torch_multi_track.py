"""PyTorch port: multi-track worlds (tracks/multi.py).

The 4-track world of seed 11 against the JAX package's: the raster, the
distance transform, the segments, the kernel table, the pack's grid and
the track infos (each package's world is built once for the module). The
culling pack itself parts from the JAX package's on purpose: the port
certifies each track's corridor with its own erosion certificate
(ops/culling.py::erosion_refine, one seed a track), so scans on a track
take their windows; the tests here hold every culled scan to the full
table's bit for bit. Then tests/test_multi_track.py on the port (composed
scans equal standalone ones, the sampler spawns on its track, culling
stays local), the sampler on JAX's own draws and the arc sort's order
against the JAX sort's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.tracks import multi as JM
from f1tenth_gym_tpu_torch.ops.lidar import dt_lookup, get_scan
from f1tenth_gym_tpu_torch.tracks import multi as PM
from f1tenth_gym_tpu_torch.tracks.trackgen import random_track_map_data

N_TRACKS = 4
SEED = 11


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def culled_worlds():
    """(JAX world, port world), float32, each with its culling pack."""
    j = JM.multi_track_map_data(N_TRACKS, seed=SEED, dtype=jnp.float32)
    p = PM.multi_track_map_data(N_TRACKS, seed=SEED, device="cpu")
    return j, p


@pytest.fixture(scope="module")
def world64():
    """The port's world in float64 without culling (the march's)."""
    return PM.multi_track_map_data(N_TRACKS, seed=SEED, tile_culling=False,
                                   dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("field", ["dt", "segments", "seg_table",
                                   "tile_meta"])
def test_world_equals_jax(culled_worlds, field):
    (jm, _), (pm, _) = culled_worlds
    want = np.asarray(getattr(jm, field))
    got = getattr(pm, field).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_world_scalars_and_infos_equal_jax(culled_worlds):
    (jm, ji), (pm, pi) = culled_worlds
    assert jm.tile_ext is None and pm.tile_ext is None   # no split blocks
    assert pm.tile_meta_host == tuple(float(v) for v in np.asarray(jm.tile_meta))
    for f in ("orig_x", "orig_y", "orig_c", "orig_s", "resolution"):
        assert float(getattr(pm, f)) == float(getattr(jm, f))
    assert len(pi) == len(ji) == N_TRACKS
    for a, b in zip(pi, ji):
        assert a.index == b.index and a.bbox == b.bbox
        assert np.array_equal(a.waypoints, b.waypoints)
        assert np.array_equal(a.start_pose, b.start_pose)


def _track_cells(md, info):
    """Row and column slices of a track's bounding box in the raster."""
    res = float(md.resolution)
    x0, y0, x1, y1 = info.bbox
    return (slice(int(round(y0 / res)), int(round(y1 / res))),
            slice(int(round(x0 / res)), int(round(x1 / res))))


def _sorted_scan_poses(md, infos, envs, seed):
    """(envs * 2, 3) scan poses of the sampler's start grids after the arc
    sort, float32."""
    poses = PM.multi_track_pose_sampler(infos, device="cpu")(
        P.make_generator("cpu", seed), (envs, 2))
    states = PM.multi_track_locality_sort(md, infos)(
        P.init_state(poses, P.SimConfig(num_agents=2)))
    return torch.stack([states.x[..., 0], states.x[..., 1],
                        states.x[..., 4]], -1).reshape(-1, 3)


def test_eligibility_covers_every_corridor(culled_worlds):
    """The gate certifies each track's corridor (one seed a track): every
    corridor holds eligible cells, nearly every free cell of a track that
    lies 2.5 cells or more from a wall is eligible, the open space around
    the tracks is not, and the sampler's subgroups take culled windows."""
    _, (pm, infos) = culled_worlds
    el = pm.cull_eligible.numpy() > 0
    dt = pm.dt.numpy()
    res = float(pm.resolution)
    inside = np.zeros_like(el)
    for info in infos:
        rows, cols = _track_cells(pm, info)
        inside[rows, cols] = True
        clear = dt[rows, cols] >= 2.5 * res + 0.1
        assert el[rows, cols][clear].mean() > 0.95, info.index
    assert not el[~inside].any()
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    tables = P.make_scan_tables(num_beams=108, device="cpu")
    w = sk.prepare_map(_sorted_scan_poses(pm, infos, 256, 0), pm, tables,
                       108, 2000)
    assert float((w.bid > 0).float().mean()) > 0.9
    assert float(w.swept_rows().float().mean()) < pm.seg_table.shape[0] / 2


def _eligible_poses(md, rows, cols, n, rng):
    """n float32 poses with random headings in the eligible cells of the
    raster window (rows, cols): half in cells next to the eligibility
    margin, a quarter anywhere, a quarter on the corners of the tiles'
    subcells (each pack tile's 3 x 3 proof cells) where one falls in its
    cell."""
    from scipy import ndimage

    el = np.zeros(md.cull_eligible.shape, bool)
    el[rows, cols] = md.cull_eligible.numpy()[rows, cols] > 0
    margin = np.argwhere(el & ~ndimage.binary_erosion(el))
    every = np.argwhere(el)
    res = float(md.resolution)
    ox, oy = float(md.orig_x), float(md.orig_y)
    tm = md.tile_meta_host
    sub = 1.0 / tm[2] / 3.0

    def draw(cells, k, corner):
        c = cells[rng.integers(0, len(cells), k)]
        x = ox + (c[:, 1] + rng.uniform(0, 1, k)) * res
        y = oy + (c[:, 0] + rng.uniform(0, 1, k)) * res
        if corner:
            xs = tm[0] + np.round((x - tm[0]) / sub) * sub
            ys = tm[1] + np.round((y - tm[1]) / sub) * sub
            ok = ((np.floor((xs - ox) / res) == c[:, 1])
                  & (np.floor((ys - oy) / res) == c[:, 0]))
            x, y = np.where(ok, xs, x), np.where(ok, ys, y)
        return np.stack([x, y, rng.uniform(-np.pi, np.pi, k)], -1)

    return torch.as_tensor(np.concatenate([
        draw(margin, n // 2, False), draw(every, n // 4, False),
        draw(every, n - n // 2 - n // 4, True)]), dtype=torch.float32)


def _culled_and_full(md, poses, num_beams, sub):
    """(culled, full, selection) plain sweeps of ``poses`` on ``md``."""
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    tables = P.make_scan_tables(num_beams=num_beams, device="cpu")
    w = sk.prepare_map(poses, md, tables, num_beams, 2000, sub=sub)
    wf = sk.prepare_map(poses, md, tables, num_beams, 2000, culled=False,
                        sub=sub)
    return sk.sweep_plain(w), sk.sweep_plain(wf), w


@pytest.mark.parametrize("track", range(N_TRACKS))
def test_culled_equals_full_on_track(culled_worlds, track):
    """Every eligible pose of a track, next to the 2.5-cell margin, inside
    and on subcell corners: its culled scan (its own tile's set, one scan
    a subgroup) equals the full table's bit for bit."""
    _, (pm, infos) = culled_worlds
    rows, cols = _track_cells(pm, infos[track])
    poses = _eligible_poses(pm, rows, cols, 768,
                            np.random.default_rng(100 + track))
    culled, full, w = _culled_and_full(pm, poses, 256, 1)
    assert float((w.bid > 0).float().mean()) > 0.99
    assert torch.equal(culled, full)


def test_culled_equals_full_at_1080_beams(culled_worlds):
    """The float32 world at 1080 beams: a few hundred scan poses from the
    sampler's start grids, moved by up to 0.4 m and turned at random, in
    subgroups of 8 after the arc sort; culled == full bit for bit."""
    _, (pm, infos) = culled_worlds
    p = _sorted_scan_poses(pm, infos, 160, 3)
    g = torch.Generator().manual_seed(4)
    p = p + torch.cat([(torch.rand((p.shape[0], 2), generator=g) - 0.5)
                       * 0.8, (torch.rand((p.shape[0], 1), generator=g)
                               - 0.5) * 2.0], -1)
    culled, full, w = _culled_and_full(pm, p, 1080, 8)
    assert float((w.bid > 0).float().mean()) > 0.5
    assert torch.equal(culled, full)


def test_vertex_leak_into_a_wall_body_matches_full(culled_worlds):
    """A beam through the vertex two island segments share fails both f32
    hit tests and passes into the solid island: the full table then hits
    the island's far side, a face that the corridor's certificate proves
    hidden. The pack keeps every face of a wall body whose face a tile
    keeps, so the culled scan meets the same far face."""
    _, (pm, _) = culled_worlds
    pose = torch.tensor([[36.68258285522461, 17.827253341674805,
                          1.8154712915420532]])
    culled, full, w = _culled_and_full(pm, pose, 256, 1)
    assert int(w.bid[0]) > 0
    # the beam's first wall in exact arithmetic is 11.70 m out; both
    # sweeps pass through it at the vertex
    assert abs(float(full[0, 155]) - 21.4231) < 1e-3
    assert torch.equal(culled, full)


def test_erosion_certifies_one_component_a_track(tmp_path, monkeypatch,
                                                 culled_worlds):
    """A fresh build of the world's pack certifies as many components as
    the world has tracks (``culling.erosion_refine.components``), and
    builds the pack the cached one holds."""
    from f1tenth_gym_tpu_torch.ops import culling

    monkeypatch.setenv("F1TENTH_TORCH_CACHE", str(tmp_path))
    before = culling.erosion_refine.components
    md, _ = PM.multi_track_map_data(N_TRACKS, seed=SEED, device="cpu")
    assert culling.erosion_refine.components - before == N_TRACKS
    _, (pm, _) = culled_worlds
    for f in ("tile_tables", "tile_ngroups", "tile_blockmap",
              "cull_eligible"):
        assert torch.equal(getattr(md, f), getattr(pm, f)), f


# example_map's pack at 2.5 m tiles from the corridor of its start pose,
# and the keys of its packs, as built before a list of seeds was accepted
EXAMPLE_PACK_SHA1 = "e1d008207570d28bad634d6d7f48158fc8cd68f6"
EXAMPLE_KEYS = {(2.5, (0.7, 0.0)): "c876f4fa02e3788e",
                (2.5, None): "3ae4513235eb9768",
                (1.25, None): "4ea50cd22ba25881"}


def test_single_seed_pack_and_key_unchanged():
    """One seed, given alone or as a list of one, and no seed build the
    pack and the cache key they built before per-component certificates:
    example_map's packs and warm caches stay as they were."""
    import hashlib

    from f1tenth_gym_tpu_torch.maps import map_path
    from f1tenth_gym_tpu_torch.ops import culling
    from f1tenth_gym_tpu_torch.ops.segments import segments_from_map
    from f1tenth_gym_tpu_torch.utils.map_loader import (load_map_image,
                                                        load_map_yaml)

    path = map_path("example_map")
    path = path if path.endswith(".yaml") else path + ".yaml"
    res, origin, _ = load_map_yaml(path)
    bitmap = load_map_image(path[:-5] + ".png")
    segs = segments_from_map(bitmap, res, origin, 1.5, dtype=np.float32)

    def key(ts, seed):
        return culling.pack_cache_key(segs, 30.0, ts, 1, 0, None, bitmap,
                                      res, origin, seed)

    for (ts, seed), want in EXAMPLE_KEYS.items():
        assert key(ts, seed) == want
    assert key(2.5, [(0.7, 0.0)]) == EXAMPLE_KEYS[(2.5, (0.7, 0.0))]
    before = culling.erosion_refine.components
    tt = culling.build_tile_tables(segs, 30.0, tile_size=2.5, bitmap=bitmap,
                                   resolution=res, origin=origin,
                                   component_seed=[(0.7, 0.0)])
    assert culling.erosion_refine.components - before == 1
    h = hashlib.sha1()
    for a in (tt.tables, tt.ngroups, tt.blockmap, tt.ext, tt.eligible):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(np.float64([tt.x0, tt.y0, tt.tile_size, tt.nx, tt.ny,
                         tt.neighborhood]).tobytes())
    assert h.hexdigest() == EXAMPLE_PACK_SHA1


def _twin_rings():
    """A raster of two round corridors 4 m wide, side by side with a
    0.25 m wall between them where they come closest, and a third beyond
    the LiDAR's range (walls 0, free 255), 0.0625 m cells: the 2.5 m tiles
    at the thin wall hold eligible cells of the first two."""
    res = 0.0625
    ys, xs = np.mgrid[0:320, 0:1216] * res + res / 2
    bitmap = np.zeros(xs.shape)
    for cx in (10.0, 26.25, 66.0):
        r = np.hypot(xs - cx, ys - 10.0)
        bitmap[(r > 4.0) & (r < 8.0)] = 255.0
    return bitmap, res, [(4.0, 10.0), (20.25, 10.0)]


def test_pose_never_takes_a_window_of_another_corridor():
    """Where one tile holds eligible cells of two corridors, a segment
    leaves it only when both corridors' certificates prove it hidden: the
    scans of both corridors there equal the full table's. Against it, the
    pack proven under one corridor's certificate alone culls the other
    corridor's own walls from those tiles."""
    import dataclasses

    bitmap, res, seeds = _twin_rings()
    both = P.make_map_data(bitmap, res, (0.0, 0.0, 0.0),
                           extract_segments=True, tile_culling=True,
                           culling_component_seed=seeds, device="cpu")
    one = P.make_map_data(bitmap, res, (0.0, 0.0, 0.0),
                          extract_segments=True, tile_culling=True,
                          culling_component_seed=seeds[0], device="cpu")
    el = both.cull_eligible.numpy() > 0
    rng = np.random.default_rng(9)
    tm = both.tile_meta_host
    ts = 1.0 / tm[2]
    # the tiles across the shared wall, and poses of each corridor in them
    ti = int((18.125 - tm[0]) // ts)
    x_lo, x_hi = tm[0] + ti * ts, tm[0] + (ti + 1) * ts
    poses = []
    for lo, hi in ((x_lo, 18.0), (18.25, x_hi)):
        x = rng.uniform(lo, hi, 4096)
        y = rng.uniform(6.0, 14.0, 4096)
        ok = el[np.floor(y / res).astype(int), np.floor(x / res).astype(int)]
        assert ok.sum() > 512
        poses.append(np.stack([x[ok], y[ok],
                               rng.uniform(-np.pi, np.pi, ok.sum())],
                              -1)[:512])
    p = torch.as_tensor(np.concatenate(poses), dtype=torch.float32)
    culled, full, w = _culled_and_full(both, p, 256, 1)
    assert bool((w.bid > 0).all())
    assert torch.equal(culled, full)
    # one corridor's certificate over the same gate: the other corridor's
    # poses lose their own walls
    wrong = dataclasses.replace(one, cull_eligible=both.cull_eligible)
    culled1, full1, _ = _culled_and_full(wrong, p, 256, 1)
    assert torch.equal(full1, full)
    assert torch.equal(culled1[:512], full[:512])
    assert not torch.equal(culled1[512:], full[512:])


def test_composed_scans_match_standalone(world64):
    md, infos = world64
    tables = P.make_scan_tables(num_beams=108, dtype=torch.float64,
                                device="cpu")
    for k in (0, N_TRACKS - 1):
        solo_md, solo_wpts = random_track_map_data(
            seed=SEED + k, dtype=torch.float64, device="cpu")
        info = infos[k]
        shift = info.waypoints[0, :2] - solo_wpts[0, :2]
        np.testing.assert_allclose(info.waypoints[:, :2],
                                   solo_wpts[:, :2] + shift, atol=1e-9)
        n = len(solo_wpts)
        for frac in (0.2, 0.55, 0.8):
            i = int(n * frac)
            d = solo_wpts[(i + 1) % n, :2] - solo_wpts[i, :2]
            th = np.arctan2(d[1], d[0])
            pose_solo = torch.tensor([[solo_wpts[i, 0], solo_wpts[i, 1], th]],
                                     dtype=torch.float64)
            pose_world = torch.tensor([[info.waypoints[i, 0],
                                        info.waypoints[i, 1], th]],
                                      dtype=torch.float64)
            a = get_scan(pose_solo, solo_md, tables, 108, 2000)[0]
            b = get_scan(pose_world, md, tables, 108, 2000)[0]
            assert float((a - b).abs().max()) < 0.08, (k, frac)


def test_sampler_spawns_on_track(world64):
    md, infos = world64
    sampler = PM.multi_track_pose_sampler(infos, device="cpu",
                                          dtype=torch.float64)
    E, A = 16, 2
    p = sampler(P.make_generator("cpu", 0), (E, A))
    assert p.shape == (E, A, 3) and p.dtype == torch.float64
    d = dt_lookup(p[..., 0].reshape(-1), p[..., 1].reshape(-1), md)
    assert float(d.min()) > 0.5
    p = p.numpy()
    for e in range(E):
        x0, y0, x1, y1 = infos[(e * N_TRACKS) // E].bbox
        assert (p[e, :, 0] >= x0 - 1e-6).all() and (p[e, :, 0] <= x1).all()
        assert (p[e, :, 1] >= y0 - 1e-6).all() and (p[e, :, 1] <= y1).all()
    gap = np.hypot(*(p[:, 0, :2] - p[:, 1, :2]).T)
    assert (gap > 0.7).all() and (gap < 3.0).all(), (gap.min(), gap.max())
    # one agent when the shape has no agent axis; float32 by default
    one = PM.multi_track_pose_sampler(infos, device="cpu")(
        P.make_generator("cpu", 1), (5,))
    assert one.shape == (5, 1, 3) and one.dtype == torch.float32


def test_culling_stays_local(culled_worlds):
    """A tile at each track's center sweeps far fewer groups from its 2x2
    window than the composed world's full table holds."""
    _, (md, infos) = culled_worlds
    ng = md.tile_ngroups.numpy()
    blockmap = md.tile_blockmap.numpy()
    meta = md.tile_meta.numpy()
    nx = int(meta[3])
    locals_ = []
    for info in infos:
        cx = (info.bbox[0] + info.bbox[2]) / 2
        cy = (info.bbox[1] + info.bbox[3]) / 2
        ti = int((cx - meta[0]) * meta[2])
        tj = int((cy - meta[1]) * meta[2])
        blk = int(blockmap[tj * nx + ti])
        assert blk >= 0, "track-center window fell back to the full table"
        locals_.append(int(ng[1 + blk]))
    assert max(locals_) < int(ng[0]) / 2, (locals_, int(ng[0]))


@pytest.mark.parametrize("E,A", [(16, 2), (10, 3), (7, 1)])
def test_sampler_matches_jax_on_its_draws(world64, E, A):
    """The port's arithmetic after the draws, fed the JAX sampler's own
    draws (recomputed from its key), equals the JAX sampler (float64)."""
    _, infos = world64
    key = jax.random.PRNGKey(5 + E)
    want = np.asarray(JM.multi_track_pose_sampler(infos)(key, (E, A)))
    k1, k2 = jax.random.split(key)
    n_wp = min(len(i.waypoints) for i in infos)
    idx0 = np.array(jax.random.randint(k1, (E,), 0, n_wp))
    jitter = np.array(jax.random.uniform(k2, (E, A), minval=-0.15,
                                           maxval=0.15, dtype=jnp.float64))
    sampler = PM.multi_track_pose_sampler(infos, device="cpu",
                                          dtype=torch.float64)
    got = sampler.from_draws(torch.as_tensor(idx0), torch.as_tensor(jitter))
    assert want.dtype == np.float64 and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_locality_sort_matches_jax(culled_worlds):
    """The arc sort's order equals the JAX sort's on the same float32
    states: sampler poses, and positions outside every cell."""
    (jm, ji), (pm, pi) = culled_worlds
    rng = np.random.default_rng(3)
    poses = PM.multi_track_pose_sampler(pi, device="cpu")(
        P.make_generator("cpu", 2), (96, 2)).numpy()
    h, w = pm.dt.shape
    res = float(pm.resolution)
    stray = np.stack([rng.uniform(-20, w * res + 20, (32, 2)),
                      rng.uniform(-20, h * res + 20, (32, 2)),
                      rng.uniform(0, 6.28, (32, 2))], -1)
    poses = np.concatenate([poses, stray.astype(np.float32)])
    rng.shuffle(poses)
    cfg = P.SimConfig(num_agents=2)
    states = P.init_state(torch.as_tensor(poses), cfg)
    got = PM.multi_track_locality_sort(pm, pi)(states)
    jstates = _jax_states(poses)
    want = JM.multi_track_locality_sort(jm, ji)(jstates)
    assert not np.array_equal(got.x.numpy(), poses)   # it does reorder
    assert np.array_equal(got.x.numpy(), np.asarray(want.x))
    assert np.array_equal(got.start_xs.numpy(), np.asarray(want.start_xs))


def _jax_states(poses):
    """A batched JAX SimState at ``poses`` (E, A, 3), float32."""
    from f1tenth_gym_tpu import SimConfig
    from f1tenth_gym_tpu.core.env import init_state

    cfg = SimConfig(num_agents=poses.shape[1], dtype="float32")
    keys = jax.random.split(jax.random.PRNGKey(0), poses.shape[0])
    return jax.vmap(lambda p, k: init_state(p, k, cfg))(
        jnp.asarray(poses, jnp.float32), keys)
