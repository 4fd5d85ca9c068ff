"""PyTorch port: multi-track worlds (tracks/multi.py).

The 4-track world of seed 11 against the JAX package's: the raster, the
distance transform, the segments and the kernel table, the track infos,
and with culling the whole pack byte for byte (each package's pack is
built once for the module). Then tests/test_multi_track.py on the port
(composed scans equal standalone ones, the sampler spawns on its track,
culling stays local), the sampler on JAX's own draws and the arc sort's
order against the JAX sort's.
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


@pytest.mark.parametrize("field", [
    "dt", "segments", "seg_table", "tile_tables", "tile_ngroups",
    "tile_blockmap", "tile_meta", "cull_eligible"])
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


def test_eligibility_excludes_every_corridor(culled_worlds):
    """The erosion-fused gate certifies the free component with the most
    near-wall cells: in a composed world that is the open space around the
    tracks, so no corridor cell is eligible and every subgroup of scans on
    a track sweeps the full table, in both packages (their packs are equal
    byte for byte). Documented in ROADMAP.md (faults found)."""
    _, (pm, infos) = culled_worlds
    el = pm.cull_eligible.numpy() > 0
    free = pm.dt.numpy() > 0
    res = float(pm.resolution)
    inside = np.zeros_like(free)
    for info in infos:
        x0, y0, x1, y1 = info.bbox
        inside[int(round(y0 / res)):int(round(y1 / res)),
               int(round(x0 / res)):int(round(x1 / res))] = True
    assert not el[free & inside].any()
    assert el[free & ~inside].mean() > 0.5
    sampler = PM.multi_track_pose_sampler(infos, device="cpu")
    poses = sampler(P.make_generator("cpu", 0), (64, 2)).reshape(-1, 3)
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    tables = P.make_scan_tables(num_beams=108, device="cpu")
    w = sk.prepare_map(poses, pm, tables, 108, 2000)
    assert int((w.bid > 0).sum()) == 0


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
