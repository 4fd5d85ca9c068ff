"""PyTorch port: the scan kernel's row skip on example_map, on the CPU.

The main path's map and pack: example_map with its 1.25 m erosion-gated
culling pack, 1080 beams. Every (scan, beam, row) pair whose hit test
passes with s > 0 is kept by the plain transcription of the kernel's skip,
and the plain sweep over the kept pairs equals ``sweep_plain`` bit for bit
(tests/test_torch_scan_skip.py states why that is the kernel's gate).
"""

import numpy as np
import pytest
import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.maps import map_path
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
from f1tenth_gym_tpu_torch.parallel.vector import tile_snake_key
from test_torch_scan_skip import NB, TD, assert_sound, rows_read_loop


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables():
    return P.make_scan_tables(num_beams=NB, device="cpu")


@pytest.fixture(scope="module")
def example_map():
    return P.load_map(map_path("example_map"), extract_segments=True,
                      tile_culling=True, culling_tile_size=1.25,
                      device="cpu")


@pytest.fixture(scope="module")
def bench_flat(example_map):
    """48 of the bench sampler's start poses (bench.py:201-208), tile-snake
    sorted as the main path keeps them."""
    m = example_map
    sampler = P.uniform_pose_sampler(m, clearance=0.6, grouped=True,
                                     align_theta=True,
                                     component_seed=(0.7, 0.0))
    poses = sampler(P.make_generator("cpu", 7), (256, 2))
    tm = m.tile_meta_host
    key = tile_snake_key(poses[..., 0].mean(1), poses[..., 1].mean(1),
                         tile_size=1.0 / tm[2], origin=(tm[0], tm[1]))
    return poses[torch.argsort(key, stable=True)].reshape(-1, 3)[:48]


def test_example_map_bench_poses(example_map, tables, bench_flat):
    """The bench start poses, culled and full."""
    m, flat = example_map, bench_flat
    for culled in (True, False):
        w = sk.prepare_map(flat, m, tables, NB, TD, culled=culled)
        counts = assert_sound(w)
        assert counts["kept"] < 0.3 * counts["swept"]
    assert int((sk.prepare_map(flat, m, tables, NB, TD).bid > 0).sum()) > 0


def test_example_map_near_walls(example_map, tables):
    """Origins within a few cm of the walls (the eps band and just past
    it), eight around each of six wall cells; such origins are not
    eligible for the culled tables, so they sweep the full table."""
    m = example_map
    rng = np.random.default_rng(5)
    dt = m.dt.numpy()
    res = float(m.resolution)
    cells = np.argwhere((dt > 0.0) & (dt < 0.08))
    pick = cells[rng.integers(0, len(cells), 6)]
    poses = []
    for cy, cx in pick:
        for _ in range(sk.SUB):
            jit = rng.uniform(-0.3, 0.3, 2)
            poses.append([(cx + jit[0]) * res + float(m.orig_x),
                          (cy + jit[1]) * res + float(m.orig_y),
                          rng.uniform(0, 2 * np.pi)])
    assert_sound(sk.prepare_map(torch.tensor(poses, dtype=torch.float32),
                                 m, tables, NB, TD))


def test_rows_read(example_map, tables, bench_flat):
    """``rows_read`` (the bytes of the kernel's bound) counts each
    (table, row) some scan sweeps once: a loop over the subgroups on the
    culled pack, every row on the full table."""
    m, poses = example_map, bench_flat
    w = sk.prepare_map(poses, m, tables, NB, TD)
    assert int((w.bid > 0).sum()) > 0
    assert sk.rows_read(w) == rows_read_loop(w)
    w_f = sk.prepare_map(poses, m, tables, NB, TD, culled=False)
    assert sk.rows_read(w_f) == w_f.full.shape[0]
