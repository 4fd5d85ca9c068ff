"""PyTorch port: the scan kernel's phase mask and launch knobs, on the CPU.

The JAX kernel takes a phase mask (``pallas_scan.py:323-330``) and its
layout knobs EA and SUB (``:120-124``). The port's kernel takes the mask
and its own knobs: ``chunk`` beams a warp, ``warps`` chunks a block, the
row skip, and ``sub`` scans a subgroup. On the CPU the plain versions run:
each masked output must be what the masked kernel stores (so that
chip_smoke.py can hold the kernel to them bit for bit), the full mask must
stay the production sweep bit for bit, and the knobs that may not change
the ranges must not.
"""

import dataclasses

import numpy as np
import pytest
import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.ops.pallas_scan import select_windows as j_select
from f1tenth_gym_tpu_torch.maps import map_path
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
from f1tenth_gym_tpu_torch.tools.common import bench_workload

NB, TD = 108, 2000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bench():
    """example_map's 1.25 m pack (the main path's), 108 beams, 64 of the
    bench sampler's envs in tile-snake order: (map, tables, flat poses)."""
    m, tables, poses = bench_workload(1.25, 64, NB, "cpu")
    return m, tables, poses.reshape(-1, 3)


@pytest.fixture(scope="module")
def w(bench):
    m, tables, flat = bench
    return sk.prepare_map(flat, m, tables, NB, TD)


def test_dirs_is_the_beam_directions(w):
    got = sk.sweep_plain(w, "dirs")
    assert torch.equal(got, sk._beam_dirs(w)[0])
    assert got.shape == (w.scal.shape[0], NB)
    assert torch.equal(sk.sweep(w, phases="dirs"), got)


def test_sweep_accumulator_gives_the_ranges(w):
    acc = sk.sweep_plain(w, "dirs,sweep")
    ranges = sk.sweep_plain(w)
    assert torch.equal(acc, sk.sweep_acc(w))
    assert (acc >= 0).all() and (acc > 0).any()
    assert torch.equal(
        torch.minimum(1.0 / torch.clamp(acc, min=1e-9), w.scal[:, 6:7]),
        ranges)
    assert torch.equal(sk.sweep_plain(w, "dirs,sweep,out"), ranges)
    # the order of the mask's parts does not matter
    assert torch.equal(sk.sweep_plain(w, "out,dirs,sweep"), ranges)


def test_out_alone_gives_max_range(w):
    got = sk.sweep_plain(w, "dirs,out")
    assert torch.equal(got, w.scal[:, 6:7].expand_as(got))
    assert float(got.max()) == float(w.scal[0, 6])


@pytest.mark.parametrize("phases", ["sweep", "sweep,out", "out", "",
                                    "dirs,swep", "dirs,sweep,out,extra"])
def test_bad_mask_raises(w, bench, phases):
    m, tables, flat = bench
    with pytest.raises(ValueError, match="phase mask"):
        sk.sweep_plain(w, phases)
    with pytest.raises(ValueError, match="phase mask"):
        sk.sweep(w, phases=phases)
    with pytest.raises(ValueError, match="phase mask"):
        sk.scan_pallas(flat, m.seg_table, tables, NB, TD, interpret=True,
                       phases=phases)


def test_scan_pallas_phases(bench, w):
    """scan_pallas with a mask returns the masked output, unpadded, on the
    CPU as in interpret mode."""
    m, tables, flat = bench
    n = flat.shape[0]
    for phases in ("dirs", "dirs,sweep", "dirs,out"):
        for interpret in (True, False):
            got = sk.scan_pallas(flat[:n - 3], m.seg_table, tables, NB, TD,
                                 interpret=interpret, phases=phases)
            full_w = sk.prepare(flat[:n - 3], m.seg_table, tables, NB, TD)
            assert torch.equal(got, sk.sweep_plain(full_w, phases)[:n - 3])


@pytest.mark.parametrize("sub", [1, 2, 4, 16])
def test_sub_keeps_the_ranges_where_culled_equals_full(bench, w, sub):
    """On example_map's 1.25 m pack (no split blocks, culled == full) every
    subgroup size gives the default's ranges bit for bit."""
    m, tables, flat = bench
    assert m.tile_ext is None
    want = sk.sweep_plain(w)
    assert torch.equal(want, sk.sweep_plain(
        sk.prepare_map(flat, m, tables, NB, TD, culled=False)))
    ws = sk.prepare_map(flat, m, tables, NB, TD, sub=sub)
    assert ws.sub == sub and ws.bid.shape[0] == ws.scal.shape[0] // sub
    assert ws.swept_rows().shape[0] == ws.scal.shape[0]
    assert torch.equal(sk.sweep_plain(ws)[:flat.shape[0]],
                       want[:flat.shape[0]])
    if sub < sk.SUB:   # smaller subgroups pick windows no wider
        assert ws.swept_rows().double().mean() <= w.swept_rows().double().mean()
    got = sk.scan(flat, m, tables, NB, TD, device="cpu", sub=sub)
    assert torch.equal(got, want[:flat.shape[0]])


def test_sub_pads_to_its_multiple(bench):
    m, tables, flat = bench
    ws = sk.prepare_map(flat[:37], m, tables, NB, TD, sub=16)
    assert ws.scal.shape[0] == 48 and ws.bid.shape[0] == 3
    assert torch.equal(ws.scal[37:, :2], ws.scal[36:37, :2].expand(11, 2))
    with pytest.raises(ValueError, match="subgroup size"):
        sk.prepare_map(flat, m, tables, NB, TD, sub=3)


def test_select_windows_at_sub_4_matches_jax():
    """The port's selection on (nsub, 4) tile indices equals the JAX
    select_windows (shape-generic) on compact's split pack."""
    m = P.load_map(map_path("compact"), extract_segments=True,
                   tile_culling=True, culling_tile_size=2.0,
                   culling_split_cap=96, device="cpu")
    rng = np.random.default_rng(21)
    nx, ny = int(m.tile_meta_host[3]), int(m.tile_meta_host[4])
    base = np.stack([rng.integers(-1, nx + 1, 300),
                     rng.integers(-1, ny + 1, 300)], -1)
    spread = rng.integers(0, 9, (300, 1, 1))
    tij = base[:, None, :] + rng.integers(0, 9, (300, 4, 2)) % (spread + 1)
    ti, tj = tij[..., 0], tij[..., 1]
    full_ng = m.seg_table.shape[0] // sk.GROUP
    got = sk.select_windows(torch.as_tensor(ti), torch.as_tensor(tj),
                            m.tile_blockmap, m.tile_ngroups, m.tile_ext,
                            nx, ny, full_ng)
    want = j_select(ti, tj, m.tile_blockmap.numpy(), m.tile_ngroups.numpy(),
                    m.tile_ext.numpy(), nx, ny, full_ng)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    assert got[2].shape == (300, 4)
    assert (got[0] > 0).any() and (got[0] == 0).any() and (got[3] > 0).any()


@pytest.mark.parametrize("chunk", [64, 32])
def test_skip_sound_at_other_chunks(w, chunk):
    """A smaller chunk narrows every warp's sector: the skip must still
    keep every pair that hits, and the kept sweep equal the full one."""
    counts = sk.pair_counts(w, chunk)
    assert counts["missed"] == 0 and counts["hit"] > 0
    assert counts["kept"] <= sk.pair_counts(w)["kept"]
    keep = sk.skip_keep(w, *sk.scan_rows(w), chunk)
    assert keep.shape[1] == -(-NB // chunk)
    assert torch.equal(sk.sweep_kept(w, chunk), sk.sweep_plain(w))


def test_knobs_checked_and_inert_on_cpu(w):
    want = sk.sweep_plain(w)
    for chunk, warps, skip in ((64, 5, True), (128, 16, False), (4, 1, True)):
        assert torch.equal(sk.sweep(w, chunk=chunk, warps=warps, skip=skip),
                           want)
    for chunk, warps in ((130, None), (66, None), (0, None), (64, 17),
                         (64, 0)):
        with pytest.raises(ValueError):
            sk.sweep(w, chunk=chunk, warps=warps)
    assert sk.launch_shape(1080) == (128, 9, 1)
    assert sk.launch_shape(1080, 64) == (64, 9, 2)
    assert sk.launch_shape(1080, 128, 5) == (128, 5, 2)
    assert sk.warps_per_block(1080, 64) == 9


def test_cuda_input_checks_hold_sub(w):
    sk._check_cuda_inputs(w)
    with pytest.raises(ValueError, match="inconsistent"):
        sk._check_cuda_inputs(dataclasses.replace(w, sub=16))
    with pytest.raises(ValueError, match="inconsistent"):
        sk._check_cuda_inputs(dataclasses.replace(w, bid=w.bid[:-1]))
    odd = dataclasses.replace(w, scal=w.scal[:-4], est=w.est[:-4],
                              ecnt=w.ecnt[:-4])
    with pytest.raises(ValueError, match="inconsistent"):
        sk._check_cuda_inputs(odd)


def test_resources_parse_each_instantiation():
    report = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_117scan_sweep_kernelILi7ELi8EEEvPKfS2_' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_117scan",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 27648 bytes "
        "smem, 464 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_117scan_sweep_kernelILi1ELi16EEEvPKfS2_' for "
        "'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 24 registers, used 0 barriers, 27648 bytes "
        "smem, 464 bytes cmem[0]",
    ])
    got = sk.resources(report)
    assert got == {(7, 8): dict(registers=40, smem_bytes=27648,
                                spill_bytes=0),
                   (1, 16): dict(registers=24, smem_bytes=27648,
                                 spill_bytes=12)}
    assert sk.phase_mask(sk.FULL_PHASES) == 7 and sk.phase_mask("dirs") == 1
