"""The stata_basement gate of chip_smoke.py, through both packages on the CPU.

chip_smoke.py holds the kernel engine to the marching engine at MSE < 2.0
over the beams whose march ends inside the map raster. On stata_basement
the 32 poses of the gate's sampler (bench.py:258's sampler, drawn on the
CPU from seed 11 as chip_smoke.py draws them) send beams out of the raster
through the map's open edges. There the march stops on the wrapped
out-of-bounds cell dt[H-1, W-1], an obstacle, while the segment sweep runs
on to a wall or the max range. The tests below show that the JAX
package's own engines (``get_scan`` and the Pallas kernel in interpret
mode) part on exactly the beams that leave the raster in the port, and
fail the all-beam bar there, while they agree inside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.maps import map_path
from f1tenth_gym_tpu.ops import lidar as jlidar
from f1tenth_gym_tpu.ops.pallas_scan import scan_pallas
from f1tenth_gym_tpu_torch.ops import lidar as plidar
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

NB, TD = 1080, 2000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inside_raster(m, poses, ranges, tables):
    """(n, B) bool, in numpy: the beam's end point lies in the raster."""
    p = np.asarray(poses, np.float64)
    idx = np.asarray(jlidar.beam_theta_indices(jnp.asarray(p[:, 2]), tables,
                                               NB, TD))
    r = np.asarray(ranges, np.float64)
    xt = p[:, 0:1] + r * np.asarray(tables.cosines)[idx] - float(m.orig_x)
    yt = p[:, 1:2] + r * np.asarray(tables.sines)[idx] - float(m.orig_y)
    c, s = float(m.orig_c), float(m.orig_s)
    xr, yr = xt * c + yt * s, -xt * s + yt * c
    h, w = np.asarray(m.dt).shape
    res = float(m.resolution)
    return (xr >= 0) & (xr < w * res) & (yr >= 0) & (yr < h * res)


@pytest.fixture(scope="module")
def gate(_one_thread):
    pm = P.load_map(map_path("stata_basement"), extract_segments=True,
                    device="cpu")
    poses = P.uniform_pose_sampler(pm, clearance=0.5)(
        P.make_generator("cpu", 11), (32,))
    pt = P.make_scan_tables(num_beams=NB, device="cpu")
    jm = J.load_map(map_path("stata_basement"), ".png", extract_segments=True)
    jt = J.make_scan_tables(num_beams=NB, dtype=jnp.float32)
    jp = jnp.asarray(poses.numpy())
    out = dict(
        j_march=np.asarray(jlidar.get_scan(jp, jm, jt, NB, TD)),
        j_kern=np.asarray(scan_pallas(jp, jm.seg_table, jt, NB, TD,
                                      interpret=True)),
        p_march=plidar.get_scan(poses, pm, pt, NB, TD).numpy(),
        p_kern=sk.scan(poses, pm, pt, NB, TD, device="cpu").numpy())
    out["j_inside"] = _inside_raster(jm, poses.numpy(), out["j_march"], jt)
    out["p_inside"] = _inside_raster(jm, poses.numpy(), out["p_march"], jt)
    return out


def test_same_beams_leave_the_raster(gate):
    """Both marches take the same steps from the same raster (tolerance of
    test_torch_lidar's f32 march test), so the same beams leave it."""
    err = np.abs(gate["p_march"] - gate["j_march"])
    assert np.median(err) < 1e-5 and np.mean(err < 1e-3) > 0.99
    np.testing.assert_array_equal(gate["p_inside"], gate["j_inside"])
    assert (~gate["j_inside"]).sum() > 1000   # of 34,560 beams


def test_jax_engines_part_outside_the_raster(gate):
    """The JAX package's march and Pallas kernel fail the all-beam bar on
    these poses, pass it inside the raster, and the beams that leave the
    raster carry over 99 % of their squared difference."""
    d2 = (gate["j_march"] - gate["j_kern"]) ** 2
    inside = gate["j_inside"]
    assert d2.mean() > 2.0
    assert d2[inside].mean() < 2.0
    assert d2[~inside].sum() > 0.99 * d2.sum()


def test_port_gate_agrees_with_jax(gate):
    """The port's kernel engine against the JAX kernel at the kernel
    test's tolerance (median |delta| < 1e-5 m, p99.9 < 1e-3 m: XLA on the
    CPU may contract FMAs), and the port's gate reads as JAX's does."""
    err = np.abs(gate["p_kern"] - gate["j_kern"])
    assert np.median(err) < 1e-5
    assert np.percentile(err, 99.9) < 1e-3
    d2 = (gate["p_march"] - gate["p_kern"]) ** 2
    assert d2.mean() > 2.0
    assert d2[gate["p_inside"]].mean() < 2.0
