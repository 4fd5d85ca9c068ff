"""PyTorch port: the JAX package's import surface, name for name.

Code written against ``f1tenth_gym_tpu`` must keep importing once the
package name is swapped: every name of the JAX ``__all__`` lists resolves
in the port, ``make_env_fns`` drives the ring as the JAX test does,
``scan_pallas`` keeps its JAX signature, and ``load_pytree`` keeps its
keywords without ever unpickling. Every JAX probe in ``tools/`` has a
module of the same name in ``f1tenth_gym_tpu_torch/tools/``.
"""

import importlib
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.core.simulator import _elig_kwargs
from f1tenth_gym_tpu.ops.pallas_scan import scan_pallas as j_scan_pallas
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

NB, TD = 256, 2000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("sub", ["", ".core", ".ops", ".utils", ".parallel"])
def test_jax_all_names_resolve(sub):
    jmod = importlib.import_module("f1tenth_gym_tpu" + sub)
    pmod = importlib.import_module("f1tenth_gym_tpu_torch" + sub)
    missing = [n for n in jmod.__all__ if not hasattr(pmod, n)]
    assert not missing, f"f1tenth_gym_tpu_torch{sub} lacks {missing}"
    assert set(jmod.__all__) <= set(pmod.__all__)


def test_maps_functions_resolve():
    import f1tenth_gym_tpu.maps as jmaps
    import f1tenth_gym_tpu_torch.maps as pmaps

    funcs = [n for n, f in vars(jmaps).items() if inspect.isfunction(f)
             and f.__module__ == jmaps.__name__ and not n.startswith("_")]
    assert {"available_maps", "map_path", "centerline_path"} <= set(funcs)
    for n in funcs:
        assert callable(getattr(pmaps, n)), n
    assert pmaps.available_maps() == jmaps.available_maps()
    for name in ("example_map", "compact"):
        assert pmaps.centerline_path(name) == jmaps.centerline_path(name)
    with pytest.raises(KeyError):
        pmaps.centerline_path("no_such_map")


def test_integrator_enum_shim():
    """tests/test_misc.py::test_integrator_enum_shim, on the port."""
    from f1tenth_gym_tpu_torch.envs.gym_api import _normalize_integrator

    assert _normalize_integrator(P.Integrator.RK4) == "rk4"
    assert _normalize_integrator(P.Integrator.Euler) == "euler"
    assert _normalize_integrator("RK4") == "rk4"
    for a, b in zip(P.Integrator, J.Integrator):
        assert (a.name, a.value, a.name_str) == (b.name, b.value, b.name_str)
    assert P.__version__ == J.__version__


def test_lap_counting_make_env_fns():
    """tests/test_misc.py::test_lap_counting through the port's
    make_env_fns: the same ring, the same steering law; two laps set done."""
    from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data

    f64 = torch.float64
    m = ring_map_data(size=256, radius=4.0, dtype=f64, device="cpu")
    params = P.VehicleParams.create(dtype=f64, device="cpu")
    tables = P.make_scan_tables(num_beams=108, dtype=f64, device="cpu")
    cfg = P.SimConfig(num_agents=1, num_beams=108, dtype="float64",
                      scan_noise=False)
    reset, step = P.make_env_fns(params, m, tables, cfg, 0.01)
    radius = 4.0
    state, obs, *_ = reset(torch.tensor([[[radius, 0.0, np.pi / 2]]],
                                        dtype=f64))
    wheelbase = 0.15875 + 0.17145
    base_steer = float(np.arctan(wheelbase / radius))
    laps, done = [], False
    for _ in range(4000):
        x = state.x[0, 0].numpy()
        r = float(np.hypot(x[0], x[1]))
        h_des = np.arctan2(x[1], x[0]) + np.pi / 2  # CCW tangent heading
        h_err = (h_des - x[4] + np.pi) % (2 * np.pi) - np.pi
        steer = np.clip(base_steer + 0.8 * (r - radius) + 1.0 * h_err,
                        -0.41, 0.41)
        state, obs, reward, done, info = step(state, [[[steer, 3.0]]])
        laps.append(float(obs["lap_counts"][0, 0]))
        if bool(done[0]):
            break
    assert max(laps) >= 2.0, f"never completed 2 laps (max {max(laps)})"
    assert bool(done[0]), "2 laps did not set done"
    assert float(state.collisions[0, 0]) == 0.0, "crashed instead of lapping"
    assert float(obs["lap_times"][0, 0]) < float(state.current_time[0])


def test_make_env_fns_default_generator_and_noise():
    """With scan noise, a call without a generator draws from the
    factory's; passing one draws from it instead."""
    from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data

    m = ring_map_data(size=128, radius=2.0, device="cpu")
    params = P.VehicleParams.create(device="cpu")
    tables = P.make_scan_tables(num_beams=64, device="cpu")
    cfg = P.SimConfig(num_agents=1, num_beams=64)
    reset, step = P.make_env_fns(params, m, tables, cfg, 0.01)
    poses = torch.tensor([[[2.0, 0.0, np.pi / 2]]])
    a, *_ = reset(poses)
    b, *_ = reset(poses)
    assert not torch.equal(a.scans, b.scans)   # the factory's stream runs on
    c, *_ = reset(poses, P.make_generator("cpu", 5))
    d, *_ = reset(poses, P.make_generator("cpu", 5))
    assert torch.equal(c.scans, d.scans)


def _compact_poses(m, rng):
    """Free poses of compact and two 8-scan clusters on eligible cells."""
    dt, elig = m.dt.numpy(), m.cull_eligible.numpy()
    res, ox, oy = float(m.resolution), float(m.orig_x), float(m.orig_y)
    free = np.argwhere(dt > 0.05)
    pick = free[rng.integers(0, len(free), 16)]
    out = [np.stack([pick[:, 1] * res + ox, pick[:, 0] * res + oy,
                     rng.uniform(0, 2 * np.pi, 16)], 1)]
    cells = np.argwhere((dt > 0.3) & (elig > 0))
    for _ in range(2):
        c = cells[rng.integers(0, len(cells))] + rng.uniform(-8, 8, (8, 2))
        out.append(np.stack([c[:, 1] * res + ox, c[:, 0] * res + oy,
                             rng.uniform(0, 2 * np.pi, 8)], 1))
    return np.concatenate(out).astype(np.float32)


def test_scan_pallas_wrapper_matches_jax():
    """The port's scan_pallas with the JAX keywords on compact's culled
    pack (2.0 m tiles) against JAX's scan_pallas(interpret=True), at the
    kernel tolerance of test_torch_scan_kernel.py; the vmappable form on
    a (2, n/2) batch; the erosion guard."""
    from f1tenth_gym_tpu.maps import map_path

    jm = J.load_map(map_path("compact"), ".png", extract_segments=True,
                    tile_culling=True, culling_tile_size=2.0)
    pm = P.load_map(map_path("compact"), extract_segments=True,
                    tile_culling=True, culling_tile_size=2.0, device="cpu")
    jt = J.make_scan_tables(num_beams=NB, dtype=jnp.float32)
    pt = P.make_scan_tables(num_beams=NB, device="cpu")
    poses = _compact_poses(pm, np.random.default_rng(4))
    want = np.asarray(j_scan_pallas(
        jnp.asarray(poses), jm.seg_table, jt, NB, TD, interpret=True,
        tile_tables=jm.tile_tables, tile_ngroups=jm.tile_ngroups,
        tile_meta=jm.tile_meta, tile_blockmap=jm.tile_blockmap,
        tile_ext=jm.tile_ext, **_elig_kwargs(jm)))
    kw = dict(tile_tables=pm.tile_tables, tile_ngroups=pm.tile_ngroups,
              tile_meta=pm.tile_meta, tile_blockmap=pm.tile_blockmap,
              tile_ext=pm.tile_ext, elig_raster=pm.cull_eligible,
              elig_meta=sk.elig_meta(pm))
    got = P.ops.scan_pallas(torch.as_tensor(poses), pm.seg_table, pt, NB, TD,
                            interpret=True, **kw)
    err = np.abs(got.numpy() - want)
    assert np.median(err) < 1e-5 and np.percentile(err, 99.9) < 1e-3
    # on a CPU tensor the kernel path is the plain version too
    assert torch.equal(P.ops.scan_pallas(torch.as_tensor(poses),
                                         pm.seg_table, pt, NB, TD, **kw), got)
    assert torch.equal(got, sk.scan(torch.as_tensor(poses), pm, pt, NB, TD,
                                    device="cpu"))
    batched = P.ops.scan_pallas_vmappable(
        torch.as_tensor(poses).view(2, -1, 3), pm.seg_table, pt, NB, TD,
        interpret=True, **kw)
    assert batched.shape == (2, len(poses) // 2, NB)
    assert torch.equal(batched.reshape(-1, NB), got)
    kw.pop("elig_raster")
    with pytest.raises(ValueError, match="eligibility"):
        P.ops.scan_pallas(torch.as_tensor(poses), pm.seg_table, pt, NB, TD,
                          **kw)


def test_load_pytree_keywords(tmp_path):
    """``allow_pickle=True`` raises and points at ``target=``; ``device``
    puts the leaves of the no-target form on a device; a file of the JAX
    package's save_pytree loads either way."""
    from f1tenth_gym_tpu.utils.checkpoint import save_pytree as j_save

    tree = {"a": np.arange(6.0).reshape(2, 3), "b": {"c": np.int32(7)}}
    path = j_save(str(tmp_path / "tree"), jax.tree.map(jnp.asarray, tree))
    with pytest.raises(ValueError, match="target="):
        P.load_pytree(path, allow_pickle=True)
    flat = P.load_pytree(path)
    assert isinstance(flat["['a']"], np.ndarray)
    on_dev = P.load_pytree(path, device="cpu")
    assert isinstance(on_dev["['a']"], torch.Tensor)
    np.testing.assert_array_equal(on_dev["['a']"].numpy(), tree["a"])
    got = P.load_pytree(path, target={"a": torch.zeros(2, 3, dtype=torch.float64),
                                      "b": {"c": np.int32(0)}}, device=False)
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"])
    assert int(got["b"]["c"]) == 7


def test_every_jax_probe_has_a_port_module():
    """tools/<name>.py of the JAX package -> f1tenth_gym_tpu_torch.tools.
    <name>, with a main(argv=None); importing them all (JAX blocked) edits
    neither sys.path nor the environment."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = sorted(n[:-3] for n in os.listdir(os.path.join(root, "tools"))
                   if n.endswith(".py"))
    assert len(names) == 8
    code = (
        "import importlib, inspect, json, os, sys\n"
        "sys.modules['jax'] = None\n"
        "env, path = dict(os.environ), list(sys.path)\n"
        f"names = {names!r}\n"
        "mods = [importlib.import_module('f1tenth_gym_tpu_torch.tools.' + n)"
        " for n in names]\n"
        "assert dict(os.environ) == env and sys.path == path\n"
        "print(json.dumps([list(inspect.signature(m.main).parameters)"
        " for m in mods]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str([["argv"]] * 8).replace("'", '"')
