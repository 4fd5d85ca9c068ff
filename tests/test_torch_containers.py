"""PyTorch port: configuration, containers, scan tables, state conversion.

The port (f1tenth_gym_tpu_torch) is held to the JAX package on the same
inputs; both run here on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.maps import map_path
from f1tenth_gym_tpu_torch import config as pconfig
from f1tenth_gym_tpu_torch.utils import convert


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _leaves(obj):
    return {f.name: (None if getattr(obj, f.name) is None
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def test_config_defaults_equal_jax():
    from f1tenth_gym_tpu import config as jconfig

    assert dataclasses.asdict(P.SimConfig()) == dataclasses.asdict(J.SimConfig())
    assert P.DEFAULT_PARAMS == J.DEFAULT_PARAMS
    for name in ("DEFAULT_FOV", "DEFAULT_MAX_RANGE", "DEFAULT_EPS",
                 "DEFAULT_SCAN_STD", "DEFAULT_TTC_THRESH", "DEFAULT_TIMESTEP",
                 "DEFAULT_SEED", "INTEGRATOR_RK4", "INTEGRATOR_EULER",
                 "MODEL_ST", "MODEL_KS"):
        assert getattr(pconfig, name) == getattr(jconfig, name), name


def test_auto_engine_resolution():
    cfg = P.SimConfig(scan_engine="auto")
    assert cfg.resolved_scan_engine("cpu", True) == "march"
    assert cfg.resolved_scan_engine("cuda", True) == "kernel"
    assert cfg.resolved_scan_engine("cuda", False) == "march"
    assert P.SimConfig(scan_engine="kernel").resolved_scan_engine(
        "cpu", True) == "kernel"


@pytest.mark.parametrize("num_beams", [108, 1080])
def test_scan_tables_equal_jax_f64(num_beams):
    """Built in float64 on the host by the same formulas: equal, rtol=0."""
    ours = P.make_scan_tables(num_beams=num_beams, dtype=torch.float64,
                              device="cpu")
    ref = J.make_scan_tables(num_beams=num_beams, dtype=jnp.float64)
    for name, want in _leaves(ref).items():
        got = getattr(ours, name).numpy()
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0, atol=0, err_msg=name)


def test_vehicle_params_equal_jax():
    ours = P.VehicleParams.create({"mu": 0.9}, dtype=torch.float64,
                                  device="cpu")
    ref = J.VehicleParams.create({"mu": 0.9}, dtype=jnp.float64)
    for name, want in _leaves(ref).items():
        assert getattr(ours, name).item() == float(want), name


def test_convert_round_trips_jax_containers():
    """JAX leaves -> port containers -> numpy: every leaf unchanged (the
    PRNG key, which the port does not carry, excepted)."""
    from f1tenth_gym_tpu.parallel import batch_reset
    from f1tenth_gym_tpu.tracks.synthetic import ring_map_data, ring_start_poses

    m = J.load_map(map_path("compact"), ".png", dtype=jnp.float32,
                   extract_segments=True, tile_culling=True,
                   culling_tile_size=2.0)
    m_leaves = _leaves(m)
    pm = convert.map_data_from_jax(m_leaves, device="cpu")
    assert pm.tile_meta_host == tuple(float(v) for v in m_leaves["tile_meta"])
    back = convert.to_numpy(pm)
    for name, want in m_leaves.items():
        if want is None:
            assert back[name] is None, name
        else:
            assert back[name].dtype == want.dtype, name
            np.testing.assert_array_equal(back[name], want, err_msg=name)

    params = J.VehicleParams.create(dtype=jnp.float64)
    pp = convert.vehicle_params_from_jax(_leaves(params), device="cpu")
    for name, want in _leaves(params).items():
        np.testing.assert_array_equal(convert.to_numpy(pp)[name], want)

    ring = ring_map_data(size=128, radius=2.0, dtype=jnp.float64)
    tables = J.make_scan_tables(num_beams=32, dtype=jnp.float64)
    pt = convert.scan_tables_from_jax(_leaves(tables), device="cpu")
    for name, want in _leaves(tables).items():
        np.testing.assert_array_equal(convert.to_numpy(pt)[name], want)

    cfg = J.SimConfig(num_agents=2, num_beams=32, dtype="float64")
    E = 3
    poses = jnp.asarray(np.stack([ring_start_poses(2, 2.0)] * E))
    states, *_ = batch_reset(poses, jax.random.split(jax.random.PRNGKey(0), E),
                             params, ring, tables, cfg, 0.01)
    s_leaves = _leaves(states)
    ps = convert.sim_state_from_jax(s_leaves, device="cpu")
    assert ps.num_envs == E and ps.num_agents == 2
    back = convert.to_numpy(ps)
    assert set(back) == set(s_leaves) - {"key"}
    for name in back:
        np.testing.assert_array_equal(back[name], s_leaves[name], err_msg=name)
