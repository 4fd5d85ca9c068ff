"""PyTorch port: vehicle dynamics against the golden fixtures and JAX.

All in float64, where the port and the reference compute the same
formulas in the same order: the fixture tolerance is the JAX package's own
(rtol = atol = 1e-12, tests/test_parity.py:59-84).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu as J
import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu.ops import dynamics as jdyn
from f1tenth_gym_tpu_torch.ops import dynamics as pdyn

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    return P.VehicleParams.create(dtype=torch.float64, device="cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_dynamics_st_fixture(params):
    d = np.load(os.path.join(FIX, "dynamics.npz"))
    f = pdyn.vehicle_dynamics_st(_t(d["xs"]), _t(d["us"]), params)
    np.testing.assert_allclose(f.numpy(), d["f_st"], rtol=1e-12, atol=1e-12)


def test_dynamics_ks_fixture(params):
    d = np.load(os.path.join(FIX, "dynamics.npz"))
    f = pdyn.vehicle_dynamics_ks5(_t(d["xs"][:, :5]), _t(d["us"]), params)
    np.testing.assert_allclose(f.numpy(), d["f_ks"], rtol=1e-12, atol=1e-12)


def test_pid_fixture(params):
    d = np.load(os.path.join(FIX, "dynamics.npz"))
    pin = _t(d["pid_in"])
    accl, sv = pdyn.pid(pin[:, 0], pin[:, 1], pin[:, 2], pin[:, 3],
                        params.sv_max, params.a_max, params.v_max,
                        params.v_min)
    np.testing.assert_allclose(accl.numpy(), d["pid_out"][:, 0], rtol=1e-12)
    np.testing.assert_allclose(sv.numpy(), d["pid_out"][:, 1], rtol=1e-12)


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
@pytest.mark.parametrize("model", ["st", "ks"])
def test_integrators_match_jax(integrator, model):
    """Random (E, A) states through one integrator step: the port against
    the JAX function, f64, rtol = atol = 1e-12 (transcendentals of the two
    libraries may differ in the last ulp)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.0, 1.0, (16, 2, 7))
    x[..., 3] = rng.uniform(-3.0, 12.0, (16, 2))   # both |v| < 0.5 branches
    x[:4, :, 3] = rng.uniform(-0.6, 0.6, (4, 2))
    u = rng.uniform(-4.0, 10.0, (16, 2, 2))
    jfn = {"st": jdyn.vehicle_dynamics_st, "ks": jdyn.vehicle_dynamics_ks7}
    pfn = {"st": pdyn.vehicle_dynamics_st, "ks": pdyn.vehicle_dynamics_ks7}
    jstep = {"rk4": jdyn.rk4_step, "euler": jdyn.euler_step}[integrator]
    pstep = {"rk4": pdyn.rk4_step, "euler": pdyn.euler_step}[integrator]
    jp = J.VehicleParams.create(dtype=jnp.float64)
    pp = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    want = np.asarray(jstep(jnp.asarray(x), jnp.asarray(u), jp,
                            jnp.float64(0.01), dyn_fn=jfn[model]))
    got = pstep(_t(x), _t(u), pp, torch.tensor(0.01, dtype=torch.float64),
                dyn_fn=pfn[model])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_physics_step_matches_jax():
    """Steer FIFO + PID + RK4 + yaw wrap of the batched physics step."""
    from f1tenth_gym_tpu.core.simulator import physics_step as jphys
    from f1tenth_gym_tpu_torch.core.simulator import physics_step as pphys

    rng = np.random.default_rng(4)
    x = rng.uniform(-1.0, 1.0, (8, 2, 7))
    x[..., 4] = rng.uniform(-0.01, 2 * np.pi + 0.01, (8, 2))
    buf = rng.uniform(-0.4, 0.4, (8, 2, 2))
    act = np.stack([rng.uniform(-0.4, 0.4, (8, 2)),
                    rng.uniform(-2.0, 8.0, (8, 2))], -1)
    jcfg = J.SimConfig(dtype="float64")
    pcfg = P.SimConfig(dtype="float64")
    jp = J.VehicleParams.create(dtype=jnp.float64)
    pp = P.VehicleParams.create(dtype=torch.float64, device="cpu")
    for i in range(8):
        wx, wb = jphys(jnp.asarray(x[i]), jnp.asarray(buf[i]),
                       jnp.asarray(act[i]), jp, jnp.float64(0.01), jcfg)
        gx, gb = pphys(_t(x[i:i + 1]), _t(buf[i:i + 1]), _t(act[i:i + 1]),
                       pp, torch.tensor(0.01, dtype=torch.float64), pcfg)
        np.testing.assert_allclose(gx[0].numpy(), np.asarray(wx),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(gb[0].numpy(), np.asarray(wb))
