"""PyTorch port: the locality sort's permutation
(``sort_envs_for_locality(..., return_order=True)``), which lets per-env
data kept outside the state, such as a gain sweep's gains, follow its env.
"""

import numpy as np
import pytest
import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.planning import PurePursuitPlanner
from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data
from f1tenth_gym_tpu_torch.utils.waypoints import ring_waypoints

E, NB, RADIUS = 12, 32, 4.0
GRIDS = [dict(), dict(tile_size=1.0, origin=(-8.0, -8.0))]   # both keys


@pytest.fixture(scope="module")
def ring():
    """A ring track, one car an env spread round it, facing along it."""
    m = ring_map_data(size=256, radius=RADIUS, extract_segments=True,
                      device="cpu")
    tables = P.make_scan_tables(num_beams=NB, device="cpu")
    params = P.VehicleParams.create(device="cpu")
    cfg = P.SimConfig(num_agents=1, num_beams=NB, scan_noise=False)
    ang = np.random.default_rng(3).permutation(E) * (2 * np.pi / E)
    poses = np.stack([RADIUS * np.cos(ang), RADIUS * np.sin(ang),
                      ang + np.pi / 2], 1)[:, None]
    poses = torch.as_tensor(poses, dtype=torch.float32)
    s, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01, device="cpu")
    return m, tables, params, cfg, s


def _leaves_equal(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in a.__dataclass_fields__)


@pytest.mark.parametrize("grid", GRIDS)
def test_order_moves_per_env_data_with_its_env(ring, grid):
    s = ring[-1]
    out, order = P.sort_envs_for_locality(s, return_order=True, **grid)
    assert order.dtype == torch.int64 and order.shape == (E,)
    assert torch.equal(torch.sort(order).values, torch.arange(E))
    assert not torch.equal(order, torch.arange(E))   # the sort moved envs
    # an env is known by its start pose: where each came out from
    start = torch.stack([s.start_xs[:, 0], s.start_ys[:, 0]], 1)
    came_from = torch.stack([
        torch.nonzero((start == torch.stack([x, y])).all(1))[0, 0]
        for x, y in zip(out.start_xs[:, 0], out.start_ys[:, 0])])
    ids = torch.arange(E)
    assert torch.equal(ids[order], came_from)
    assert _leaves_equal(out, s.map(lambda leaf: leaf[order]))


@pytest.mark.parametrize("grid", GRIDS)
def test_default_return_is_the_states(ring, grid):
    s = ring[-1]
    out = P.sort_envs_for_locality(s, **grid)
    assert isinstance(out, P.SimState)
    assert _leaves_equal(out, P.sort_envs_for_locality(
        s, return_order=True, **grid)[0])


def _sweep(ring, steps, sort_every=None, follow=True):
    """``steps`` planned steps of the ring's envs, each env with its own
    gains; with ``sort_every``, the locality sort before every such step,
    the gains following their envs unless ``follow`` is False. Returns the
    states and, for each slot, the env it holds."""
    m, tables, params, cfg, s = ring
    step = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                 reset_to_start=True, device="cpu")
    planner = PurePursuitPlanner(ring_waypoints(RADIUS), device="cpu")
    gains = (torch.linspace(0.3, 2.5, E)[:, None],
             torch.linspace(0.5, 1.5, E)[:, None])
    ids = torch.arange(E)
    for k in range(steps):
        if sort_every and k % sort_every == 0:
            s, order = P.sort_envs_for_locality(s, tile_size=1.0,
                                                origin=(-8.0, -8.0),
                                                return_order=True)
            ids = ids[order]
            if follow:
                gains = tuple(g[order] for g in gains)
        s = planner.fused_plan_step(step, *gains)(s)[0]
    return s, ids


def test_gains_follow_their_envs_across_sorts(ring):
    """Sorted with the gains following, every env ends where the unsorted
    run's does, bit for bit; left in their slots, the gains drive other
    envs."""
    plain, _ = _sweep(ring, 30)
    moved, ids = _sweep(ring, 30, sort_every=8)
    assert not torch.equal(ids, torch.arange(E))
    assert _leaves_equal(moved, plain.map(lambda leaf: leaf[ids]))
    assert (plain.x[:, 0, 3] > 0.5).all()   # the envs drive
    stuck, ids = _sweep(ring, 30, sort_every=8, follow=False)
    assert not torch.equal(stuck.x, plain.x[ids])
