"""PyTorch port: the learner's locality sort (``PPO(sort_fn=...)``), its
spans and its counters (parallel/ppo.py), on the CPU.

Without a sort, or with one that keeps the order, the learner is the one
it was, bit for bit; with the multi-track world's arc sort every rollout
starts from the sorted states; under a world-size-1 mesh the sort runs on
the rank's rows. With a profiler recording, every ``ppo.*`` span lands in
the span table under its parent and the counters count; with none, the
spans record nothing, make no CUDA event and change no bit.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.parallel import ppo as pppo
from f1tenth_gym_tpu_torch.parallel.sharding import make_mesh
from f1tenth_gym_tpu_torch.tracks.multi import (multi_track_locality_sort,
                                                multi_track_map_data,
                                                multi_track_pose_sampler)
from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data, ring_start_poses
from f1tenth_gym_tpu_torch.utils import profiling

E, A, NB = 8, 2, 64
PC = pppo.PPOConfig(obs_beams=16, hidden=32, rollout_steps=4, epochs=2,
                    minibatches=2)
# every span of an iteration with its parent; the step's own spans (the
# march engine's) sit under ``vector.step``
PARENTS = {
    "ppo.iteration": None, "ppo.sort": "ppo.iteration",
    "ppo.rollout": "ppo.iteration", "ppo.policy": "ppo.rollout",
    "vector.step": "ppo.rollout", "ppo.update": "ppo.iteration",
    "ppo.gae": "ppo.update", "ppo.minibatch": "ppo.update",
    "ppo.adam": "ppo.update",
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _empty_table():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def ring():
    m = ring_map_data(size=128, radius=2.0, device="cpu")
    cfg = P.SimConfig(num_agents=A, num_beams=NB, scan_engine="march",
                      scan_noise=True, shared_agent_noise=True)
    params = P.VehicleParams.create(device="cpu")
    tables = P.make_scan_tables(num_beams=NB, device="cpu")
    poses = np.stack([ring_start_poses(A, 2.0)] * E)
    poses[:, :, 2] += np.linspace(-0.3, 0.3, E)[:, None]
    s, *_ = P.batch_reset(torch.as_tensor(poses, dtype=torch.float32),
                          params, m, tables, cfg, 0.01,
                          generator=P.make_generator("cpu", 1), device="cpu")
    return m, cfg, params, tables, s


def _learner(ring, sort_fn=None, mesh=None):
    m, cfg, params, tables, s = ring
    step = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                 reset_to_start=True,
                                 generator=P.make_generator("cpu", 5),
                                 device="cpu")
    ppo = pppo.PPO(params, m, tables, cfg, 0.01, PC, step_fn=step,
                   device="cpu", mesh=mesh, sort_fn=sort_fn)
    return ppo, ppo.init(s, P.make_generator("cpu", 9))


def _state(ts, metrics):
    out = {f"net.{k}": v.detach() for k, v in ts.net.named_parameters()}
    out.update({f"env.{f.name}": getattr(ts.env_states, f.name)
                for f in dataclasses.fields(ts.env_states)})
    out.update({f"metric.{k}": v for k, v in metrics.items()})
    out["generator"] = ts.generator.get_state()
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _iterations(ppo, ts, n=2, run=None):
    for _ in range(n):
        ts, metrics = (run or ppo.train_step)(ts)
    return _state(ts, metrics)


def test_no_sort_and_identity_sort_are_the_unsorted_learner(ring):
    """``train_step`` without ``sort_fn``, and with a sort that keeps the
    order, equals the rollout-then-update learner bit for bit."""
    ppo, ts = _learner(ring)
    bare = _iterations(ppo, ts, run=lambda t: ppo.update(*ppo.rollout(t)))
    ppo, ts = _learner(ring)
    _assert_same(_iterations(ppo, ts), bare)
    ppo, ts = _learner(ring, sort_fn=lambda s: s)
    _assert_same(_iterations(ppo, ts), bare)


def test_sort_relabels_the_envs_before_each_rollout(ring):
    """A reversing sort: each rollout's first step sees the envs reversed,
    and the iteration equals one that reverses the envs by hand first."""
    def flip(s):
        return s.map(lambda leaf: leaf.flip(0))

    ppo, ts = _learner(ring)
    by_hand = _iterations(ppo, ts, run=lambda t: ppo.train_step(
        dataclasses.replace(t, env_states=flip(t.env_states))))
    ppo, ts = _learner(ring, sort_fn=flip)
    _assert_same(_iterations(ppo, ts), by_hand)


@pytest.fixture(scope="module")
def two_tracks():
    m, infos = multi_track_map_data(2, seed=11, tile_culling=False,
                                    device="cpu")
    return m, infos


def test_arc_sort_starts_every_rollout_from_the_sorted_states(two_tracks):
    m, infos = two_tracks
    cfg = P.SimConfig(num_agents=A, num_beams=NB, scan_engine="march")
    params = P.VehicleParams.create(device="cpu")
    tables = P.make_scan_tables(num_beams=NB, device="cpu")
    poses = multi_track_pose_sampler(infos, device="cpu")(
        P.make_generator("cpu", 7), (E, A))
    s, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                          device="cpu")
    s = s.map(lambda leaf: leaf.flip(0))   # out of order
    sort = multi_track_locality_sort(m, infos)
    step = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                 reset_to_start=True, device="cpu")
    seen = []

    def first_inputs(states, actions):
        if len(seen) % PC.rollout_steps == 0:
            seen.append(states)
        else:
            seen.append(None)
        return step(states, actions)

    ppo = pppo.PPO(params, m, tables, cfg, 0.01, PC, step_fn=first_inputs,
                   device="cpu", sort_fn=sort)
    ts = ppo.init(s, P.make_generator("cpu", 3))
    for it in range(2):
        want = sort(ts.env_states)
        ts, _ = ppo.train_step(ts)
        got = seen[it * PC.rollout_steps]
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name))
    # the sort moved the envs: the first rollout's states are a permutation
    x0 = seen[0].x[:, 0, :2]
    assert not torch.equal(x0, s.x[:, 0, :2])
    assert torch.equal(torch.sort(x0[:, 0]).values,
                       torch.sort(s.x[:, 0, 0]).values)


def test_sort_under_a_world_size_one_mesh(ring):
    """Each rank sorts its own rows: at world size 1, the whole batch,
    bit for bit the unsharded sorted learner."""
    def flip(s):
        return s.map(lambda leaf: leaf.flip(0))

    ppo, ts = _learner(ring, sort_fn=flip)
    want = _iterations(ppo, ts)
    assert not dist.is_initialized()
    try:
        ppo, ts = _learner(ring, sort_fn=flip, mesh=make_mesh(devices="cpu"))
        _assert_same(_iterations(ppo, ts), want)
    finally:
        dist.destroy_process_group()


def _profiled_iteration(ring, sort_fn):
    ppo, ts = _learner(ring, sort_fn=sort_fn)
    ts, _ = ppo.train_step(ts)
    before = dict(pppo.COUNTERS)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ts, metrics = ppo.train_step(ts)
    counts = {k: v - before[k] for k, v in pppo.COUNTERS.items()}
    return counts, _state(ts, metrics)


def test_spans_and_counters_of_an_iteration(ring):
    counts, _ = _profiled_iteration(ring, lambda s: s)
    recs = profiling.TABLE.records
    names = {r.name for r in recs}
    assert set(PARENTS) <= names
    for r in recs:
        if r.name in PARENTS:
            assert r.parent == PARENTS[r.name], r.name
    summary = profiling.span_summary("ppo.iteration", 1)
    n_mb = PC.epochs * PC.minibatches
    assert summary["ppo.iteration"]["calls"] == 1
    assert summary["ppo.sort"]["calls"] == 1
    assert summary["ppo.policy"]["calls"] == PC.rollout_steps
    assert summary["vector.step"]["calls"] == PC.rollout_steps
    assert summary["ppo.gae"]["calls"] == 1
    assert summary["ppo.minibatch"]["calls"] == n_mb
    assert summary["ppo.adam"]["calls"] == n_mb
    # the extents: on the CPU their host times, nested
    ext = {k: summary[k]["extent_ms"] for k in
           ("ppo.iteration", "ppo.rollout", "ppo.update")}
    assert 0 < ext["ppo.rollout"] + ext["ppo.update"] <= ext["ppo.iteration"]
    assert summary["ppo.policy"]["extent_ms"] is None
    assert counts == {"ppo.iterations": 1,
                      "ppo.rollout.steps": PC.rollout_steps,
                      "ppo.update.samples":
                          PC.epochs * PC.rollout_steps * E * A}


def test_no_sort_records_no_sort_span(ring):
    _profiled_iteration(ring, None)
    assert "ppo.sort" not in {r.name for r in profiling.TABLE.records}


def test_spans_off_record_nothing_and_change_no_bit(ring, monkeypatch):
    ppo, ts = _learner(ring, sort_fn=lambda s: s)
    ts, _ = ppo.train_step(ts)
    on = _profiled_iteration(ring, lambda s: s)[1]
    profiling.clear_spans()

    def no_event(*a, **k):
        raise AssertionError("a span made a CUDA event")

    # as if CUDA were in use: a recording span would make events now
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    before = pppo.COUNTERS["ppo.iterations"]
    ts, metrics = ppo.train_step(ts)
    assert profiling.TABLE.records == [] and profiling.TABLE.dropped == 0
    assert pppo.COUNTERS["ppo.iterations"] == before + 1
    _assert_same(_state(ts, metrics), on)
