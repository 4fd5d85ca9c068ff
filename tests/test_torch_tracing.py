"""The port's spans (``utils/profiling.annotate``) in the racing step, their
table and ``span_summary``, and the benchmark's readers of that table, on
the CPU."""

import numpy as np
import pytest
import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.tracks.synthetic import ring_map_data, ring_start_poses
from f1tenth_gym_tpu_torch.utils import profiling
from f1tenth_gym_tpu_torch.utils.profiling import SpanRecord, SpanTable

E, A, NB = 4, 2, 64
# every span of a racing step (and the sort before it) with its parent
PARENTS = {
    "vector.step": None, "env.step": "vector.step",
    "sim.physics": "env.step", "sim.scan": "env.step",
    "scan.prepare": "sim.scan", "scan.select_windows": "scan.prepare",
    "scan.k1": "sim.scan", "sim.noise": "env.step",
    "sim.collision": "env.step", "sim.ittc": "env.step",
    "sim.opp_clip": "env.step", "env.laps": "env.step",
    "vector.reset": "vector.step", "vector.sort": None,
}
READERS = ("step_host_ms.race", "opp_clip_extent_ms.race",
           "scan_prep_host_ms.race")


@pytest.fixture(autouse=True)
def _empty_table():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def world():
    """A culled ring, E envs of A cars at its start, the kernel engine (its
    plain version on the CPU) with shared scan noise, as the racing cells
    run it."""
    m = ring_map_data(size=256, radius=4.0, extract_segments=True,
                      tile_culling=True, culling_tile_size=2.0, device="cpu")
    tables = P.make_scan_tables(num_beams=NB, device="cpu")
    params = P.VehicleParams.create(device="cpu")
    cfg = P.SimConfig(num_agents=A, num_beams=NB, scan_engine="kernel",
                      scan_noise=True, shared_agent_noise=True)
    poses = np.stack([ring_start_poses(A, 4.0)] * E)
    poses[1, :, 2] += 0.4
    poses[3, 1] = poses[3, 0] + [0.1, 0.0, 0.2]   # overlapping: resets
    return m, tables, params, cfg, torch.as_tensor(poses, dtype=torch.float32)


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _start(world, seed=3):
    """The reset envs, the auto-reset step and the actions."""
    m, tables, params, cfg, poses = world
    gen = P.make_generator("cpu", seed)
    s, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                          generator=gen, device="cpu")
    step = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                 reset_to_start=True, generator=gen,
                                 device="cpu")
    actions = torch.zeros((E, A, 2))
    actions[..., 0] = 0.1
    actions[..., 1] = 3.0
    return s, step, actions


def _drive(start, steps, sort_period=2):
    """``steps`` steps from ``_start``'s envs, sorting before every
    ``sort_period``-th; the states after each step."""
    s, step, actions = start
    out = []
    for i in range(steps):
        if i % sort_period == 0:
            s = P.sort_envs_for_locality(s, tile_size=2.0)
        s, *_ = step(s, actions)
        out.append(s)
    return out


def _race(world, steps, sort_period=2):
    """``_drive`` from a fresh reset, the reset unprofiled."""
    start = _start(world)
    with _cpu_profile() as prof:
        out = _drive(start, steps, sort_period)
    return out, prof


def test_no_profiler_records_nothing_and_makes_no_event(world, monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a span made a CUDA event")

    # as if CUDA were in use: a recording span would make events now
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    _drive(_start(world), 3)
    assert profiling.TABLE.records == [] and profiling.TABLE.dropped == 0
    assert profiling.annotate("sim.scan") is profiling.annotate("env.laps")


def test_outputs_bit_identical_with_spans_on_and_off(world):
    off = _drive(_start(world), 4)
    on, _ = _race(world, 4)
    assert len(profiling.TABLE.records) > 0
    for a, b in zip(off, on):
        for k in a.__dataclass_fields__:
            assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_a_racing_step_records_every_span(world):
    _, prof = _race(world, 3)
    recs = profiling.TABLE.records
    assert {r.name for r in recs} == set(PARENTS)
    for r in recs:
        assert r.parent == PARENTS[r.name], r.name
        assert r.host_end_ns >= r.host_start_ns
        assert r.start_event is None and r.end_event is None   # the CPU
        # only the clip records its extent: its host time on the CPU
        if r.name == "sim.opp_clip":
            assert r.extent_ms == (r.host_end_ns - r.host_start_ns) / 1e6
        else:
            assert r.extent_ms is None, r.name
    steps = [r for r in recs if r.name == "vector.step"]
    assert len(steps) == 3
    for st in steps:
        # one root a step: each stage once under it, the step its own root
        assert st.root == st.seq
        names = sorted(r.name for r in recs if r.root == st.seq)
        assert names == sorted(set(PARENTS) - {"vector.sort"})
    sorts = [r for r in recs if r.name == "vector.sort"]
    assert len(sorts) == 2 and all(r.root == r.seq for r in sorts)
    assert profiling.TABLE.stack == []
    keys = {e.key for e in prof.key_averages()}
    assert set(PARENTS) <= keys


def _rec(name, seq, parent, start, end, root=None, extent_ms=None):
    up = None if parent is None else parent.seq
    return SpanRecord(name, seq, None if parent is None else parent.name, up,
                      seq if parent is None else root, start, end,
                      extent_ms=extent_ms)


def test_span_summary_self_time_and_cut(monkeypatch):
    """Two steps; the first's children overlap each other, and closed
    spans come before their parents, as a table holds them."""
    table = SpanTable()
    monkeypatch.setattr(profiling, "TABLE", table)
    ms = 1_000_000
    s0 = _rec("vector.step", 0, None, 0, 10 * ms)
    s1 = _rec("vector.step", 4, None, 20 * ms, 26 * ms)
    sort = _rec("vector.sort", 3, None, 15 * ms, 18 * ms)
    table.records = [
        _rec("env.step", 1, s0, 1 * ms, 5 * ms, 0),
        _rec("env.laps", 2, s0, 4 * ms, 7 * ms, 0, 2.5),   # overlaps env.step
        s0, sort,
        _rec("env.step", 5, s1, 21 * ms, 25 * ms, 4),
        _rec("env.laps", 6, s1, 24 * ms, 25 * ms, 4, 1.0),
        s1,
    ]
    first = profiling.span_summary("vector.step", 1)
    assert first["vector.step"] == dict(calls=1, host_ms=10.0,
                                        host_self_ms=4.0,   # 10 - |[1, 7]|
                                        extent_ms=None)
    assert first["env.step"]["calls"] == 1 and "vector.sort" not in first
    assert first["env.laps"]["extent_ms"] == 2.5
    both = profiling.span_summary("vector.step", 2)
    assert both["vector.step"] == dict(calls=2, host_ms=16.0,
                                       host_self_ms=6.0, extent_ms=None)
    assert both["env.laps"]["extent_ms"] == 3.5
    assert both["vector.sort"]["host_self_ms"] == 3.0
    assert both["env.step"]["host_ms"] == 8.0
    # no first, or more than the table holds: every closed span
    assert profiling.span_summary("vector.step") == both
    assert profiling.span_summary("vector.step", 5) == both
    assert profiling.span_summary("env.step", 1) == both   # not a top span


def test_the_cap_counts_what_it_drops(monkeypatch):
    table = SpanTable(cap=3)
    monkeypatch.setattr(profiling, "TABLE", table)
    with _cpu_profile():
        for _ in range(2):
            with profiling.annotate("vector.step"):
                with profiling.annotate("env.step"):
                    pass
        with profiling.annotate("vector.sort"):
            pass
    assert [r.name for r in table.records] == ["env.step", "vector.step",
                                               "env.step"]
    assert table.dropped == 2
    profiling.TABLE.clear()
    assert table.records == [] and table.dropped == 0


class _FakeEvent:
    """A CUDA event on a host counter."""
    made = 0
    clock = iter(range(10 ** 9))

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t, self.waited = None, False

    def record(self, stream=None):
        self.t = next(_FakeEvent.clock)

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        assert end.waited
        return float(end.t - self.t)


def test_extent_spans_record_events_on_the_card(monkeypatch):
    """Once CUDA is in use a span opened with ``extent`` records an event
    at each end, and no other span makes one; ``span_summary`` waits for
    the events and turns them into the extent."""
    table = SpanTable()
    monkeypatch.setattr(profiling, "TABLE", table)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    with _cpu_profile():
        for _ in range(3):
            with profiling.annotate("vector.step"):
                with profiling.annotate("sim.physics"):
                    pass
                with profiling.annotate("sim.opp_clip", extent=True):
                    pass
    assert _FakeEvent.made == 6   # two a clip, none for the others
    clips = [r for r in table.records if r.name == "sim.opp_clip"]
    assert all(r.extent_ms is None and r.end_event is not None
               for r in clips)
    summary = profiling.span_summary("vector.step")
    assert summary["sim.opp_clip"]["extent_ms"] == 3.0   # a tick each
    assert summary["vector.step"]["extent_ms"] is None
    assert summary["sim.physics"]["extent_ms"] is None
    assert all(r.start_event is None and r.end_event is None
               for r in table.records)
    assert [r.extent_ms for r in clips] == [1.0] * 3


def test_a_span_that_raises_closes(monkeypatch):
    """An exception leaves the span through its exit: it is recorded,
    the stack is empty again and the next span is top level."""
    table = SpanTable()
    monkeypatch.setattr(profiling, "TABLE", table)
    with _cpu_profile():
        with pytest.raises(ValueError):
            with profiling.annotate("vector.step"):
                with profiling.annotate("env.step"):
                    raise ValueError("stage failed")
        with profiling.annotate("vector.sort"):
            pass
    assert [(r.name, r.parent) for r in table.records] == [
        ("env.step", "vector.step"), ("vector.step", None),
        ("vector.sort", None)]
    assert table.stack == [] and table.records[2].root == table.records[2].seq


def _reader(name):
    from benchmark import spec

    return spec.reader(name)


@pytest.mark.parametrize("name", READERS)
def test_span_readers_read_nothing_without_spans(world, name):
    read = _reader(name)
    assert read(dict(kind="race", steps=2)) is None      # empty table
    _race(world, 2)
    assert read(dict(kind="train", steps=2)) is None     # another kind
    assert read(dict(kind="race", steps=3)) is None      # fewer steps


def test_span_readers_read_the_first_stretch(world):
    """Two profiled stretches of 3 steps each, as ``benchmark/race.py``
    records them: the readers read the first, sorts before its steps
    included, from the raw records."""
    for _ in range(2):
        _race(world, 3, sort_period=2)
    recs = profiling.TABLE.records
    end = [i for i, r in enumerate(recs) if r.name == "vector.step"][2]
    first = recs[:end + 1]

    def ms(name):
        return [(r.host_end_ns - r.host_start_ns) / 1e6 for r in first
                if r.name == name]

    rec = dict(kind="race", steps=3)
    want = {"step_host_ms.race": np.mean(ms("vector.step")),
            "opp_clip_extent_ms.race": sum(ms("sim.opp_clip")) / 3,
            "scan_prep_host_ms.race": sum(ms("scan.prepare")) / 3}
    assert len(ms("vector.sort")) == 2 and len(ms("sim.opp_clip")) == 3
    for name, value in want.items():
        assert _reader(name)(rec) == pytest.approx(value, rel=1e-12), name
        assert value > 0


def test_step_graph_share_reads_the_counters(monkeypatch):
    """``step_graph_share.race``: replays over calls of the auto-reset
    steps, from the port's counters (a synthetic count)."""
    from f1tenth_gym_tpu_torch.parallel import vector

    read = _reader("step_graph_share.race")
    monkeypatch.setattr(vector.make_autoreset_step, "calls", 1600)
    monkeypatch.setattr(vector.make_autoreset_step, "replays", 1598)
    assert read(dict(kind="race", steps=32)) == 1598 / 1600
    assert read(dict(kind="train", steps=32)) is None


@pytest.mark.parametrize("gone", ["calls", "replays", "no_calls"])
def test_step_graph_share_reads_nothing_without_counters(monkeypatch, gone):
    """None where the port has no counters (a step without a graph) or
    made no step."""
    from f1tenth_gym_tpu_torch.parallel import vector

    f = vector.make_autoreset_step
    if gone == "no_calls":
        monkeypatch.setattr(f, "calls", 0)
    else:
        monkeypatch.delattr(f, gone)
    assert _reader("step_graph_share.race")(dict(kind="race", steps=32)) \
        is None


def test_k3_ms_reads_the_kernel_by_name():
    """``k3_ms.race``: K3's device seconds among the stretch's top device
    operations (a synthetic breakdown, names cut as the harness cuts
    them), in ms a step."""
    read = _reader("k3_ms.race")
    ops = [["void__anonymous_namespace_::scan_sweep_kernel_7__8__float", 0.0109],
           ["void__anonymous_namespace_::opp_clip_kernel_float__true__fl", 0.0048],
           ["void_at::native::elementwise_kernel_128__2__at::native::gpu", 0.0026]]
    rec = dict(kind="race", steps=32, breakdown=dict(device_ops=ops))
    assert read(rec) == pytest.approx(1e3 * 0.0048 / 32, rel=1e-12)


@pytest.mark.parametrize("rec", [
    dict(kind="race", steps=32, breakdown=dict(device_ops=[
        ["void_at::native::elementwise_kernel_128__2__at::native::gpu",
         0.01]])),                                       # no K3 among them
    dict(kind="race", steps=32, breakdown=dict(device_ops=[])),
    dict(kind="race", steps=0, breakdown=dict(device_ops=[
        ["void__anonymous_namespace_::opp_clip_kernel_float", 0.01]])),
    dict(kind="train", steps=32),
])
def test_k3_ms_reads_nothing_without_k3(rec):
    assert _reader("k3_ms.race")(rec) is None


# the planner's spans (planning/pure_pursuit.py) with their parents
PLAN_PARENTS = {"plan.step": None, "plan.nearest": "plan.step",
                "plan.lookahead": "plan.step", "plan.actuation": "plan.step"}


def _planned(world, steps, monkeypatch=None):
    """``steps`` steps of the ring world's envs under the batched pure
    pursuit, each env with its own gains, profiled on the CPU; with
    ``monkeypatch``, the planner's spans off. (profile, cars planned)."""
    from f1tenth_gym_tpu_torch.planning import PurePursuitPlanner
    from f1tenth_gym_tpu_torch.planning import pure_pursuit as pp
    from f1tenth_gym_tpu_torch.utils.waypoints import ring_waypoints

    if monkeypatch is not None:
        monkeypatch.setattr(pp, "annotate",
                            lambda name, extent=False: profiling._OFF)
    s, step, _ = _start(world)
    planner = PurePursuitPlanner(ring_waypoints(4.0), device="cpu")
    plan_step = planner.fused_plan_step(
        step, torch.linspace(0.5, 2.0, E)[:, None],
        torch.linspace(0.5, 1.5, E)[:, None])
    cars = pp.pure_pursuit_plan.cars
    with _cpu_profile() as prof:
        for _ in range(steps):
            s = plan_step(s)[0]
    return prof, pp.pure_pursuit_plan.cars - cars


def test_a_planned_step_records_the_planner_spans(world):
    _, cars = _planned(world, 3)
    assert cars == 3 * E * A
    recs = profiling.TABLE.records
    plan = [r for r in recs if r.name in PLAN_PARENTS]
    assert len(plan) == 3 * len(PLAN_PARENTS)
    for r in plan:
        assert r.parent == PLAN_PARENTS[r.name], r.name
        if r.name == "plan.step":   # top level, its extent its host time
            assert r.root == r.seq
            assert r.extent_ms == (r.host_end_ns - r.host_start_ns) / 1e6
        else:
            assert r.extent_ms is None
    summary = profiling.span_summary("vector.step", 3)
    for name in PLAN_PARENTS:
        assert summary[name]["calls"] == 3, name
    assert summary["plan.step"]["extent_ms"] > 0
    assert summary["vector.step"]["calls"] == 3


def test_the_planner_spans_add_no_op(world, monkeypatch):
    """The same planned steps with the planner's spans on and off run the
    same ops, each as often."""
    def ops(prof):
        spans = set(PARENTS) | set(PLAN_PARENTS)
        return {e.key: e.count for e in prof.key_averages()
                if e.key not in spans}

    on, _ = _planned(world, 2)
    assert {e.key for e in on.key_averages()} >= set(PLAN_PARENTS)
    profiling.clear_spans()
    off, _ = _planned(world, 2, monkeypatch)
    assert not {e.key for e in off.key_averages()} & set(PLAN_PARENTS)
    assert ops(on) == ops(off)


def test_the_plan_span_records_events_on_the_card(world, monkeypatch):
    """Once CUDA is in use ``plan.step`` records an event at each end, and
    the planner's other spans none."""
    from f1tenth_gym_tpu_torch.planning import pure_pursuit_plan
    from f1tenth_gym_tpu_torch.utils.waypoints import ring_waypoints

    table = SpanTable()
    monkeypatch.setattr(profiling, "TABLE", table)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    w = torch.as_tensor(ring_waypoints(4.0), dtype=torch.float32)
    x = torch.tensor([4.0, 0.0, 1.0])
    with _cpu_profile():
        for _ in range(2):
            pure_pursuit_plan(x, x.flip(0), x, w, 0.8, 1.0, 0.33)
    assert _FakeEvent.made == 4
    summary = profiling.span_summary("plan.step")
    assert summary["plan.step"]["calls"] == 2
    assert summary["plan.step"]["extent_ms"] is not None
    assert summary["plan.nearest"]["extent_ms"] is None
