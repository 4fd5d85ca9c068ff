"""The auto-reset step as a CUDA graph (``parallel/vector.py``:
``make_autoreset_step``, ``StepGraph``, ``OutputCopy``).

On the CPU the step stays eager and equals ``step.eager`` bit for bit; the
leaves a replay does not copy in (``UNREAD_LEAVES``) are shown unread; the
output copy gives fresh memory with the views kept; and the graph's
bookkeeping (first call eager, second captures, later ones replay, a
capture deferred while a profiler records, the wrappers' launch counters
left still by a replay, the generator) runs with a stand-in for ``torch.cuda.CUDAGraph`` that reruns
the body. The card tests (marker ``card``) hold the replayed step to
``step.eager`` bit for bit, the generator's state included, and skip
without CUDA. The card's machine has no JAX, which this folder's
``conftest.py`` imports: there run ``python3 -m pytest --noconftest -p
no:cacheprovider tests/test_torch_step_graph.py -m card``.
"""

import numpy as np
import pytest
import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.ops import opp_clip_kernel as oc
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
from f1tenth_gym_tpu_torch.parallel import vector
from f1tenth_gym_tpu_torch.tracks.synthetic import (ring_map_data,
                                                     ring_start_poses)

E, A, NB = 6, 2, 64
needs_card = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA card; this machine has "
                                       "none")


def same_bits(a, b) -> bool:
    if not isinstance(a, torch.Tensor):
        return a == b
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                            b.reshape(-1).contiguous().view(torch.uint8)))


def assert_same_outputs(got, want):
    """Every leaf of the states, the obs, reward, done and info."""
    g_s, g_obs, g_r, g_d, g_info = got
    w_s, w_obs, w_r, w_d, w_info = want
    for k in w_s.__dataclass_fields__:
        assert same_bits(getattr(g_s, k), getattr(w_s, k)), k
    assert g_obs.keys() == w_obs.keys()
    for k in w_obs:
        assert same_bits(g_obs[k], w_obs[k]), k
    assert same_bits(g_r, w_r) and same_bits(g_d, w_d)
    assert g_info.keys() == w_info.keys()
    for k in w_info:
        assert same_bits(g_info[k], w_info[k]), k


def clone_outputs(out):
    s, obs, reward, done, info = out
    return (s.map(torch.clone),
            {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in obs.items()},
            reward.clone(), done.clone(),
            {k: v.clone() for k, v in info.items()})


def counts():
    f = P.make_autoreset_step
    return f.calls, f.replays, f.captures


def launch_counts():
    """The kernel wrappers' own counts of K1's and K3's launches."""
    return sk.sweep.launches, oc.opp_clip.launches


# ---------------------------------------------------------------- the CPU

@pytest.fixture(scope="module")
def ring():
    """A culled ring, E envs of A cars at its start (one pair overlapping,
    so that it resets), the kernel engine (its plain version on the CPU)
    with shared scan noise, as the racing cells run it."""
    m = ring_map_data(size=256, radius=4.0, extract_segments=True,
                      tile_culling=True, culling_tile_size=2.0, device="cpu")
    tables = P.make_scan_tables(num_beams=NB, device="cpu")
    params = P.VehicleParams.create(device="cpu")
    cfg = P.SimConfig(num_agents=A, num_beams=NB, scan_engine="kernel",
                      scan_noise=True, shared_agent_noise=True)
    poses = np.stack([ring_start_poses(A, 4.0)] * E)
    poses[1, :, 2] += 0.4
    poses[3, 1] = poses[3, 0] + [0.1, 0.0, 0.2]
    return m, tables, params, cfg, torch.as_tensor(poses, dtype=torch.float32)


MODES = ("reset_to_start", "pose_sampler", "reset_poses")


def _start(ring, mode="reset_to_start", seed=3):
    """(reset states, auto-reset step, actions) on the ring."""
    m, tables, params, cfg, poses = ring
    gen = P.make_generator("cpu", seed)
    s, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                          generator=gen, device="cpu")
    kw = {"reset_to_start": dict(reset_to_start=True),
          "pose_sampler": dict(pose_sampler=P.uniform_pose_sampler(m)),
          "reset_poses": dict(reset_poses=poses)}[mode]
    step = P.make_autoreset_step(params, m, tables, cfg, 0.01, generator=gen,
                                 device="cpu", **kw)
    actions = torch.zeros((E, A, 2))
    actions[..., 0] = 0.1
    actions[..., 1] = 3.0
    return s, step, actions


def _finish_some(s, k):
    """A copy of ``s`` in which every third env from ``k`` has finished its
    laps, so that the next step resets it."""
    s = s.map(torch.clone)
    s.toggle_list[k % 3::3] = 4.0
    return s


@pytest.mark.parametrize("mode", MODES)
def test_cpu_step_is_eager(ring, mode):
    """On the CPU every call runs ``step.eager``: the same bits, the
    generator left where the eager step leaves it, no capture, no
    replay."""
    s, step, a = _start(ring, mode)
    gen = step.generator
    c0, r0, k0 = counts()
    for i in range(4):
        s = _finish_some(s, i)
        g0 = gen.get_state()
        want = step.eager(s, a)
        g1 = gen.get_state()
        gen.set_state(g0)
        got = step(s, a)
        assert torch.equal(gen.get_state(), g1)
        assert_same_outputs(got, want)
        s = got[0]
    assert counts() == (c0 + 4, r0, k0)


@pytest.mark.parametrize("mode", MODES)
def test_unread_leaves_are_not_read(ring, mode):
    """The leaves a replay does not copy into the graph: the step writes
    each anew from the other leaves, so garbage in them changes no output
    bit (the scans are new from the scan engine, the collision flags and
    partners from the boxes and iTTC, the lap counts from the toggles)."""
    assert vector.UNREAD_LEAVES == ("scans", "collisions", "collision_idx",
                                    "lap_counts")
    s, step, a = _start(ring, mode)
    gen = step.generator
    for i in range(3):
        s = _finish_some(s, i)
        junk = s.map(torch.clone)
        for k in vector.UNREAD_LEAVES:
            getattr(junk, k).fill_(float("nan"))
        g0 = gen.get_state()
        want = step.eager(s, a)
        gen.set_state(g0)
        got = step.eager(junk, a)
        assert_same_outputs(got, want)
        s = want[0]


@pytest.mark.parametrize("own_copy", [1 << 24, 64])
def test_output_copy_is_fresh_and_keeps_views(monkeypatch, own_copy):
    """Both ways of copying: all in one multi-tensor copy, and the larger
    memories (here the 96 bytes of ``base``) each by a copy of its own;
    leaves that are not tensors kept."""
    monkeypatch.setattr(vector, "_OWN_COPY", own_copy)
    base = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    scalar = torch.tensor(0.5)
    leaves = P.SimState.__dataclass_fields__
    tree = (P.SimState(**{k: torch.full((2,), i, dtype=torch.int32)
                          for i, k in enumerate(leaves)}),
            {"a": base[..., 0], "b": base[:, 1], "n": 3,
             "flags": torch.tensor([True, False]), "none": None},
            scalar.expand(5), (base,))
    copy = vector.OutputCopy(tree)
    first = copy()
    states, obs, r, (b,) = first
    assert obs["n"] == 3 and obs["none"] is None and same_bits(b, base)
    assert same_bits(r, scalar.expand(5))
    assert same_bits(obs["a"], base[..., 0])
    assert same_bits(obs["b"], base[:, 1])
    assert same_bits(obs["flags"], tree[1]["flags"])
    assert obs["a"].stride() == (12, 4) and r.stride() == (0,)
    # the views of one memory still share it, away from the source's
    mem = obs["a"].untyped_storage().data_ptr()
    assert mem == b.untyped_storage().data_ptr()
    assert b.data_ptr() != base.data_ptr()
    for k in leaves:
        assert same_bits(getattr(states, k), getattr(tree[0], k)), k
    base += 100.0
    second = copy()
    assert same_bits(second[3][0], base)
    assert same_bits(b, torch.arange(24, dtype=torch.float32).reshape(2, 3, 4))
    assert second[1]["a"].data_ptr() != obs["a"].data_ptr()


class FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: the capture
    runs the body once, as a capture records its kernels (the generators
    put back, the wrappers' launch counters moved as a capture moves
    them); each replay runs it again on the same inputs and writes its
    results over the capture's outputs, as a graph writes its fixed
    memory, with the launch counters left still, as a replay runs no
    Python."""

    def __init__(self):
        self.generators = []

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        launches = launch_counts()
        fresh, _ = vector._flatten(self.fn())
        sk.sweep.launches, oc.opp_clip.launches = launches
        for old, new in zip(self.outputs, fresh):
            if (isinstance(old, torch.Tensor)
                    and 0 not in old.stride()):   # expanded: no fixed memory
                old.copy_(new)


def fake_capture(graph, fn):
    states = [g.get_state() for g in graph.generators]
    out = fn()
    for g, st in zip(graph.generators, states):
        g.set_state(st)
    graph.fn, (graph.outputs, _) = fn, vector._flatten(out)
    return out


@pytest.fixture
def fake_graphs(monkeypatch):
    """The graph path on CPU tensors, with ``FakeGraph``; the plain scan
    and clip count as launches, as their kernels do on the card."""
    monkeypatch.setattr(vector, "_graphable", lambda s, a: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(vector, "_capture", fake_capture)
    for mod, name, counter in ((sk, "sweep_plain", sk.sweep),
                               (oc, "opp_clip_plain", oc.opp_clip)):
        # put back after the test, which other files' tests read
        monkeypatch.setattr(counter, "launches", counter.launches)
        real = getattr(mod, name)

        def counted(*args, _real=real, _counter=counter):
            _counter.launches += 1
            return _real(*args)

        monkeypatch.setattr(mod, name, counted)


@pytest.mark.parametrize("mode", MODES)
def test_graph_bookkeeping(ring, fake_graphs, mode):
    """First call eager, second captures and replays, later ones replay:
    each the eager step's bits and generator state, outputs that the next
    call leaves alone; the wrappers' launch counters move in the eager
    call and at the capture, and stand still in a replay."""
    s, step, a = _start(ring, mode)
    gen = step.generator
    c0, r0, k0 = counts()
    kept = None
    for i in range(6):
        s = _finish_some(s, i)
        g0 = gen.get_state()
        want = step.eager(s, a)
        g1 = gen.get_state()
        gen.set_state(g0)
        k1, k3 = launch_counts()
        got = step(s, a)
        moved = int(i < 2)   # the eager call, the capture
        assert launch_counts() == (k1 + moved, k3 + moved), i
        assert torch.equal(gen.get_state(), g1), i
        assert_same_outputs(got, want)
        if kept is not None:   # the previous call's outputs, untouched
            assert_same_outputs(*kept)
        kept = (got, clone_outputs(got))
        s = got[0]
    assert counts() == (c0 + 6, r0 + 5, k0 + 1)
    # the obs stay views of their step's memory, as in the eager step
    obs = kept[0][1]
    assert obs["poses_x"].untyped_storage().data_ptr() == \
        obs["poses_y"].untyped_storage().data_ptr()
    # a replay does not read the leaves it does not copy in
    for k in vector.UNREAD_LEAVES:
        getattr(s, k).fill_(float("nan"))
    g0 = gen.get_state()
    got = step(s, a)
    gen.set_state(g0)
    assert_same_outputs(got, step.eager(s, a))


def test_a_new_signature_captures_its_own_graph(ring, fake_graphs):
    s, step, a = _start(ring)
    half = s.map(lambda t: t[:3].clone())
    c0, r0, k0 = counts()
    for _ in range(3):
        step(s, a)
    for _ in range(3):
        step(half, a[:3])
    # actions of another layout: the same signature, a replay (the inputs
    # are copied in, whatever their layout), the same bits
    other = a.transpose(0, 1).contiguous().transpose(0, 1)
    assert not other.is_contiguous()
    gen = step.generator
    g0 = gen.get_state()
    want = step.eager(s, a)
    gen.set_state(g0)
    assert_same_outputs(step(s, other), want)
    assert counts() == (c0 + 7, r0 + 5, k0 + 2)


@pytest.mark.parametrize("change, same", [
    (lambda t: t.t().contiguous().t(), True),   # layout: copied in
    (lambda t: t[:1], False),                   # shape
    (lambda t: t.double(), False),              # dtype
])
def test_signature_is_shape_dtype_and_device(ring, change, same):
    """A graph is keyed on each input's shape, dtype and device: a call
    whose actions differ only in layout replays the same graph."""
    s, _, a = _start(ring)
    a2 = a.reshape(E, A * 2)
    key = vector._signature(s, a2)
    assert (vector._signature(s, change(a2)) == key) is same


def test_inputs_that_require_grad_run_eager(ring, monkeypatch):
    """The real rule on the inputs: CPU tensors, or any input that
    requires grad, keep the step eager."""
    s, step, a = _start(ring)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    assert vector._graphable(s, a)
    assert not vector._graphable(s, a.clone().requires_grad_(True))
    grad = s.map(torch.clone)
    grad.x.requires_grad_(True)
    assert not vector._graphable(grad, a)


def test_a_profiled_call_defers_the_capture(ring, fake_graphs):
    s, step, a = _start(ring)
    c0, r0, k0 = counts()
    step(s, a)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(s, a)
    assert counts() == (c0 + 2, r0, k0)
    step(s, a)
    assert counts() == (c0 + 3, r0 + 1, k0 + 1)


def test_the_march_stays_eager(ring, fake_graphs):
    """The march syncs the host to stop: no graph can hold it."""
    m, tables, params, cfg, poses = ring
    cfg = P.SimConfig(num_agents=A, num_beams=NB, scan_engine="march")
    s, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01, device="cpu")
    step = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                 reset_to_start=True, device="cpu")
    c0, r0, k0 = counts()
    for _ in range(3):
        s = step(s, torch.zeros((E, A, 2)))[0]
    assert counts() == (c0 + 3, r0, k0)


# ---------------------------------------------------------------- the card

CARD_ENVS, CARD_STEPS, SORT_PERIOD = 4096, 48, 16


def _card_world(kind):
    """(states, step, sort, actions(states, i)) at CARD_ENVS x 2 x 1080."""
    dev = torch.device("cuda")
    if kind == "example_map":
        from f1tenth_gym_tpu_torch.tools import common

        m, tables, poses = common.bench_workload(1.25, CARD_ENVS, 1080, dev)
        cfg = P.SimConfig(num_agents=2, num_beams=1080, dtype="float32",
                          scan_engine="kernel", scan_noise=True,
                          shared_agent_noise=True)
        params = P.VehicleParams.create(device=dev)
        gen = P.make_generator(dev, 5)
        s, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                              generator=gen, device=dev)
        step = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                     reset_to_start=True, generator=gen,
                                     device=dev)
        tm = m.tile_meta_host

        def sort(s):
            return P.sort_envs_for_locality(s, tile_size=1.0 / tm[2],
                                            origin=(tm[0], tm[1]))
    else:
        from f1tenth_gym_tpu_torch.examples import domain_randomization as dr

        world = dr.make_world(2, CARD_ENVS, 2, 1080, 0, dev)
        s, step, sort = world.states, world.step, world.sort
    from f1tenth_gym_tpu_torch.examples.domain_randomization import policy

    def actions(s, i):   # gap follow, faster on odd steps: walls get hit
        a = policy(s.scans)
        a[..., 1] *= 1.0 + 2.0 * (i % 2)
        return a

    return s, step, sort, actions


@pytest.mark.card
@needs_card
@pytest.mark.parametrize("kind", ["example_map", "composed"])
def test_replay_matches_eager_on_card(kind):
    """CARD_STEPS steps, a sort every SORT_PERIOD and forced resets: the
    replayed step and ``step.eager`` from the same states and generator
    state give the same bits, and leave the generator in the same state."""
    s, step, sort, actions = _card_world(kind)
    gen = step.generator
    for i in range(2):   # the eager call, then the capture
        s = step(s, actions(s, i))[0]
    c0, r0, k0 = counts()
    launches = launch_counts()
    resets = 0
    for i in range(CARD_STEPS):
        if i % SORT_PERIOD == 0:
            s = sort(s)
        s = _finish_some(s, i) if i % 5 == 0 else s
        a = actions(s, i)
        g0 = gen.get_state()
        want = step.eager(s, a)
        g1 = gen.get_state()
        gen.set_state(g0)
        got = step(s, a)
        assert torch.equal(gen.get_state(), g1), i
        assert_same_outputs(got, want)
        resets += int(got[3].sum())
        s = got[0]
    torch.cuda.synchronize()
    assert resets > CARD_ENVS // 3   # the forced ones and the walls'
    assert counts() == (c0 + CARD_STEPS, r0 + CARD_STEPS, k0)
    # the eager steps' launches alone: a replay calls no wrapper
    assert launch_counts() == (launches[0] + CARD_STEPS,
                               launches[1] + CARD_STEPS)


@pytest.mark.card
@needs_card
def test_graph_behaviour_on_card():
    """Outputs the next call leaves alone; a rewound generator replays the
    same noise; a new shape captures a new graph; inputs that require grad
    run eagerly; one launch of K1 and of K3 and none of K2 a replayed step,
    counted by kernel name in a trace of the card, while the wrappers'
    counters stand still; the counters add up."""
    from f1tenth_gym_tpu_torch.tools import common
    from f1tenth_gym_tpu_torch.utils.cuda_build import K1, K2, K3

    s, step, _, actions = _card_world("example_map")
    gen = step.generator
    a = actions(s, 0)
    c0, r0, k0 = counts()
    first = step(s, a)                  # eager
    out = step(first[0], a)             # capture and replay
    assert counts() == (c0 + 2, r0 + 1, k0 + 1)
    kept = out[0].map(torch.clone), out[1]["scans"].clone(), out[3].clone()
    launches = launch_counts()
    g0 = gen.get_state()
    nxt, on_card = common.card_launches(lambda: step(out[0], a))   # replay
    assert on_card == {K1.trace_name: 1, K2.trace_name: 0, K3.trace_name: 1}
    assert launch_counts() == launches
    for k in kept[0].__dataclass_fields__:
        assert same_bits(getattr(out[0], k), getattr(kept[0], k)), k
    assert same_bits(out[1]["scans"], kept[1]) and same_bits(out[3], kept[2])
    assert nxt[0].x.data_ptr() != out[0].x.data_ptr()
    gen.set_state(g0)
    again = step(out[0], a)             # the same noise from the same state
    assert_same_outputs(again, nxt)
    assert not same_bits(nxt[0].scans, out[0].scans)
    # another shape: its own eager call, then its own capture
    half = out[0].map(lambda t: t[:CARD_ENVS // 2].clone())
    for _ in range(3):
        step(half, a[:CARD_ENVS // 2])
    # inputs that require grad: eager
    graded = a.clone().requires_grad_(True)
    step(out[0], graded)
    torch.cuda.synchronize()
    assert counts() == (c0 + 8, r0 + 5, k0 + 2)
