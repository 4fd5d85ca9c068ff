"""PyTorch port: the probes of f1tenth_gym_tpu_torch/tools, on the CPU.

The two host-only probes are held to the JAX package's (loaded from
``tools/`` by path): ``culling_stats.stats_for`` key for key on the same
poses, ``rect_tier_estimate`` to the two decimals the JAX probe prints.
The JAX step and kernel probes are not imported here: they set the JAX
kernel's layout knobs (``F1TENTH_PALLAS_EA``) when imported, which would
change the JAX kernel for later tests in the worker. The card probes run
with ``--device cpu`` at a tiny size, where the profile parser reads the
CPU ops; without ``--device cpu`` and without a card each raises.
"""

import contextlib
import importlib.util
import io
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f1tenth_gym_tpu_torch as P
from f1tenth_gym_tpu_torch.maps import map_path
from f1tenth_gym_tpu_torch.tools import (
    common,
    culling_stats,
    kernel_phases,
    kernel_sweep,
    ppo_profile,
    rect_tier_estimate,
    step_probe,
    step_trace,
    step_variants,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_PROBES = [
    (step_trace, ["single"]), (step_trace, ["multi", "--tracks", "2"]),
    (ppo_profile, []), (ppo_profile, ["--ranks", "2"]), (kernel_phases, []),
    (kernel_sweep, []), (step_probe, []), (step_variants, [])]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_tool(name, monkeypatch):
    """The JAX probe ``tools/<name>.py`` as a module, its import-time
    ``sys.path`` and environment edits undone after the test."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setenv("F1TENTH_TPU_CACHE", os.environ.get(
        "F1TENTH_TPU_CACHE", os.path.join(os.path.expanduser("~"), ".cache",
                                          "f1tenth_gym_tpu")))
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_bench_poses(md, envs):
    """The JAX sampler's bench poses (PRNGKey(7)), (envs, 2, 3) numpy."""
    from f1tenth_gym_tpu.parallel import uniform_pose_sampler

    sampler = uniform_pose_sampler(md, clearance=0.6,
                                   component_seed=(0.7, 0.0), grouped=True,
                                   align_theta=True)
    return np.asarray(sampler(jax.random.PRNGKey(7), (envs, 2)), np.float32)


def test_culling_stats_matches_jax(monkeypatch):
    """stats_for of both packages on example_map at 1.25 m, on the same
    512 poses (256 envs x 2, the JAX sampler's, in the JAX probe's
    tile-snake order): integer keys equal, float keys within 1e-12."""
    import f1tenth_gym_tpu as J
    from f1tenth_gym_tpu.maps import map_path as j_map_path
    from f1tenth_gym_tpu.parallel.vector import tile_snake_key

    jtool = _jax_tool("culling_stats", monkeypatch)
    jmd = J.load_map(j_map_path("example_map"), ".png", dtype=jnp.float32,
                     extract_segments=True, tile_culling=True,
                     culling_tile_size=1.25)
    pmd = P.load_map(map_path("example_map"), extract_segments=True,
                     tile_culling=True, culling_tile_size=1.25, device="cpu")
    poses = _jax_bench_poses(jmd, 256)
    tm = np.asarray(jmd.tile_meta)
    key = np.asarray(tile_snake_key(
        poses[:, :, 0].mean(1), poses[:, :, 1].mean(1),
        1.0 / float(tm[2]), (float(tm[0]), float(tm[1]))))
    flat = poses[np.argsort(key, kind="stable")].reshape(-1, 3)
    want = jtool.stats_for(jmd, flat)
    got = culling_stats.stats_for(pmd, flat)
    assert want["programs"] == 512 // jtool.EA
    assert got["blocks"] == 512 * 1   # 1080 beams: 9 chunks, one block
    assert set(got) == set(want) - {"programs"} | {"blocks"}
    for k, v in want.items():
        if k == "programs":
            continue
        if isinstance(v, float):
            assert abs(got[k] - v) <= 1e-12, (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)
    assert want["full"] < want["subgroups"]


def test_rect_tier_estimate_matches_jax(monkeypatch):
    """The port's estimate on the JAX sampler's poses gives the means the
    JAX probe's main() prints (BENCH_CULL_TS=0.85, BENCH_ENVS=256), to
    their two printed decimals."""
    import f1tenth_gym_tpu as J
    from f1tenth_gym_tpu.maps import map_path as j_map_path

    monkeypatch.setenv("BENCH_CULL_TS", "0.85")
    monkeypatch.setenv("BENCH_ENVS", "256")
    jtool = _jax_tool("rect_tier_estimate", monkeypatch)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jtool.main()
    printed = [float(x) for x in re.findall(r"mean ng = ([0-9.]+)",
                                            buf.getvalue())]
    assert len(printed) == 2, buf.getvalue()
    jmd = J.load_map(j_map_path("example_map"), ".png", dtype=jnp.float32,
                     extract_segments=True)
    pmd = P.load_map(map_path("example_map"), extract_segments=True,
                     device="cpu")
    got = rect_tier_estimate.estimate(pmd, _jax_bench_poses(jmd, 256), 0.85,
                                      jtool.SUB)
    assert [f"{got['square']:.2f}", f"{got['rect']:.2f}"] == \
        [f"{v:.2f}" for v in printed]
    assert got["subgroups"] == 512 // jtool.SUB


def test_rect_union_matches_jax(monkeypatch):
    jtool = _jax_tool("rect_tier_estimate", monkeypatch)
    rng = np.random.default_rng(5)
    for shape, wx, wy in (((7, 9, 5), 2, 1), ((7, 9, 5), 1, 2),
                          ((4, 3, 11), 2, 2), ((1, 6, 3), 3, 1)):
        v = rng.random(shape) < 0.2
        np.testing.assert_array_equal(rect_tier_estimate.rect_union(v, wx, wy),
                                      jtool.rect_union(v, wx, wy))


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_step_trace_on_cpu(monkeypatch, capsys, kind):
    monkeypatch.setenv("TRACE_ENVS", "16")
    monkeypatch.setenv("TRACE_STEPS", "2")
    r = step_trace.main([kind, "--device", "cpu", "--beams", "108",
                         "--tracks", "2"])
    # the port's spans, a step each, printed after the kernel table
    out = capsys.readouterr().out
    for name in ("vector.step", "env.step", "sim.opp_clip", "scan.k1",
                 "vector.reset"):
        assert r["spans"][name]["calls"] == 1.0 and f"  {name}\n" in out
    assert r["spans"]["vector.step"]["host_ms"] > 0
    # no kernels on the CPU; the clip's extent is its host time there
    assert all(v["kernel_ms"] == 0.0 for v in r["spans"].values())
    clip = r["spans"]["sim.opp_clip"]
    assert clip["extent_ms"] == pytest.approx(clip["host_ms"], rel=1e-12)
    assert r["spans"]["vector.step"]["extent_ms"] is None
    assert r["kind"] == kind and r["device"] == "cpu"
    assert r["timeline"] == "cpu ops" and r["by_name"]
    assert 0 < r["busy_share"] <= 1.0
    assert r["total_ms_per_step"] == pytest.approx(
        sum(v["ms_per_step"] for v in r["by_name"].values()))
    # no CUDA kernel on the CPU: the plain sweep runs, uncounted
    assert r["k1"] == dict(ms_per_step=0, calls_per_step=0)
    assert r["k1_wrapper_launches"] == 0
    # where K1's scans went, printed after the spans
    sw = r["scan_windows"]
    assert 0.0 <= sw["culled_subgroup_share"] <= 1.0
    assert sw["mean_swept_rows"] > 0
    assert "K1 subgroups on a culled window" in out


def test_ppo_profile_world1_on_cpu():
    r = ppo_profile.main(["--device", "cpu", "--envs", "32", "--iters", "1"])
    assert r["device"] == "cpu" and r["iterations"] == 1
    assert 0 < r["busy_share"] <= 1.0 and r["env_steps_per_s"] > 0
    assert any(k.startswith("aten::") for k in r["by_name"])


def test_ppo_profile_ranks_on_cpu():
    r = ppo_profile.main(["--device", "cpu", "--ranks", "2", "--envs", "32",
                          "--iters", "1"])
    assert r["metric"] == "ppo_collective_share_2rank_cpu"
    assert len(r["shares"]) == 2 and all(0 < s < 1 for s in r["shares"])
    assert r["value"] == pytest.approx(np.mean(r["shares"]))
    assert r["events"] and all(k.startswith(ppo_profile.COLLECTIVE_SPANS
                                            + ppo_profile.COLLECTIVE_OPS)
                               for k in r["events"])
    assert r["devices"] == ["cpu", "cpu"]


class _FakeAvg:
    def __init__(self, key, self_us, total_us):
        from torch.autograd import DeviceType

        self.key, self.device_type, self.count = key, DeviceType.CPU, 1
        self.self_cpu_time_total, self.cpu_time_total = self_us, total_us


class _FakeProf:
    def __init__(self, avgs, activities):
        self._avgs, self.activities = avgs, activities

    def key_averages(self):
        return self._avgs


def test_profile_parsers_refuse_empty_profiles():
    from torch.profiler import ProfilerActivity

    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        common.device_time_by_name(
            _FakeProf([_FakeAvg("aten::mul", 5.0, 5.0)],
                      {ProfilerActivity.CPU, ProfilerActivity.CUDA}), 1)
    with pytest.raises(RuntimeError, match="no collective"):
        ppo_profile.collective_share(
            _FakeProf([_FakeAvg("aten::mul", 5.0, 5.0)],
                      {ProfilerActivity.CPU}))
    # a work span counts with its span; a dispatcher op only without one
    r = ppo_profile.collective_share(_FakeProf(
        [_FakeAvg("aten::mul", 30.0, 30.0),
         _FakeAvg("c10d::allreduce_", 10.0, 10.0),
         _FakeAvg("gloo:all_reduce", 0.0, 60.0)], {ProfilerActivity.CPU}))
    assert r["events"] == {"gloo:all_reduce": 0.06}
    assert r["share"] == pytest.approx(60.0 / 100.0)
    r = ppo_profile.collective_share(_FakeProf(
        [_FakeAvg("aten::mul", 30.0, 30.0),
         _FakeAvg("c10d::allreduce_", 10.0, 10.0)], {ProfilerActivity.CPU}))
    assert r["share"] == pytest.approx(10.0 / 40.0)


def test_culling_stats_and_rect_tier_main(monkeypatch):
    monkeypatch.setenv("BENCH_CULL_TS", "1.25")
    monkeypatch.setenv("BENCH_ENVS", "64")
    s = culling_stats.main([])
    assert s["subgroups"] == 16 and s["blocks"] == 128
    assert s["w1"] + s["w2"] + s["w4"] + s["w8"] + s["full"] == 16
    r = rect_tier_estimate.main(["--sub", "4"])
    assert r["subgroups"] == 32 and r["rect"] <= r["square"]


def test_kernel_sweep_on_cpu(monkeypatch):
    monkeypatch.setenv("SWEEP", "9:128:1.25,16:64:1.25,5::1.25:4")
    monkeypatch.setenv("SWEEP_SKIP", "1,0")
    monkeypatch.setenv("SWEEP_SCANS", "64")
    monkeypatch.setenv("SWEEP_REPS", "1")
    monkeypatch.setenv("BENCH_BEAMS", "108")
    rows = kernel_sweep.main(["--device", "cpu"])
    assert [(r["warps"], r["chunk"], r["sub"], r["skip"]) for r in rows] == [
        (9, 128, 8, True), (9, 128, 8, False), (16, 64, 8, True),
        (16, 64, 8, False), (5, 128, 4, True), (5, 128, 4, False)]
    assert len({r["checksum"] for r in rows}) == 1
    assert all(r["beams_differing_from_default"] == 0 and r["plain_ms"] > 0
               and "kernel_ms" not in r for r in rows)


def test_kernel_sweep_divergence_exits_2():
    rows, outs, loads = kernel_sweep.sweep_rows(
        ["9:128:1.25", "16:64:1.25", "9:128:1.25:4"], n_scans=32,
        num_beams=108, reps=1, device="cpu")
    assert kernel_sweep.compare(rows, outs, loads, 108) == []
    bad = [o.clone() for o in outs]
    bad[1][3, 7] += 1e-3    # one beam of a row that must equal row 0
    with pytest.raises(SystemExit) as e:
        kernel_sweep.check(rows, bad, loads, 108)
    assert e.value.code == 2
    bad = [o.clone() for o in outs]
    bad[2][5, 9] -= 0.5     # another sub, nearer than the march: no leak
    problems = kernel_sweep.compare(rows, bad, loads, 108)
    assert len(problems) == 1 and "not all vertex leaks" in problems[0]
    with pytest.raises(SystemExit) as e:
        kernel_sweep.check(rows, bad, loads, 108)
    assert e.value.code == 2


def test_kernel_sweep_spec():
    assert kernel_sweep.parse_spec("9:128:1.25") == (9, 128, 1.25, 8)
    assert kernel_sweep.parse_spec(":64:0.85:2") == (9, 64, 0.85, 2)
    assert kernel_sweep.parse_spec("16::2.5:") == (16, 128, 2.5, 8)
    for bad in ("9:128", "9:128::4", "1:2:3:4:5"):
        with pytest.raises(ValueError):
            kernel_sweep.parse_spec(bad)


def test_step_probe_on_cpu(monkeypatch):
    monkeypatch.setenv("PROBE_ENVS", "16")
    r = step_probe.main(["--device", "cpu", "--beams", "108"])
    assert {"scan_ms", "overlay_ms", "step_ms"} <= set(r)
    assert not any(k.endswith("_event_ms") for k in r)
    assert r["SUB"] == 8 and r["envs"] == 16 and r["device"] == "cpu"
    monkeypatch.setenv("PROBE_WHAT", "overlay")
    r = step_probe.main(["--device", "cpu", "--beams", "108", "--sub", "4"])
    assert "overlay_ms" in r and "scan_ms" not in r and "step_ms" not in r


def test_step_variants_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("SV_ENVS", "16")
    monkeypatch.setenv("SV_STEPS", "1")
    r = step_variants.main(list(step_variants.KEYS) + ["--device", "cpu",
                                                       "--beams", "108"])
    assert set(r["variants"]) == set(step_variants.KEYS)
    assert all(v["ms"] > 0 and "event_ms" not in v
               for v in r["variants"].values())
    assert step_variants.SAME_STEP in capsys.readouterr().out


def test_step_variants_noise_rbg_exits():
    with pytest.raises(SystemExit, match="no counterpart"):
        step_variants.main(["xla/noise-rbg", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown key"):
        step_variants.main(["xla/nothing", "--device", "cpu"])


def test_kernel_phases_needs_the_card():
    with pytest.raises(RuntimeError, match="needs the card"):
        kernel_phases.main(["--device", "cpu"])


@pytest.mark.parametrize("mod,argv", CARD_PROBES,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}-{i}"
                              for i, (m, _) in enumerate(CARD_PROBES)])
def test_card_probes_raise_without_a_card(monkeypatch, mod, argv):
    """Without --device cpu a card probe asks for the card, and raises
    where there is none: no quiet fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for knob in ("TRACE_ENVS", "PROBE_ENVS", "SV_ENVS"):
        monkeypatch.setenv(knob, "16")
    monkeypatch.setenv("SWEEP_SCANS", "16")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
