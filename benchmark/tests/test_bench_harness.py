"""The benchmark's harness on the CPU: cells found by name, the seed, the
trace arithmetic, K1's counts, the import isolation, and the racing
check against its control and its faults."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import devtrace, generator, isolation, race, roofline, run, spec
from benchmark.reference import png, walls

from bench_small import SEED, correct, run_small

ROOT = spec.ROOT
EXAMPLE = os.path.join(spec.HERE, "configs", "example_map")
ORIGIN = (-78.21853769831466, -44.37590462453829, 0.0)


def test_cells_found_by_name():
    s = spec.load()
    for w in s["workloads"]:
        c = spec.cell(s, w["name"])
        assert c["config"]["name"] == w["config"]
        assert c["traffic"]["name"] == w["traffic"]
        assert c["end_to_end"] and c["per_layer"]
        assert "setup_s" in [m["name"] for m in c["end_to_end"]]
        for m in c["per_layer"]:
            assert callable(spec.reader(m["name"]))


def test_a_new_cell_is_files_only(tmp_path):
    """A cell with its own configuration, traffic mix and per-layer
    metric, added as new files beside a spec that names them."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = json.load(open(os.path.join(spec.HERE, "configs",
                                      "example_map_2car.json")))
    cfg["name"] = "dummy_cfg"
    (tmp_path / "dummy_cfg.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "dummy_mix.json").write_text(json.dumps(
        dict(kind="race", envs=8)))
    (tmp_path / "metrics" / "dummy.metric.py").write_text(
        "def read(rec):\n    return rec.get('x')\n")
    s = spec.load()
    s["configs"].append(dict(name="dummy_cfg", source="x",
                             file="dummy_cfg.json", reduced=[], why="x"))
    s["workloads"].append(dict(name="dummy-cell", config="dummy_cfg",
                               traffic="dummy_mix", chips=1, why="x"))
    s["per_layer"].append(dict(name="dummy.metric", unit="%",
                               better="higher", source="device_trace",
                               layer="kernels", moves="setup_s",
                               workloads=["dummy-cell"]))
    c = spec.cell(s, "dummy-cell", root=str(tmp_path), here=str(tmp_path))
    assert c["traffic"]["envs"] == 8 and c["config"]["name"] == "dummy_cfg"
    assert [m["name"] for m in c["per_layer"]] == ["dummy.metric"]
    assert spec.reader("dummy.metric", here=str(tmp_path))({"x": 3}) == 3
    out = dict(layer={"x": 3.0}, checks={"a": (0.0, 1.0)}, attempted=1,
               failed=0, end_to_end={"setup_s": 1.0})
    line = run.result_line(c, out, False, {})
    assert set(line["metrics"]) == {"setup_s"}


def test_seed_changes_poses_and_noise():
    free = png.free_space(EXAMPLE + ".png")
    sample = generator.uniform_sampler(free, 0.0625, ORIGIN, "cpu",
                                       component_seed=(0.7, 0.0),
                                       grouped=True, align_theta=True)
    a, b = generator.seeds(7), generator.seeds(2**31 + 7)
    assert a != b and a == generator.seeds(7)
    p1 = sample(generator.generator("cpu", a[0]), (64, 2))
    p2 = sample(generator.generator("cpu", a[0]), (64, 2))
    p3 = sample(generator.generator("cpu", b[0]), (64, 2))
    assert torch.equal(p1, p2) and not torch.equal(p1, p3)
    n1 = torch.randn(8, generator=generator.generator("cpu", a[1]))
    n3 = torch.randn(8, generator=generator.generator("cpu", b[1]))
    assert not torch.equal(n1, n3)
    # every start on a free cell farther than the clearance from a wall
    from scipy import ndimage
    dt = 0.0625 * ndimage.distance_transform_edt(free)
    c = ((p1[:, 0, 0] - ORIGIN[0]) / 0.0625).long()
    r = ((p1[:, 0, 1] - ORIGIN[1]) / 0.0625).long()
    assert (torch.as_tensor(dt)[r, c] > 0.6).all()


def test_idle_share_is_a_union_of_intervals():
    dev = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("Memcpy DtoD", 30.0, 40.0),
           ("k1", 35.0, 38.0)]
    host = [("race.step", 0.0, 50.0), ("aten::where", 21.0, 29.0)]
    assert devtrace.busy_seconds(dev) == pytest.approx(30e-6)
    rec = dict(kind="race", steps=2, busy_s=devtrace.busy_seconds(dev),
               window_s=50e-6, launches=3, k1_s=13e-6, k1_bound_s=1e-6)
    assert spec.reader("device_idle_share.race")(rec) == pytest.approx(0.4)
    assert spec.reader("launches_per_step.race")(rec) == 1.5
    assert devtrace.idle_gaps(dev, host) == [["aten::where", 10e-6]]
    assert devtrace.top_ops(dev)[0][0] == "k2"
    # nothing to read: no value, never a 0
    empty = dict(rec, busy_s=0.0, launches=0, k1_s=0.0)
    for name in ("device_idle_share.race", "launches_per_step.race",
                 "k1_roofline"):
        assert spec.reader(name)(empty) is None


def test_collect_leaves_out_host_ranges():
    """``record_function`` ranges drawn on the device's timeline are no
    device work."""
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType

    def ev(name, dev, s, e):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=s, end=e))

    prof = NS(events=lambda: [
        ev("race.step", DeviceType.CPU, 0, 100),
        ev("race.step", DeviceType.CUDA, 0, 100),
        ev("scan_sweep_kernel<7, 8>", DeviceType.CUDA, 10, 30),
        ev("aten::mul", DeviceType.CPU, 40, 45)])
    device, host = devtrace.collect(prof)
    assert device == [("scan_sweep_kernel<7, 8>", 10.0, 30.0)]
    assert devtrace.busy_seconds(device) == pytest.approx(20e-6)
    assert len(host) == 2


def test_p95_of_event_gaps():
    gaps = list(range(1, 101))
    assert race.p95(gaps) == 95
    assert race.p95([5.0]) == 5.0
    assert race.p95(list(range(20, 0, -1))) == 19
    clock = race.Clock(torch.device("cpu"))
    for _ in range(4):
        clock.mark()
    assert len(clock.gaps_ms()) == 3


def test_k1_counts_from_inputs():
    import f1tenth_gym_tpu_torch as P

    m = P.load_map(EXAMPLE + ".yaml", extract_segments=True, device="cpu")
    n_seg = int((m.segments[:, 0] < 1e6).sum())
    scans, beams = 2 * 16384, 1080
    assert roofline.k1_bytes(scans, beams, n_seg) == \
        4 * (scans * beams + 3 * scans + 8 * n_seg)
    assert roofline.k1_flops(scans, beams) == scans * beams * 32
    bound, by = roofline.k1_bound_s(scans, beams, n_seg)
    assert by == "bytes"
    assert bound == pytest.approx(roofline.k1_bytes(scans, beams, n_seg)
                                  / 3.35e12)
    rec = dict(kind="race", steps=4, k1_s=4 * 2 * bound, k1_bound_s=bound)
    assert spec.reader("k1_roofline")(rec) == pytest.approx(50.0)


def test_isolation_compares_whole_top_level_names():
    assert isolation.forbidden_loaded(
        {"f1tenth_gym_tpu_torch": 0, "f1tenth_gym_tpu_torch.ops": 0,
         "jaxtyping": 0, "flaxen": 0}) == []
    assert isolation.forbidden_loaded(
        {"f1tenth_gym_tpu.ops": 0, "jaxlib.xla": 0, "flax": 0}) == \
        ["f1tenth_gym_tpu", "flax", "jaxlib"]


def test_benchmark_and_port_load_no_jax():
    """A fresh process that imports every benchmark module and the port
    holds no forbidden module."""
    mods = ["benchmark." + f[:-3] for f in sorted(os.listdir(spec.HERE))
            if f.endswith(".py")] + [
        "benchmark.reference." + f[:-3] for f in sorted(os.listdir(
            os.path.join(spec.HERE, "reference"))) if f.endswith(".py")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import f1tenth_gym_tpu_torch.parallel\n"
            "from benchmark import isolation\n"
            "print(isolation.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "import benchmark.reference.step, benchmark.reference.walls\n"
            "print(sorted(m for m in sys.modules if m.startswith('f1tenth')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "race-example_map-16384", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_walls_of_example_map():
    import f1tenth_gym_tpu_torch as P

    m = P.load_map(EXAMPLE + ".yaml", extract_segments=True, device="cpu")
    free = png.free_space(EXAMPLE + ".png")
    segs = m.segments.numpy()
    sound = walls.wall_gap_cells(free, segs, 0.0625, ORIGIN, 1.5)
    assert 1.5 <= sound <= 1.51
    moved = segs.copy()
    moved[: len(moved) // 2, [0, 2]] += 0.02   # a third of a cell
    assert walls.wall_gap_cells(free, moved, 0.0625, ORIGIN, 1.5) > 1.51


def test_sound_run_reads_the_reference_bits():
    out = run_small()
    assert correct(out), out["checks"]
    for name in ("start_gap", "state_gap", "scan_gap_m"):
        assert out["checks"][name][0] == 0.0
    assert out["failed"] == 0 and out["attempted"] > 0


def test_bfloat16_control_is_not_correct():
    out = run_small(control=True)
    assert not correct(out)
    assert out["checks"]["scan_gap_m"][0] > 0.1
    assert out["failed"] > 0


def _unchanged(step):
    def wrapped(s, a):
        _, obs, r, done, info = step(s, a)
        return s, obs, r, done, info
    return wrapped


def _half_batch(step):
    def wrapped(s, a):
        new, obs, r, done, info = step(s, a)
        return _splice(new, s, s.num_envs // 2), obs, r, done, info
    return wrapped


def _splice(new, old, half):
    import dataclasses
    return dataclasses.replace(new, **{
        f.name: torch.cat([getattr(new, f.name)[:half],
                           getattr(old, f.name)[half:]])
        for f in dataclasses.fields(new)})


def _altered_scan(step):
    def wrapped(s, a):
        new, obs, r, done, info = step(s, a)
        scans = new.scans.clone()
        scans[..., scans.shape[-1] // 2] += 0.05
        return new.replace(scans=scans), obs, r, done, info
    return wrapped


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_scan],
                         ids=["state_unchanged", "half_batch",
                              "altered_scan"])
def test_faults_are_not_correct(fault):
    out = run_small(wrap_step=fault)
    assert not correct(out), out["checks"]
