"""The planner cell's runner (``benchmark/plan.py``) and its reference on
the CPU at a small size: correct on a sound run; ``plan_gap`` fails under
the bfloat16 control and when the gains stay in their slots at a sort; the
planner's metrics in a traced run; a port whose sort gives back no
permutation refused at once. On the card (``card``), both new cells at
their own size for three seeds:

    python3 -m pytest benchmark/tests/test_bench_plan.py -m card -s
"""

import time

import pytest

from benchmark import plan, race, run, spec

from plan_small import SEED, run_small, small_cell

SEEDS = (2**31 + 21, 2**31 + 22, 2**31 + 23)


def correct(out):
    return all(v <= lim for v, lim in out["checks"].values())


def test_small_plan_run_is_correct():
    out = run_small()
    assert correct(out), out["checks"]
    assert set(out["checks"]) == {"start_gap", "state_gap", "scan_gap_m",
                                  "wall_gap_cells", "plan_gap"}
    assert out["checks"]["plan_gap"][0] < 2e-4
    assert out["failed"] == 0 and out["judged"] > 0


@pytest.mark.parametrize("fault", ["control", "unfollowed"])
def test_plan_gap_fails_on_a_fault(fault):
    kw = dict(control=True) if fault == "control" else dict(follow=False)
    out = run_small(seed=SEED + 1, **kw)
    value, limit = out["checks"]["plan_gap"]
    assert value > limit
    assert out["failed"] > 0


def test_traced_plan_run_reports_the_planner_metrics():
    out = run_small(trace=True)
    rec = out["layer"]
    E = small_cell()["traffic"]["envs"]
    assert rec["kind"] == "race" and rec["plan"]["cars"] == E
    line = run.result_line(small_cell(), out, True, {})
    m = line["metrics"]
    assert m["plan_extent_ms.plan"]["value"] > 0
    assert 0 < m["plan_roofline.plan"]["value"] < 100
    assert "opp_clip_extent_ms.race" not in m
    assert {"step_host_ms.race", "scan_prep_host_ms.race"} <= set(m)


def test_plan_counts_from_inputs():
    cars, n = 16384, 783
    assert plan.plan_flops(cars, n) == cars * (782 * 19 + 783 * 31)
    assert plan.plan_bytes(cars, cars, n) == 4 * (cars * 5 + cars * 2
                                                  + 783 * 3)
    bound, by = plan.plan_bound_s(cars, cars, n)
    assert by == "operations"
    assert bound == pytest.approx(plan.plan_flops(cars, n) / 67e12)
    rec = dict(kind="race", steps=2, plan=dict(cars=cars, bound_s=bound))
    assert spec.reader("plan_roofline.plan")(dict(rec, plan=None)) is None


def test_a_sort_without_its_order_is_refused(monkeypatch):
    """The parent's port: the run stops before it builds anything."""
    import f1tenth_gym_tpu_torch as P

    def sort(states, tile_size=None, origin=(0.0, 0.0)):
        raise AssertionError("not reached")

    monkeypatch.setattr(P, "sort_envs_for_locality", sort)
    t = time.time()
    with pytest.raises(RuntimeError, match="permutation"):
        run_small()
    assert time.time() - t < 5.0


def test_config_states_the_yaml_sweep():
    cfg = spec.cell(spec.load(), "planner-pp-16384")["config"]
    w = plan.load_waypoints(cfg)
    assert w.shape == (783, 3)
    pc = cfg["planner"]
    assert pc["tlad_bounds"] == [0.2, 5.0] and pc["vgain_bounds"] == [0.5, 1.5]
    assert cfg["num_agents"] == 1
    g = plan.draw_gains(cfg, 4096, "cpu", 5)
    assert g[0].shape == (4096, 1)
    assert 0.2 <= float(g[0].min()) and float(g[0].max()) <= 5.0
    assert 0.5 <= float(g[1].min()) and float(g[1].max()) <= 1.5


@pytest.mark.card
@pytest.mark.parametrize("name", ["planner-pp-16384",
                                  "race-example_map-1car-16384"])
def test_new_cells_at_cell_size(card, name):
    """Every seed: the program correct; the bfloat16 control not; in the
    planner cell, gains left in their slots not."""
    cell = spec.cell(spec.load(), name)
    runner = plan if cell["traffic"]["kind"] == "plan" else race
    faults = [dict(control=True)]
    if runner is plan:
        faults.append(dict(follow=False))
    for seed in SEEDS:
        for kw in [{}] + faults:
            out = runner.run(cell, seed, 2.0, False, card, time.time(), **kw)
            ok = correct(out)
            print(f"{name} seed={seed} {kw} correct={ok} "
                  f"checks={out['checks']} {out['note']}", flush=True)
            assert ok == (not kw)
            if runner is plan and kw:
                value, limit = out["checks"]["plan_gap"]
                assert value > limit


def test_planner_reference_imports_nothing_of_the_program():
    import os
    import subprocess
    import sys

    code = ("import sys\n"
            "import benchmark.reference.pure_pursuit\n"
            "print(sorted(m for m in sys.modules if m.startswith('f1tenth')"
            " or m.split('.')[0] in ('jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         text=True, capture_output=True, check=True,
                         env=dict(os.environ))
    assert out.stdout.strip() == "[]"
