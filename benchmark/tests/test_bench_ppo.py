"""The learner cell's runner (``benchmark/ppo.py``) and its reference on the
CPU at a small size: correct on a sound run, every learner check failed by
the bfloat16 control, the learner's metrics in a traced run, the update's
least work counted from its samples, and a port whose learner cannot sort
refused at once. On the card (``card``), the cell at its own size: the
program, its bfloat16 control and a TF32 program on the calibration seeds,
every reading printed:

    python3 -m pytest benchmark/tests/test_bench_ppo.py -m card -s
"""

import json
import os
import time

import pytest

from benchmark import ppo, run, spec

from ppo_small import SEED, run_small, small_cell

LEARNER = ("rollout_gap", "loss_gap", "grad_gap", "adam_gap", "metric_gap")
# the limits' calibration seeds: larger than 32 signed bits hold
SEEDS = tuple(2**31 + 1900 + k for k in range(12))


def correct(out):
    return all(v <= lim for v, lim in out["checks"].values())


def test_small_ppo_run_is_correct():
    out = run_small(report_control=True)
    assert correct(out), out["checks"]
    assert set(out["checks"]) == {"start_gap", "state_gap", "scan_gap_m",
                                  "wall_gap_cells", *LEARNER}
    for name in ("start_gap", "state_gap", "scan_gap_m"):
        assert out["checks"][name][0] == 0.0
    assert out["failed"] == 0 and out["judged"] > 0
    lim = small_cell()["traffic"]["limits"]
    for name in LEARNER:
        assert out["control_checks"][name] > lim[name], name
    e2e = out["end_to_end"]
    assert e2e["env_steps_per_s"] > 0 and e2e["step_ms_p95"] > 0


def test_bfloat16_control_is_not_correct():
    out = run_small(seed=SEED + 1, control=True)
    assert not correct(out)
    for name in LEARNER + ("scan_gap_m",):
        value, limit = out["checks"][name]
        assert value > limit, name
    assert out["failed"] > 0


def test_traced_ppo_run_reports_the_learner_metrics():
    out = run_small(trace=True)
    rec = out["layer"]
    cell = small_cell()
    lc, tr = cell["config"]["learner"], cell["traffic"]
    assert rec["kind"] == "race" and rec["steps"] == lc["rollout_steps"]
    counts = rec["ppo"]["counters"]
    assert counts == {
        "ppo.iterations": 1, "ppo.rollout.steps": lc["rollout_steps"],
        "ppo.update.samples": lc["epochs"] * lc["rollout_steps"]
        * tr["envs"] * cell["config"]["num_agents"]}
    m = run.result_line(cell, out, True, {})["metrics"]
    assert m["update_ms.ppo"]["value"] > 0
    assert 0 < m["update_share.ppo"]["value"] < 1
    assert 0 < m["update_roofline.ppo"]["value"] < 100
    # the racing cells' span readers do not apply to this cell
    assert not {"step_host_ms.race", "plan_extent_ms.plan"} & set(m)


def test_update_counts_from_samples():
    samples = 16 * 65536
    assert ppo.update_flops(samples, 66, 256, 2) == \
        samples * 3 * 2 * (66 * 256 + 256 * 256 + 256 * 2 + 256)
    assert ppo.update_bytes(samples, 66, 2) == 4 * samples * 71
    bound, by = ppo.update_bound_s(samples, 66, 256, 2)
    assert by == "operations"
    assert bound == pytest.approx(7.81e-3, rel=1e-3)
    rec = dict(ppo=dict(counters={"ppo.update.samples": samples,
                                  "ppo.iterations": 1},
                        update_bound_s=bound,
                        spans={"ppo.update": dict(calls=1, extent_ms=15.62),
                               "ppo.iteration": dict(calls=1,
                                                     extent_ms=62.48)}))
    assert spec.reader("update_ms.ppo")(rec) == pytest.approx(15.62)
    assert spec.reader("update_share.ppo")(rec) == pytest.approx(0.25)
    assert spec.reader("update_roofline.ppo")(rec) == pytest.approx(50.0,
                                                                   rel=1e-3)
    # nothing to read: no value, never a 0
    for name in ("update_ms.ppo", "update_share.ppo", "update_roofline.ppo"):
        assert spec.reader(name)(dict(kind="race")) is None


def test_a_learner_without_sort_is_refused_at_once(monkeypatch):
    """The parent's port: the run stops before it builds anything."""
    from f1tenth_gym_tpu_torch.parallel import ppo as pppo

    class Unsorted(pppo.PPO):
        def __init__(self, params, map_data, tables, cfg, timestep,
                     ppo_cfg=pppo.PPOConfig(), step_fn=None, device=None,
                     mesh=None):
            raise AssertionError("not reached")

    monkeypatch.setattr(pppo, "PPO", Unsorted)
    t = time.time()
    with pytest.raises(RuntimeError, match="sort_fn"):
        run_small()
    assert time.time() - t < 5.0


def test_config_is_dr16_with_the_learner():
    s = spec.load()
    cell = spec.cell(s, "dr16-ppo-4096")
    cfg, base = cell["config"], spec.cell(s, "race-dr16-16384")["config"]
    for key in ("world", "num_agents", "num_beams", "timestep", "dtype",
                "scan_engine", "culling_tile_size", "sort", "sort_period",
                "vehicle_params", "pose_sampler"):
        assert cfg[key] == base[key], key
    lc = cfg["learner"]
    assert (lc["obs_beams"], lc["obs_dim"], lc["hidden"], lc["act_dim"]) == \
        (64, 66, 256, 2)
    assert (lc["rollout_steps"], lc["epochs"], lc["minibatches"]) == (32, 4, 4)
    assert cell["chips"] == 1 and cell["traffic"]["envs"] == 4096
    assert [m["name"] for m in cell["per_layer"]][-3:] == [
        "update_ms.ppo", "update_share.ppo", "update_roofline.ppo"]


@pytest.mark.card
def test_cell_at_its_size_on_the_calibration_seeds(card):
    """Every seed: the program correct, the bfloat16 control failing every
    learner check; a TF32 program's readings printed beside them, one JSON
    line a run, and appended to the file ``$PPO_CALIBRATION_JSONL`` names,
    when set."""
    cell = spec.cell(spec.load(), "dr16-ppo-4096")
    lim = cell["traffic"]["limits"]
    path = os.environ.get("PPO_CALIBRATION_JSONL")
    bad = []
    for seed in SEEDS:
        for tf32 in (False, True):
            out = ppo.run(cell, seed, 0.0, False, card, time.time(),
                          report_control=not tf32, tf32=tf32)
            line = dict(seed=seed, tf32=tf32, correct=correct(out),
                        checks=out["checks"],
                        control=out.get("control_checks"), note=out["note"])
            print(json.dumps(line), flush=True)
            if path:
                with open(path, "a") as f:
                    f.write(json.dumps(line) + "\n")
            if not tf32:
                if not correct(out):
                    bad.append((seed, "program"))
                if any(out["control_checks"][k] <= lim[k] for k in LEARNER):
                    bad.append((seed, "control"))
    assert not bad, bad
