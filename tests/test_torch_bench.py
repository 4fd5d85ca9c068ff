"""PyTorch port: ``python -m f1tenth_gym_tpu_torch.bench`` on the CPU at a
tiny size (8 envs, 16 steps, 108 beams, the bench map as the one gate
map): its line has every key of ``bench.py``'s and its gate holds; the
weak-scaling ranks run for real over 1 and 2 gloo processes, and a failed
one raises.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_workers as W
from f1tenth_gym_tpu_torch import bench

KEYS = ("metric", "value", "unit", "vs_baseline", "scan_mse_by_map",
        "ittc_collision_gate", "weak_scaling_retention_8shard",
        "weak_scaling_total_rates")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_bench_line_on_cpu(monkeypatch, capsys):
    """The whole bench at a tiny size. Its weak-scaling counts (1, 2, 4
    and 8 ranks, as bench.py) are recorded and answered with fixed rates,
    so that the line's retention is checked without 15 processes; the
    ranks themselves run in test_weak_rates_over_two_ranks."""
    for k, v in dict(BENCH_DEVICE="cpu", BENCH_ENVS="8", BENCH_STEPS="16",
                     BENCH_BEAMS="108", BENCH_GATE_MAPS="",
                     BENCH_WEAK_ENVS_PER_DEVICE="8",
                     BENCH_WEAK_STEPS="4").items():
        monkeypatch.setenv(k, v)
    asked = []

    def fixed_rates(ranks, envs, steps):
        asked.append((tuple(ranks), envs, steps))
        return {n: 100.0 * n - n * n for n in ranks}

    monkeypatch.setattr(bench, "weak_rates", fixed_rates)
    result = bench.main()
    out, err = capsys.readouterr()
    line = out.strip().splitlines()[-1]
    assert line.startswith("{") and json.loads(line) == result
    assert all(k in result for k in KEYS), [k for k in KEYS
                                            if k not in result]
    assert result["metric"] == "env_steps_per_sec_per_chip"
    assert result["unit"] == "env-steps/s" and result["value"] > 0
    assert result["vs_baseline"] == result["value"] / 500.0
    assert set(result["scan_mse_by_map"]) == {"example_map"}
    assert result["scan_mse_by_map"]["example_map"] < 2.0
    assert result["ittc_collision_gate"] == "ok"
    assert asked == [((1, 2, 4, 8), 8, 4)]
    assert result["weak_scaling_total_rates"] == {
        "1": 99.0, "2": 196.0, "4": 384.0, "8": 736.0}
    assert result["weak_scaling_retention_8shard"] == 736.0 / 99.0
    assert "# envs=8 " in err and "device=cpu" in err


def test_weak_rates_over_two_ranks(capsys):
    """The weak-scaling ranks for real: 1 and 2 gloo processes of 8 envs,
    4 steps each; a count's rate is the sum of its ranks'."""
    rates = bench.weak_rates([1, 2], 8, 4, timeout_s=120.0)
    assert set(rates) == {1, 2} and all(r > 0 for r in rates.values())
    assert "# ranks=2:" in capsys.readouterr().err


def test_failed_weak_rank_raises():
    """Unlike bench.py:405-414, a failed weak-scaling child is not caught."""
    with pytest.raises(RuntimeError, match="on purpose"):
        bench.weak_rates([1], 8, 4, worker=W.failing_weak_child,
                         timeout_s=60.0)


def test_gap_follow_matches_bench_policy():
    """The policy of bench.py:297-310, written in jnp, on numpy-seeded
    scans of 108 and 1080 beams."""
    rng = np.random.default_rng(0)
    for B in (108, 1080):
        scans = rng.uniform(0.1, 30.0, (6, 2, B)).astype(np.float32)
        s = jnp.asarray(scans)
        lo, hi = 2 * B // 5, 3 * B // 5
        best = jnp.argmax(s[..., lo:hi], axis=-1) + lo
        angle = (best.astype(s.dtype) / (B - 1) - 0.5) * 4.7
        steer = jnp.clip(0.6 * angle, -0.4, 0.4)
        speed = jnp.clip(0.8 * s[..., lo:hi].min(-1), 1.0, 4.0)
        want = np.asarray(jnp.stack([steer, speed], axis=-1))
        got = bench.gap_follow(torch.as_tensor(scans)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
