"""The planner cell at a size the CPU runs in seconds: example_map_1car
with 108 beams and no culling pack, 16 envs, a sort every 4 steps. Not
collected (no ``test_`` prefix)."""

import copy
import time

from benchmark import plan, spec

SEED = 2**31 + 4321   # larger than 32 signed bits hold


def small_cell():
    cell = copy.deepcopy(spec.cell(spec.load(), "planner-pp-16384"))
    cell["config"].update(num_beams=108, culling_tile_size=None,
                          sort_period=4)
    cell["traffic"].update(envs=16, warmup_sort_periods=1, trace_steps=4,
                           check=dict(sample_envs=6, first_steps=8))
    return cell


def run_small(seed=SEED, trace=False, **kw):
    return plan.run(small_cell(), seed, 0.0, trace, "cpu", time.time(), **kw)
