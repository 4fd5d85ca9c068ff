"""The racing cells' lower-precision control at their own size, on the
card: the reference in bfloat16 in the program's place must come out not
correct on every seed, and the program itself correct.

    python3 -m pytest benchmark/tests -m card -s

(it prints every reading; about a minute a seed on an H100)."""

import time

import pytest

from benchmark import race, spec

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)
CELLS = ("race-example_map-16384", "race-dr16-16384")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(card, name):
    cell = spec.cell(spec.load(), name)
    for seed in SEEDS:
        for control in (False, True):
            out = race.run(cell, seed, 2.0, False, card, time.time(),
                           control=control)
            ok = all(v <= lim for v, lim in out["checks"].values())
            print(f"{name} seed={seed} control={control} correct={ok} "
                  f"checks={out['checks']}", flush=True)
            assert ok != control
