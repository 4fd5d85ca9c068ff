"""Sweep of the scan kernel's launch knobs in one process.

Port of ``tools/kernel_sweep.py``. Times the scan kernel (K1, every
phase, culled tables) on the bench workload for a list of configurations
``warps:chunk:ts[:sub]`` (SWEEP; an empty field takes its default: 9
warps a block, 128 beams a warp, the tile size is required, 8 scans a
subgroup), each with the row skip on and off as SWEEP_SKIP lists (1, 0).
The JAX probe's knobs were EA and SUB: EA (scans per Pallas program) has
no counterpart here, where a launch is one block per (scan, group of beam
chunks); warps and chunk take its place. The map and the poses are made
once per tile size, the kernel's inputs once per (tile size, sub).

Each row reports the kernel's CUDA-graph ms (``kernel_ms``; on the CPU
the plain version's host-clock ms, ``plain_ms``), scans a second, the
seconds to make its inputs (``build_s``) and of its first launch
(``first_launch_s``), and a checksum. At one tile size, warps, chunk and
the skip change neither the pack nor any scan's rows, and the max is
exact: rows that share a tile size and ``sub`` must agree bit for bit
(their outputs are compared, not only the checksums; ``chunk`` moves every
warp's sector, so this tests the row skip). ``sub`` changes the window a
scan sweeps, so a row of another ``sub`` may part from the default's only
on vertex leaks (``common.vertex_leaks``), on at most LEAK_CAP of the
beams; where culled equals full (example_map at 1.25 m) it may not part at
all. A divergence exits 2, as in the JAX probe.

    SWEEP="9:128:1.25,16:64:1.25:4" SWEEP_SKIP=1,0 \\
        python -m f1tenth_gym_tpu_torch.tools.kernel_sweep

Knobs: SWEEP, SWEEP_SKIP, SWEEP_SCANS (8192), SWEEP_REPS (30), SWEEP_MAP
(example_map), SWEEP_CAP (96, the pack's split cap), BENCH_BEAMS (1080);
``--device`` (default: the card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
from f1tenth_gym_tpu_torch.tools import common

DEFAULT_WARPS = 9
DEFAULT_SWEEP = "9:128:1.25,16:128:1.25"


def parse_spec(spec: str):
    """``warps:chunk:ts[:sub]`` -> (warps, chunk, ts, sub)."""
    parts = spec.strip().split(":")
    if len(parts) not in (3, 4) or not parts[2]:
        raise ValueError(f"sweep row {spec!r}: need warps:chunk:ts[:sub]")
    warps = int(parts[0]) if parts[0] else DEFAULT_WARPS
    chunk = int(parts[1]) if parts[1] else sk.CHUNK
    sub = int(parts[3]) if len(parts) == 4 and parts[3] else sk.SUB
    return warps, chunk, float(parts[2]), sub


def sweep_rows(specs, skips=(True,), n_scans: int = 8192,
               num_beams: int = 1080, reps: int = 30,
               map_name: str = "example_map", cap: int = 96, device=None):
    """Time every (spec, skip). Returns (rows, outputs, workloads): the
    rows' dicts, each row's (n_scans, B) output, and {ts: (map, tables,
    poses (n_scans, 3))}."""
    dev = resolve_device(device)
    loads, inputs, rows, outs = {}, {}, [], []
    for spec in specs:
        warps, chunk, ts, sub = parse_spec(spec)
        if ts not in loads:
            m, tables, poses = common.bench_workload(
                ts, n_scans // 2, num_beams, dev, map_name, cap)
            loads[ts] = (m, tables, poses.reshape(-1, 3))
        m, tables, flat = loads[ts]
        t0 = time.perf_counter()
        if (ts, sub) not in inputs:
            inputs[ts, sub] = sk.prepare_map(flat, m, tables, num_beams,
                                             common.THETA_DIS, sub=sub)
            common.sync(dev)
        build_s = time.perf_counter() - t0
        w = inputs[ts, sub]
        for skip in skips:
            def fn(w=w, chunk=chunk, warps=warps, skip=skip):
                return sk.sweep(w, chunk=chunk, warps=warps, skip=skip)

            t0 = time.perf_counter()
            out = fn()[:flat.shape[0]]
            common.sync(dev)
            first_s = time.perf_counter() - t0
            if dev.type == "cuda":
                timing = {"kernel_ms": common.kernel_ms(fn, reps)["ms"]}
            else:
                timing = {"plain_ms": common.fenced_ms(fn, reps, dev)}
            ms = next(iter(timing.values()))
            rows.append(dict(warps=warps, chunk=chunk, ts=ts, sub=sub,
                             skip=bool(skip), **timing,
                             scans_per_s=flat.shape[0] / ms * 1e3,
                             build_s=build_s, first_launch_s=first_s,
                             checksum=float(out.double().sum())))
            outs.append(out)
            build_s = 0.0
            print(f"# warps={warps} chunk={chunk} ts={ts} sub={sub} "
                  f"skip={int(skip)}: {ms:.4f} ms "
                  f"({rows[-1]['scans_per_s']:,.0f} scans/s)",
                  file=sys.stderr, flush=True)
    return rows, outs, loads


def compare(rows, outs, loads, num_beams: int = 1080):
    """Hold the rows to each other (module docstring): each row gets
    ``beams_differing_from_default``, its beams that differ from the first
    row of its tile size at the default ``sub`` (or at the first ``sub``
    swept there). Returns the divergences found, as messages."""
    problems, first, base = [], {}, {}
    for i, r in enumerate(rows):
        first.setdefault((r["ts"], r["sub"]), i)
        b = base.get(r["ts"])
        if b is None or (rows[b]["sub"] != sk.SUB and r["sub"] == sk.SUB):
            base[r["ts"]] = i
    for i, r in enumerate(rows):
        j = first[r["ts"], r["sub"]]
        if not torch.equal(outs[i], outs[j]):
            n = int((outs[i] != outs[j]).sum())
            problems.append(f"checksum divergence at ts={r['ts']} "
                            f"sub={r['sub']}: row {i} parts from row {j} on "
                            f"{n} beams")
        b = base[r["ts"]]
        m, tables, flat = loads[r["ts"]]
        n, leaks = common.vertex_leaks(m, flat, outs[i], outs[b], tables,
                                       num_beams)
        r["beams_differing_from_default"] = n
        if rows[b]["sub"] != r["sub"] and (
                not leaks or n > common.LEAK_CAP * outs[i].numel()):
            problems.append(f"ts={r['ts']} sub={r['sub']}: {n} beams part "
                            f"from sub={rows[b]['sub']} "
                            + ("(over the leak cap)" if leaks
                               else "(not all vertex leaks)"))
    return problems


def check(rows, outs, loads, num_beams: int = 1080):
    """``compare``, exiting 2 on a divergence (the JAX probe's exit)."""
    problems = compare(rows, outs, loads, num_beams)
    for p in problems:
        print(f"# WARNING: {p}: the knobs changed kernel RESULTS "
              "(correctness regression)", file=sys.stderr, flush=True)
    if problems:
        raise SystemExit(2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    common.device_arg(ap)
    args = ap.parse_args(argv)
    env = os.environ.get
    beams = int(env("BENCH_BEAMS", 1080))
    skips = [s.strip() == "1" for s in env("SWEEP_SKIP", "1").split(",")]
    rows, outs, loads = sweep_rows(
        env("SWEEP", DEFAULT_SWEEP).split(","), skips,
        int(env("SWEEP_SCANS", 8192)), beams, int(env("SWEEP_REPS", 30)),
        env("SWEEP_MAP", "example_map"), int(env("SWEEP_CAP", 96)),
        args.device)
    check(rows, outs, loads, beams)
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
