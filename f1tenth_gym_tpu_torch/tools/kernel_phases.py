"""Per-phase cost of the scan kernel (K1) on the card.

Port of ``tools/kernel_phases.py``. Times the kernel on the headline
workload (PHASE_SCANS = 8192 racing scans of the bench sampler in
tile-snake order, BENCH_BEAMS = 1080 beams, example_map culled at
BENCH_CULL_TS = 1.25 m) under its phase mask:

  dirs            the scalars, the beam directions and each warp's sector
  dirs,sweep      + the row stream and hit tests (the main loop)
  dirs,sweep,out  + the epilogue (production)

The deltas are the phases' costs. Each time is a CUDA-graph time
(``common.kernel_ms``, PHASE_REPS = 30 launches a graph): the wrapper's
enqueue is of the kernel's own order. Before timing, each masked output,
``"dirs,out"`` too, is held bit for bit against its plain version
(``sweep_plain(w, phases)``). Prints the JAX probe's table and its
``kernel_phase_ms`` line. It times the CUDA kernel, so it needs the card:
on the CPU it raises.

    python -m f1tenth_gym_tpu_torch.tools.kernel_phases
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
from f1tenth_gym_tpu_torch.tools import common

TIMED = ("dirs", "dirs,sweep", "dirs,sweep,out")
CHECKED = TIMED + ("dirs,out",)


def check_phases(w) -> dict:
    """{mask: the masked kernel's output equals its plain version, bit for
    bit} for every mask; the launches count like any other."""
    out = {}
    for phases in CHECKED:
        k = sk.sweep(w, phases=phases)
        out[phases] = bool(torch.equal(k, sk.sweep_plain(w, phases)))
    return out


def phase_times(w, reps: int = 30) -> dict:
    """CUDA-graph ms of a launch under each timed mask, and the phases'
    costs from their differences (``phases``: dirs, sweep, out)."""
    ms = {p: common.kernel_ms(lambda p=p: sk.sweep(w, phases=p), reps)["ms"]
          for p in TIMED}
    return dict(ms=ms, phases=dict(
        dirs=ms["dirs"], sweep=ms["dirs,sweep"] - ms["dirs"],
        out=ms["dirs,sweep,out"] - ms["dirs,sweep"]))


def run(n_scans: int = 8192, num_beams: int = 1080, ts: float = 1.25,
        reps: int = 30, device=None) -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("kernel_phases times the CUDA scan kernel: it "
                           "needs the card")
    m, tables, poses = common.bench_workload(ts, n_scans // 2, num_beams, dev)
    w = sk.prepare_map(poses.reshape(-1, 3), m, tables, num_beams,
                       common.THETA_DIS)
    equal = check_phases(w)
    if not all(equal.values()):
        raise RuntimeError(f"masked kernel != plain version: {equal}")
    return dict(scans=n_scans, beams=num_beams, ts=ts, reps=reps,
                device=common.device_name(dev), bit_equal=equal,
                **phase_times(w, reps))


def main(argv=None):
    ap = argparse.ArgumentParser()
    common.device_arg(ap)
    args = ap.parse_args(argv)
    r = run(int(os.environ.get("PHASE_SCANS", 8192)),
            int(os.environ.get("BENCH_BEAMS", 1080)),
            float(os.environ.get("BENCH_CULL_TS", 1.25)),
            int(os.environ.get("PHASE_REPS", 30)), args.device)
    for p, v in r["ms"].items():
        print(f"# {p}: {v:.4f} ms", file=sys.stderr)
    total = r["ms"]["dirs,sweep,out"]
    print(f"| phase | ms @ {r['scans']} scans | share |")
    print("|---|---|---|")
    for name, key in (("dirs (+ launch, scalars, sector)", "dirs"),
                      ("row sweep", "sweep"), ("out (epilogue)", "out")):
        v = r["phases"][key]
        print(f"| {name} | {v:.4f} | {100 * v / total:.0f}% |")
    print(f"| **total kernel** | **{total:.4f}** | 100% |")
    print(json.dumps({"metric": "kernel_phase_ms", "value": total,
                      "unit": "ms", "phases": r["phases"],
                      "device": r["device"]}), flush=True)
    return r


if __name__ == "__main__":
    main()
