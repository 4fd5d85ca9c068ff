"""Cost of the full env step beside its kernels, on the card.

Port of ``tools/step_probe.py``. On the bench workload (PROBE_ENVS = 4096
envs x 2 agents x 1080 beams, example_map culled at BENCH_CULL_TS = 1.25
m, tile-snake order) it times:

  scan     the scan kernel (K1) alone, through ``scan_pallas`` on the
           8192 scans
  overlay  the overlay kernel (K2) alone, through ``overlay_opponents``,
           each scan clipped by the other agent's box (O = 1)
  step     the full auto-reset step (steer 0, 2 m/s)

each as the JAX probe does (host clock over fenced reps: 20, and 30 for
the step; ``<what>_ms``), with the CUDA-event time of the same reps beside
it on the card (``<what>_event_ms``). PROBE_WHAT (a comma list) restricts
the set; ``--sub`` sets K1's subgroup size (the JAX probe's
``F1TENTH_PALLAS_SUB``), ``--device`` the device (default: the card).

    python -m f1tenth_gym_tpu_torch.tools.step_probe
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
from f1tenth_gym_tpu_torch.tools import common


def _time(res, name, fn, reps, dev):
    res[f"{name}_ms"] = common.fenced_ms(fn, reps, dev)
    if dev.type == "cuda":
        res[f"{name}_event_ms"] = common.cuda_ms(fn, reps)


def probe(envs: int = 4096, ts: float = 1.25,
          what=("scan", "overlay", "step"), num_beams: int = 1080,
          sub: int = sk.SUB, device=None) -> dict:
    """The probe's times (module docstring) and the kernel wrappers'
    launches in them (``k1_launches``, ``k2_launches``; a replay of the
    step's CUDA graph calls no wrapper)."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.ops import overlay_kernel as ok

    dev = resolve_device(device)
    m, tables, poses = common.bench_workload(ts, envs, num_beams, dev)
    flat = poses.reshape(-1, 3)
    res = dict(SUB=sub, ts=ts, envs=envs, beams=num_beams,
               device=common.device_name(dev))
    k1, k2 = sk.sweep.launches, ok.overlay.launches
    if "scan" in what:
        kw = dict(tile_tables=m.tile_tables, tile_ngroups=m.tile_ngroups,
                  tile_meta=m.tile_meta, tile_blockmap=m.tile_blockmap,
                  tile_ext=m.tile_ext, elig_raster=m.cull_eligible,
                  elig_meta=sk.elig_meta(m), sub=sub)
        _time(res, "scan", lambda: sk.scan_pallas(
            flat, m.seg_table, tables, num_beams, common.THETA_DIS, **kw),
            20, dev)
    if "overlay" in what:
        params = P.VehicleParams.create(device=dev)
        scans = torch.full((envs, 2, num_beams), 10.0, device=dev)
        opp = common.other_agent_boxes(poses, params)
        _time(res, "overlay", lambda: ok.overlay_opponents(
            scans, poses, opp, tables, num_beams, device=dev), 20, dev)
    if "step" in what:
        states, step, _ = common.racing_step(m, tables, poses)
        _time(res, "step", lambda: step(states), 30, dev)
    res.update(k1_launches=sk.sweep.launches - k1,
               k2_launches=ok.overlay.launches - k2)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--sub", type=int, default=sk.SUB)
    common.device_arg(ap)
    args = ap.parse_args(argv)
    what = tuple(filter(None, os.environ.get(
        "PROBE_WHAT", "scan,overlay,step").split(",")))
    r = probe(int(os.environ.get("PROBE_ENVS", 4096)),
              float(os.environ.get("BENCH_CULL_TS", 1.25)), what, args.beams,
              args.sub, args.device)
    print(json.dumps(r), flush=True)
    return r


if __name__ == "__main__":
    main()
