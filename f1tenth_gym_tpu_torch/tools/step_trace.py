"""Device-time breakdown of a workload step under ``torch.profiler``.

Port of ``tools/step_trace.py``. Runs TRACE_STEPS steps of the chosen
workload under the profiler (CPU and CUDA activity on the card) and prints
the top 15 names by device ms a step, their total, the busy share (device
time over the profiled wall time) and the launches a step of K1 and K3,
found by their kernel names (``scan_sweep_kernel``, ``opp_clip_kernel``:
a ctypes launch has no profiler range of its own); then the port's spans
(``utils/profiling.annotate``) a step: calls, host ms, host self ms, the
card's time in the kernels each span launched (from the profile, its
child spans' kernels included) and, for spans that record it, the extent
on the card's timeline.

    python -m f1tenth_gym_tpu_torch.tools.step_trace single  # bench racing step
    python -m f1tenth_gym_tpu_torch.tools.step_trace multi   # 16-track domain-rand step

``single``: the main path's auto-reset step, TRACE_ENVS (4096) envs x 2
agents x 1080 beams on example_map culled at 1.25 m, the poses in
tile-snake order, the JAX probe's actions (steer 0, 2 m/s). ``multi``: the
world of ``examples/domain_randomization.py`` (``--tracks`` 16 of seed
``--seed`` 0, 2.5 m tiles) with its sampler's poses after the arc sort and
the same actions; its culling pack is read from the pack cache
(``F1TENTH_TORCH_CACHE``) when a run has built it. Knobs: TRACE_ENVS,
TRACE_STEPS (8); ``--beams`` (1080) and ``--device`` (default: the card).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.tools import common
from f1tenth_gym_tpu_torch.utils import profiling


def build_single(envs: int, num_beams: int, device=None):
    """(step, states, map) of the bench racing step."""
    m, tables, poses = common.bench_workload(1.25, envs, num_beams, device)
    states, step, _ = common.racing_step(m, tables, poses)
    return step, states, m


def build_multi(envs: int, num_beams: int, tracks: int = 16, seed: int = 0,
                device=None):
    """(step, states, map) of the domain-randomization world's step."""
    from f1tenth_gym_tpu_torch.examples import domain_randomization as dr

    world = dr.make_world(tracks, envs, 2, num_beams, seed, device)
    actions = torch.zeros((envs, 2, 2), device=world.map_data.device)
    actions[..., 1] = 2.0

    def step(s):
        return world.step(s, actions)[0]

    return step, world.sort(world.states), world.map_data


def trace(kind: str = "single", envs: int = 4096, steps: int = 8,
          num_beams: int = 1080, tracks: int = 16, seed: int = 0,
          device=None) -> dict:
    """Profile ``steps`` steps of workload ``kind``; returns
    ``common.device_time_by_name``'s dict with ``k1`` and ``k3`` (K1's
    and K3's ms and launches a step, from the profile),
    ``k1_wrapper_launches`` and ``k3_wrapper_launches`` (the wrappers'
    counts over the profiled steps) and ``spans`` (the port's
    spans a step: {name: {calls, host_ms, host_self_ms, extent_ms,
    kernel_ms}})."""
    from f1tenth_gym_tpu_torch.ops import opp_clip_kernel as oc
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    dev = resolve_device(device)
    if kind == "single":
        step, s, _ = build_single(envs, num_beams, dev)
    elif kind == "multi":
        step, s, _ = build_multi(envs, num_beams, tracks, seed, dev)
    else:
        raise ValueError(f"unknown workload {kind!r}: 'single' or 'multi'")
    s = step(s)   # warm-up
    common.sync(dev)
    box = [s]

    def one():
        box[0] = step(box[0])

    before, before_k3 = sk.sweep.launches, oc.opp_clip.launches
    profiling.clear_spans()
    prof = common.profile(one, steps, dev)
    t = common.device_time_by_name(prof, steps)
    spans = {name: {k: None if v is None else v / steps
                    for k, v in d.items()}
             for name, d in profiling.span_summary("vector.step").items()}
    for name, ms in span_kernel_ms(prof, spans).items():
        spans[name]["kernel_ms"] = ms / steps
    # the profiler links the ctypes launches of K1 and K3 to no range:
    # each one's time, found by name, goes to the span that launches it
    # and the spans around that
    k1 = common.named(t["by_name"], common.K1_NAME)
    k3 = common.named(t["by_name"], common.K3_NAME)
    up = {r.name: r.parent for r in profiling.TABLE.records}
    for name, k in (("scan.k1", k1), ("sim.opp_clip", k3)):
        while name in spans:
            spans[name]["kernel_ms"] += k["ms_per_step"]
            name = up[name]
    return dict(kind=kind, envs=envs, agents=2, beams=num_beams, steps=steps,
                device=common.device_name(dev), **t,
                k1=k1, k3=k3,
                k1_wrapper_launches=sk.sweep.launches - before,
                k3_wrapper_launches=oc.opp_clip.launches - before_k3,
                spans=spans)


def span_kernel_ms(prof, names) -> dict:
    """{span: ms of the card's work in the kernels it launched}, summed
    over the profile: the device time the profiler gives the span's host
    range, which holds its child spans' and ops' kernels (0 on the CPU)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if e.key in names and e.device_type == DeviceType.CPU:
            us = getattr(e, "device_time_total", None)
            out[e.key] = (us if us is not None
                          else getattr(e, "cuda_time_total", 0)) / 1e3
    return out


def print_spans(spans: dict):
    """The span table a step, largest host time first: calls, host ms,
    host self ms, kernel ms and extent ms ("-" where not recorded)."""
    def ms(v):
        return "         -" if v is None else f"{v:10.3f}"

    print("  calls/step   host ms  self ms  kernel ms  extent ms  span",
          flush=True)
    for name, v in sorted(spans.items(), key=lambda kv: -kv[1]["host_ms"]):
        print(f"  {v['calls']:10.2f} {v['host_ms']:9.3f} "
              f"{v['host_self_ms']:8.3f} {ms(v.get('kernel_ms'))} "
              f"{ms(v['extent_ms'])}  {name}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", nargs="?", default="single",
                    choices=("single", "multi"))
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--tracks", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    common.device_arg(ap)
    args = ap.parse_args(argv)
    r = trace(args.kind, int(os.environ.get("TRACE_ENVS", 4096)),
              int(os.environ.get("TRACE_STEPS", 8)), args.beams, args.tracks,
              args.seed, args.device)
    common.print_top(f"{args.kind}: {r['steps']} steps on {r['device']}", r)
    print_spans(r["spans"])
    print(json.dumps({k: v for k, v in r.items()
                      if k not in ("by_name", "spans")}), flush=True)
    return r


if __name__ == "__main__":
    main()
