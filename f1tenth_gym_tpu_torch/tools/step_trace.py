"""Device-time breakdown of a workload step under ``torch.profiler``.

Port of ``tools/step_trace.py``. Runs TRACE_STEPS steps of the chosen
workload under the profiler (CPU and CUDA activity on the card) and prints
the top 15 names by device ms a step, their total, the busy share (device
time over the profiled wall time) and the time and launches a step of each
hand-written kernel the step launches (K1 and K3), found by its
declaration's kernel name (``utils/cuda_build.KERNELS``: a ctypes launch
has no profiler range of its own); then the port's spans
(``utils/profiling.annotate``) a step: calls, host ms, host self ms, the
card's time in the kernels each span launched (from the profile, its
child spans' kernels included) and, for spans that record it, the extent
on the card's timeline. After the profile it prints where K1's scans
went at the traced stretch's last states (outside the profile: no launch
or sync is added to the steps): the share of its 8-scan subgroups that
took a culled window and the mean table rows a scan sweeps.

    python -m f1tenth_gym_tpu_torch.tools.step_trace single  # bench racing step
    python -m f1tenth_gym_tpu_torch.tools.step_trace multi   # 16-track domain-rand step

Both profile the step's eager body (``step.eager``), whose stages the
spans and the profiler see; users' steps on the card replay it as one CUDA
graph (``parallel/vector.py``), which runs the same kernels without them.

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
from f1tenth_gym_tpu_torch.utils import cuda_build, profiling


def build_single(envs: int, num_beams: int, device=None):
    """(step, states, map, tables) of the bench racing step."""
    m, tables, poses = common.bench_workload(1.25, envs, num_beams, device)
    states, step, _ = common.racing_step(m, tables, poses, eager=True)
    return step, states, m, tables


def build_multi(envs: int, num_beams: int, tracks: int = 16, seed: int = 0,
                device=None):
    """(step, states, map, tables) of the domain-randomization world's
    step."""
    from f1tenth_gym_tpu_torch.examples import domain_randomization as dr

    world = dr.make_world(tracks, envs, 2, num_beams, seed, device)
    actions = torch.zeros((envs, 2, 2), device=world.map_data.device)
    actions[..., 1] = 2.0

    def step(s):
        return world.step.eager(s, actions)[0]

    return step, world.sort(world.states), world.map_data, world.tables


def scan_windows(states, m, tables, num_beams: int) -> dict:
    """Where K1's scans from ``states`` go: the share of its subgroups
    that take a culled window (``bid > 0``) and the mean table rows a scan
    sweeps (``SweepInputs.swept_rows``)."""
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    x = states.x
    yaw = x[..., 4]
    pose = torch.stack([x[..., 0] + tables.lidar_dist * torch.cos(yaw),
                        x[..., 1] + tables.lidar_dist * torch.sin(yaw),
                        yaw], -1).reshape(-1, 3)
    w = sk.prepare_map(pose, m, tables, num_beams, common.THETA_DIS)
    return dict(culled_subgroup_share=float((w.bid > 0).double().mean()),
                mean_swept_rows=float(w.swept_rows().double().mean()))


def trace(kind: str = "single", envs: int = 4096, steps: int = 8,
          num_beams: int = 1080, tracks: int = 16, seed: int = 0,
          device=None) -> dict:
    """Profile ``steps`` steps of workload ``kind``; returns
    ``common.device_time_by_name``'s dict with, under its label (``k1``,
    ``k3``), the ms and launches a step in the profile of each declared
    kernel the step launches; ``k1_wrapper_launches`` and
    ``k3_wrapper_launches`` (the wrappers' counts over the profiled
    steps), ``scan_windows`` (``scan_windows`` at the last states) and
    ``spans`` (the port's spans a step: {name: {calls,
    host_ms, host_self_ms, extent_ms, kernel_ms}})."""
    from f1tenth_gym_tpu_torch.ops import opp_clip_kernel as oc
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    dev = resolve_device(device)
    if kind == "single":
        step, s, m, tables = build_single(envs, num_beams, dev)
    elif kind == "multi":
        step, s, m, tables = build_multi(envs, num_beams, tracks, seed, dev)
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
    # the profiler links the kernels' ctypes launches to no range: each
    # one's time, found by name, goes to the span that launches it and the
    # spans around that
    kernels = {}
    up = {r.name: r.parent for r in profiling.TABLE.records}
    for kern in cuda_build.KERNELS:
        if kern.span is None:
            continue
        k = kernels[kern.label.lower()] = common.named(t["by_name"],
                                                       kern.trace_name)
        name = kern.span
        while name in spans:
            spans[name]["kernel_ms"] += k["ms_per_step"]
            name = up[name]
    return dict(kind=kind, envs=envs, agents=2, beams=num_beams, steps=steps,
                device=common.device_name(dev), **t, **kernels,
                k1_wrapper_launches=sk.sweep.launches - before,
                k3_wrapper_launches=oc.opp_clip.launches - before_k3,
                scan_windows=scan_windows(box[0], m, tables, num_beams),
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
    sw = r["scan_windows"]
    print(f"  K1 subgroups on a culled window: "
          f"{sw['culled_subgroup_share']:.4f}; table rows a scan sweeps: "
          f"{sw['mean_swept_rows']:.1f}", flush=True)
    print(json.dumps({k: v for k, v in r.items()
                      if k not in ("by_name", "spans")}), flush=True)
    return r


if __name__ == "__main__":
    main()
