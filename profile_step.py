"""Profile the PyTorch port's bench racing step on one NVIDIA GPU.

    python3 profile_step.py

Sets up the main path of chip_smoke.py (4096 envs x 2 agents x 1080 beams
on example_map culled at 1.25 m tiles, engine "kernel", auto-reset to each
env's start grid, gap-follow policy, locality re-sort every 16 steps),
runs 32 warm-up steps and 64 timed steps, then one sort period of 16 steps
under torch.profiler. Prints one JSON line: wall ms a step with and
without the profiler, the card's busy share, kernel launches and
host-to-device copies a step, the host time, kernel time and span on the
card of each stage of the step, and the top CUDA kernels; then the card's
name and power limit. Exits non-zero when no CUDA device is present.
"""

import json
import subprocess
import sys
import time

import torch

from chip_smoke import AGENTS, BEAMS, SORT_PERIOD, bench_poses, main_path

WARMUP, TIMED = 2 * SORT_PERIOD, 4 * SORT_PERIOD


def main():
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        return 2

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.core import env as env_mod
    from f1tenth_gym_tpu_torch.core import simulator as sim_mod
    from f1tenth_gym_tpu_torch.maps import map_path
    from f1tenth_gym_tpu_torch.ops import collision as col_ops
    from f1tenth_gym_tpu_torch.ops import lidar as lidar_ops
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
    from f1tenth_gym_tpu_torch.parallel import vector as vec_mod

    dev = torch.device("cuda")
    m = P.load_map(map_path("example_map"), extract_segments=True,
                   tile_culling=True, culling_tile_size=1.25, device=dev)
    tables = P.make_scan_tables(num_beams=BEAMS, device=dev)
    poses = bench_poses(m, 7, component_seed=(0.7, 0.0))
    states, drive = main_path(m, tables, poses)
    s, _ = drive(states, WARMUP)
    torch.cuda.synchronize()
    t0 = time.time()
    s, _ = drive(s, TIMED)
    torch.cuda.synchronize()
    plain_wall_ms = (time.time() - t0) * 1e3 / TIMED

    # one profiler range per stage of the step, for the profiled window
    stages = [(env_mod, "sim_step"), (sim_mod, "physics_step"),
              (sk, "scan"), (col_ops, "get_vertices"),
              (col_ops, "collision_multiple"), (lidar_ops, "check_ttc"),
              (col_ops, "ray_cast_opponents"), (env_mod, "_update_laps"),
              (vec_mod, "init_state"), (P, "sort_envs_for_locality")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in stages]

    def ranged(fn, name):
        def wrapper(*a, **kw):
            with record_function("stage::" + name):
                return fn(*a, **kw)
        return wrapper

    for mod, name, fn in saved:
        setattr(mod, name, ranged(fn, name))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            s, _ = drive(s, SORT_PERIOD)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    per_step = 1e-3 / SORT_PERIOD   # profiler us over the window -> ms/step
    kern, stage = [], {}
    for e in prof.key_averages():
        if e.key.startswith("stage::"):
            # the host range (its kernels' summed time, its host time)
            # and its span on the card's timeline, idle gaps included
            st = stage.setdefault(e.key[len("stage::"):], {})
            if e.device_type == DeviceType.CUDA:
                st["device_span_ms"] = e.device_time_total * per_step
            else:
                st["kernel_ms"] = e.device_time_total * per_step
                st["host_ms"] = e.cpu_time_total * per_step
        elif e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            # the port's spans are drawn on the card's timeline too
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            kern.append((us, e.count, e.key))
    kern.sort(reverse=True)
    busy_ms = sum(k[0] for k in kern) * per_step
    # which op (and which of its callers, in which stage) copies to the card
    htod = {}
    for e in prof.events():
        n = sum(1 for k in e.kernels if "HtoD" in k.name)
        if e.device_type != DeviceType.CPU or not n:
            continue
        path, p = [], e
        while p is not None:
            path.append(p.name)
            p = p.cpu_parent
        stage_name = next((x for x in path if x.startswith("stage::")), "-")
        key = f"{stage_name}: {' < '.join(path[:4])}"
        htod[key] = htod.get(key, 0) + n / SORT_PERIOD
    print(json.dumps({
        "phase": "profile", "envs": s.num_envs, "agents": AGENTS,
        "beams": BEAMS, "steps": SORT_PERIOD,
        "wall_ms_per_step_unprofiled": plain_wall_ms,
        "wall_ms_per_step": wall_ms / SORT_PERIOD,
        "device_ms_per_step": busy_ms,
        "device_busy_share": busy_ms * SORT_PERIOD / wall_ms,
        "device_launches_per_step": sum(k[1] for k in kern) / SORT_PERIOD,
        "htod_copies_per_step": sum(k[1] for k in kern
                                    if "HtoD" in k[2]) / SORT_PERIOD,
        "htod_copies_per_step_by_source": htod,
        "stages_per_step": stage,
        "top_kernels": [{"kernel": name[:90], "calls_per_step":
                         n / SORT_PERIOD, "ms_per_step": us * per_step}
                        for us, n, name in kern[:20]]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
