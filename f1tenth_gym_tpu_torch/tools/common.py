"""What the probes share: the bench workload, timers, profile parsing.

The JAX probes (``tools/*.py``) repeat this set-up in every file. Here it
is once:

* ``bench_workload``: example_map (or another bundled map) culled at a
  tile size, and the bench sampler's poses in tile-snake order
  (``bench.bench_poses``); ``racing_step``: the auto-reset racing step of
  those poses with the JAX probes' constant actions (no steer, 2 m/s);
* timers: ``fenced_ms`` (host clock, fenced by a synchronize),
  ``cuda_ms`` (CUDA events) and ``kernel_ms`` (a CUDA graph of launches,
  for kernels whose enqueue is of their own order);
* ``device_time_by_name``: a ``torch.profiler`` result as device ms a
  step by kernel name, their total and the busy share. K1 is launched
  through ctypes, so no ``record_function`` range covers it: it is found
  by its kernel name, ``scan_sweep_kernel`` (``K1_NAME``), as K3 is by
  ``opp_clip_kernel`` (``K3_NAME``).
"""

from __future__ import annotations

import time

import torch

from f1tenth_gym_tpu_torch.bench import bench_poses
from f1tenth_gym_tpu_torch.config import resolve_device

THETA_DIS = 2000
LEAK_CAP = 1e-6   # vertex-leak beams allowed between two sweeps, a share
                  # of the beams (chip_smoke.py's rule on split packs)
K1_NAME = "scan_sweep_kernel"
K2_NAME = "overlay_kernel"
K3_NAME = "opp_clip_kernel"
EXAMPLE_SEED_XY = (0.7, 0.0)   # the corridor of example_map's start pose


def device_arg(ap, default=None):
    """Add ``--device`` to an argument parser (default: the card)."""
    ap.add_argument("--device", default=default,
                    help=f"torch device (default: {default or 'the card'})")


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_workload(ts: float, envs: int, num_beams: int = 1080, device=None,
                   map_name: str = "example_map", split_cap: int = 0,
                   tile_culling: bool = True):
    """(map, tables, poses (envs, 2, 3)): the bundled map culled at ``ts``
    m tiles (windows split at ``split_cap`` groups, 0: never), the scan
    tables, and the bench sampler's poses (generator seed 7, on
    example_map from the corridor of its start pose) in tile-snake order."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.maps import map_path

    dev = resolve_device(device)
    m = P.load_map(map_path(map_name), extract_segments=True,
                   tile_culling=tile_culling, culling_tile_size=ts,
                   culling_split_cap=split_cap, device=dev)
    tables = P.make_scan_tables(num_beams=num_beams, device=dev)
    kw = (dict(component_seed=EXAMPLE_SEED_XY) if map_name == "example_map"
          else {})
    return m, tables, bench_poses(m, 7, envs, 2, **kw)


def racing_step(m, tables, poses, scan_noise: bool = True):
    """The auto-reset racing step on ``poses`` (E, A, 3), float32, engine
    "kernel", each env reset to its own start grid, with the JAX probes'
    actions (steer 0, speed 2 m/s). Returns (reset states, step: states ->
    states, (params, cfg))."""
    import f1tenth_gym_tpu_torch as P

    dev = m.device
    E, A = poses.shape[:2]
    cfg = P.SimConfig(num_agents=A, num_beams=tables.scan_angles.shape[0],
                      dtype="float32", scan_engine="kernel",
                      scan_noise=scan_noise)
    params = P.VehicleParams.create(device=dev)
    gen = P.make_generator(dev, 0)
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               generator=gen, device=dev)
    astep = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                  reset_to_start=True, generator=gen,
                                  device=dev)
    actions = torch.zeros((E, A, 2), device=dev)
    actions[..., 1] = 2.0

    def step(s):
        return astep(s, actions)[0]

    return states, step, (params, cfg)


def other_agent_boxes(poses, params):
    """(E, 2, 3) poses -> (E, 2, 1, 4, 2): each agent's one opponent is
    the other agent's box (tools/step_probe.py:93-103)."""
    from f1tenth_gym_tpu_torch.ops import collision as col_ops

    verts = col_ops.get_vertices(poses, params.length, params.width)
    return verts.flip(1)[:, :, None]


def fenced_ms(fn, reps: int, dev: torch.device) -> float:
    """Host-clock ms a call of ``fn`` over ``reps`` calls after one warm-up
    call, fenced by a synchronize on the card (the JAX probes' timer)."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def cuda_ms(fn, iters: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` calls, after three
    warm-up calls."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int) -> dict:
    """A kernel wrapper's time three ways: ``ms``, the CUDA-event time a
    launch of a CUDA graph of ``iters`` wrapper calls (the kernel alone:
    no host work between launches); ``eager_ms``, the CUDA-event time a
    call of ``iters`` calls made one after the other from Python; and
    ``enqueue_us``, the host time a call takes to enqueue (checks, ctypes
    call, output allocation). Where ``enqueue_us`` is not well under
    ``ms``, ``eager_ms`` measures the host and ``ms`` is the kernel's."""
    eager_ms = cuda_ms(fn, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_us = (time.perf_counter() - t0) / iters * 1e6
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return dict(ms=start.elapsed_time(end) / iters, eager_ms=eager_ms,
                enqueue_us=enqueue_us)


def profile(fn, steps: int, dev: torch.device, device_activity: bool = True):
    """Run ``fn`` ``steps`` times under ``torch.profiler`` (CPU and CUDA
    activity on the card, CPU only on the CPU, where a CPU-only torch asked
    for CUDA activity floods the log, or when ``device_activity`` is
    False), ending with a synchronize. Returns the profiler."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda" and device_activity:
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            fn()
        sync(dev)
    return prof


def device_time_by_name(prof, steps: int) -> dict:
    """Sums of a profile of ``steps`` steps by name.

    With CUDA activity, the names are the card's kernels and copies and
    the times their device time; without it (a CPU run), the names are the
    CPU ops and the times their self time, which is what runs on that
    device. ``record_function`` ranges (the port's spans), which the
    profiler draws on both timelines, are no ops and are left out.
    Returns ``by_name`` ({name: {ms_per_step, calls_per_step}},
    largest first), ``total_ms_per_step``, ``wall_ms_per_step`` (the
    profiled span, first event to last) and ``busy_share`` (the total over
    the span). A profile of the card without device time raises: its
    kernels were not traced, and zeros would pass for a measurement."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    on_card = ProfilerActivity.CUDA in prof.activities
    want = DeviceType.CUDA if on_card else DeviceType.CPU
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != want or getattr(e, "is_user_annotation", False):
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0)) if on_card \
            else e.self_cpu_time_total
        if us > 0:
            by_name[e.key] = dict(ms_per_step=us / 1e3 / steps,
                                  calls_per_step=e.count / steps)
    total = sum(v["ms_per_step"] for v in by_name.values())
    if total <= 0:
        raise RuntimeError("the profile holds no device time: "
                           + ("no CUDA kernel was traced" if on_card
                              else "no CPU op was traced"))
    events = prof.events()
    span_us = (max(e.time_range.end for e in events)
               - min(e.time_range.start for e in events))
    wall = span_us / 1e3 / steps
    return dict(by_name=dict(sorted(by_name.items(),
                                    key=lambda kv: -kv[1]["ms_per_step"])),
                total_ms_per_step=total, wall_ms_per_step=wall,
                busy_share=total / wall,
                timeline="device" if on_card else "cpu ops")


def named(by_name: dict, part: str) -> dict:
    """The summed ``device_time_by_name`` entries whose name holds
    ``part`` (a kernel's name: K1_NAME, K2_NAME, K3_NAME)."""
    hits = [v for k, v in by_name.items() if part in k]
    return dict(ms_per_step=sum(v["ms_per_step"] for v in hits),
                calls_per_step=sum(v["calls_per_step"] for v in hits))


def print_top(title: str, t: dict, top: int = 15):
    """The JAX probes' table: the top names by ms a step and their share."""
    print(f"# {title}: total {t['total_ms_per_step']:.3f} ms/step of "
          f"{t['timeline']} time, busy share {t['busy_share']:.4f} "
          f"(wall {t['wall_ms_per_step']:.3f} ms/step)", flush=True)
    for name, v in list(t["by_name"].items())[:top]:
        print(f"  {v['ms_per_step']:8.3f} ms/step  "
              f"{100 * v['ms_per_step'] / t['total_ms_per_step']:5.1f}%  "
              f"{v['calls_per_step']:7.2f}/step  {name[:70]}", flush=True)


def vertex_leaks(m, flat, a, b, tables, num_beams: int):
    """Beams on which two sweeps ``a`` and ``b`` of the scans at ``flat``
    (n, 3) differ: (count, all of them leaks). A beam through the shared
    vertex of two wall segments can fail both f32 hit tests and pass
    through the wall (the TPU kernel's formulation), and a sweep with a
    wider table then finds a wall behind it that the other rightly left
    out; so on a leak both sweeps overshoot the marched range by more than
    the contour tolerance (0.5 m). A table missing a visible wall fails
    this, since the wider sweep would then agree with the march."""
    from f1tenth_gym_tpu_torch.ops import lidar as lidar_ops

    n = flat.shape[0]
    diff = a[:n] != b[:n]
    rows = diff.any(-1).nonzero().flatten()
    leaks = True
    if rows.numel():
        march = lidar_ops.get_scan(flat[rows], m, tables, num_beams,
                                   THETA_DIS)
        d = diff[rows]
        nearer = torch.minimum(a[rows][d], b[rows][d])
        leaks = bool((march[d] < nearer - 0.5).all())
    return int(diff.sum()), leaks
