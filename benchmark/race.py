"""The racing cells' runner: E envs of A cars closed-loop under a policy, for a
fixed time, then judged against the plain reference.

Set-up builds the configuration's world and the port's auto-reset step,
draws the start poses and the scan noise's generator from ``--seed``,
resets the envs and drives ``warmup_sort_periods`` sort periods, so that
every kernel is built and every shape has run before the window. The
window steps until ``seconds`` have passed (and at least the steps the
check and the trace need): the port's locality sort before every
``sort_period``-th step, the traffic's policy on the envs' own scans, the
port's step. A CUDA event after each step's last launch marks the step
boundaries; the window ends with a synchronize.

Two of the window's first steps (one that sorts, one that does not),
drawn from the seed, keep their input, the noise generator's state and
their output. After the window the reference works out, for a sample of
the envs drawn from the seed and every env the step reset, the same step
from the same input and noise (``reference.step``), and the reset at
set-up from the same poses; the sort is held to be a permutation, and the
wall segments the scan sweeps to the raster (``reference.walls``).

With ``--trace 1`` two ``torch.profiler`` stretches of ``trace_steps``
steps follow those first steps: the card's activity alone, which the
per-layer metrics read, then with the host's ops, for the breakdown.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from benchmark import devtrace, generator, roofline, worlds
from benchmark.reference import step as ref_step
from benchmark.reference import walls

K1_NAME = "scan_sweep_kernel"


def _leaves(s) -> dict:
    return {k: getattr(s, k) for k in ref_step.LEAVES}


def _clone(d: dict) -> dict:
    return {k: v.clone() for k, v in d.items()}


def _rows(d: dict, rows: torch.Tensor) -> dict:
    return {k: v[rows] for k, v in d.items()}


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Clock:
    """Step boundaries: CUDA events recorded on the stream on the card,
    the host clock on the CPU (where every op has finished on return)."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def gaps_ms(self) -> list:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    v = sorted(values)
    return float(v[max(0, math.ceil(0.95 * len(v)) - 1)])


def gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-env (leading axis) largest absolute difference; equal values
    (infinities too) differ by 0, a NaN on either side by infinity."""
    a, b = a.double(), b.double()
    d = torch.where(a == b, 0.0, (a - b).abs())
    d = torch.nan_to_num(d, nan=math.inf)
    return d.reshape(d.shape[0], -1).amax(-1) if d.numel() else \
        torch.zeros(d.shape[:1], dtype=torch.float64, device=d.device)


def state_gaps(got: dict, want: dict):
    """(per-env gap of every leaf but the scans, per-env scan gap)."""
    other = torch.stack([gap(got[k], want[k]) for k in ref_step.LEAVES
                         if k != "scans"]).amax(0)
    return other, gap(got["scans"], want["scans"])


def permutation_gap(pre: dict, post: dict) -> float:
    """0 when ``post`` holds the envs of ``pre`` in another order: both
    put in one canonical order (stable sorts on the float leaves) and
    compared leaf by leaf."""
    def canonical(d):
        keys = [d["current_time"]] + [d[k].reshape(d[k].shape[0], -1)[:, j]
                                      for k in ("x", "start_thetas",
                                                "start_ys", "start_xs")
                                      for j in range(d[k][0].numel())]
        order = torch.arange(d["x"].shape[0], device=d["x"].device)
        for key in keys:   # least significant first
            order = order[torch.argsort(key[order], stable=True)]
        return _rows(d, order)

    a, b = canonical(pre), canonical(post)
    return float(max(gap(a[k], b[k]).max() for k in ref_step.LEAVES))


def _reference_noise(state, rows, E, B, dev):
    """The envs ``rows`` of the shared-per-env scan noise (E, 1, B) that a
    generator in ``state`` draws next."""
    g = torch.Generator(device=dev)
    g.set_state(state)
    return torch.randn((E, 1, B), generator=g, dtype=torch.float32,
                       device=dev)[rows]


def judge(cfg, traffic, world, segments, start, snaps, E, dev,
          rng, control=False) -> dict:
    """The checks, {name: (value, limit)}, and the rows judged and
    failed. ``control``: the reference in bfloat16 stands in the
    program's place."""
    lim = traffic["limits"]
    B = int(cfg["num_beams"])
    ref = ref_step.Reference(cfg, segments, dev)
    low = ref_step.Reference(cfg, segments, dev, torch.bfloat16) \
        if control else None

    def lowered(d):
        return {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                for k, v in d.items()}

    rows = start["rows"]
    noise = _reference_noise(start["noise"], rows, E, B, dev)
    want = ref.reset(start["poses"], noise)
    got = low.reset(start["poses"], noise) if control else start["state"]
    g_other, g_scan = state_gaps(got, want)
    start_rows = torch.maximum(g_other, g_scan)

    state_rows, scan_rows, sort_gap = [], [], 0.0
    for rec in snaps:
        if rec["pre"] is not None:
            sort_gap = max(sort_gap, permutation_gap(rec["pre"], rec["in"]))
        done = torch.nonzero(rec["done"]).flatten()[:traffic["check"][
            "sample_envs"]].cpu().numpy()
        pick = rng.choice(E, min(E, traffic["check"]["sample_envs"]),
                          replace=False)
        rows = torch.as_tensor(np.union1d(pick, done), device=dev)
        s_in = _rows(rec["in"], rows)
        noise = _reference_noise(rec["noise"], rows, E, B, dev)
        want, _ = ref.step(s_in, rec["actions"][rows], noise)
        if control:
            got, _ = low.step(lowered(s_in), rec["actions"][rows], noise)
        else:
            got = _rows(rec["out"], rows)
        g_other, g_scan = state_gaps(got, want)
        state_rows.append(g_other)
        scan_rows.append(g_scan)
    state_rows = torch.cat(state_rows)
    scan_rows = torch.cat(scan_rows)

    tol = float(cfg["simplify_tol_cells"])
    wall = walls.wall_gap_cells(world.free, segments, world.resolution,
                                world.origin, tol, device=dev)
    checks = {
        "start_gap": (float(start_rows.max()), lim["start_gap"]),
        "state_gap": (max(float(state_rows.max()), sort_gap),
                      lim["state_gap"]),
        "scan_gap_m": (float(scan_rows.max()), lim["scan_gap_m"]),
        "wall_gap_cells": (wall, tol + lim["wall_rounding_cells"]),
    }
    failed = int((start_rows > lim["start_gap"]).sum()
                 + ((state_rows > lim["state_gap"])
                    | (scan_rows > lim["scan_gap_m"])).sum())
    judged = int(start_rows.numel() + state_rows.numel())
    return dict(checks=checks, judged=judged, failed=failed)


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False, wrap_step=None) -> dict:
    """One run of a racing cell: the result's fields (module docstring).
    ``control`` and ``wrap_step`` (a function of the port's step that
    returns the step the window drives) are for the benchmark's tests."""
    import f1tenth_gym_tpu_torch as P

    cfg, tr = cell["config"], cell["traffic"]
    dev = torch.device(device)
    s_pose, s_noise, s_check, _ = generator.seeds(seed)
    rng = np.random.default_rng(s_check)
    E, A = int(tr["envs"]), int(cfg["num_agents"])
    period = int(cfg["sort_period"])
    policy = generator.POLICIES[tr["policy"]]

    world = worlds.build(cfg, dev)
    noise_gen = generator.generator(dev, s_noise)
    sim, params, tables, step = worlds.system(cfg, world, dev, noise_gen)
    if wrap_step is not None:
        step = wrap_step(step)
    poses = world.sampler(generator.generator(dev, s_pose), (E, A))
    start_rows = torch.as_tensor(
        np.sort(rng.choice(E, min(E, tr["check"]["sample_envs"]),
                           replace=False)), device=dev)
    noise0 = noise_gen.get_state()
    s, *_ = P.batch_reset(poses, params, world.map_data, tables, sim,
                          cfg["timestep"], generator=noise_gen, device=dev)
    start = dict(rows=start_rows, poses=poses[start_rows].clone(),
                 noise=noise0, state=_clone(_rows(_leaves(s), start_rows)))

    span = (torch.profiler.record_function if trace
            else (lambda name: contextlib.nullcontext()))
    gstep = 0

    def one_step(s, keep=None):
        nonlocal gstep
        if gstep % period == 0:
            if keep is not None:
                keep["pre"] = _clone(_leaves(s))
            with span("race.sort"):
                s = world.sort(s)
        if keep is not None:
            keep.update(**{"in": _clone(_leaves(s))},
                        noise=noise_gen.get_state())
        with span("race.policy"):
            a = policy(s.scans)
        with span("race.step"):
            s, _, _, done, _ = step(s, a)
        if keep is not None:
            keep.update(actions=a.clone(), out=_clone(_leaves(s)),
                        done=done.clone())
        gstep += 1
        return s, done

    for _ in range(int(tr["warmup_sort_periods"]) * period):
        s, _ = one_step(s)
    _sync(dev)
    setup_s = time.time() - t_start

    first = int(tr["check"]["first_steps"])
    sorting = [i for i in range(1, first) if (gstep + i) % period == 0]
    plain = [i for i in range(1, first) if (gstep + i) % period != 0]
    snap_at = {int(rng.choice(sorting)), int(rng.choice(plain))}
    trace_steps = int(tr["trace_steps"])
    # two profiled stretches: the card's activity alone, which the
    # per-layer metrics read, then the host's ops beside it, which only
    # the breakdown's idle gaps read (tracing host ops slows the host)
    plan = {first: "device", first + trace_steps: "host"} if trace else {}
    min_steps = first + 2 * trace_steps * trace

    clock, snaps, stretches = Clock(dev), [], {}
    dones = torch.zeros((), dtype=torch.int64, device=dev)
    i, prof = 0, None
    t0 = time.perf_counter()
    clock.mark()
    while i < min_steps or time.perf_counter() - t0 < seconds:
        if i in plan:
            _sync(dev)
            prof = _profiler(dev, host=plan[i] == "host")
            prof.start()
            ta, kind = time.perf_counter(), plan[i]
        keep = {"pre": None} if i in snap_at else None
        s, done = one_step(s, keep)
        if keep is not None:
            snaps.append(keep)
        dones += done.sum()
        clock.mark()
        i += 1
        if prof is not None and i in (first + trace_steps,
                                      first + 2 * trace_steps):
            _sync(dev)
            stretches[kind] = (prof, time.perf_counter() - ta)
            prof.stop()
            prof = None
    _sync(dev)
    elapsed = time.perf_counter() - t0
    gaps = clock.gaps_ms()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n_dones = int(dones)
    segments = world.map_data.segments.cpu().numpy()
    layer = None
    if stretches:
        layer = _layer_record(stretches, trace_steps, E * A,
                              int(cfg["num_beams"]), segments)
    # the program's state goes before the reference runs
    del s, step
    world.map_data = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    verdict = judge(cfg, tr, world, segments, start, snaps, E, dev, rng,
                    control)
    return dict(
        attempted=i * E, failed=verdict["failed"], judged=verdict["judged"],
        checks=verdict["checks"], memory_peak_bytes=int(peak),
        end_to_end=dict(env_steps_per_s=i * E / elapsed,
                        step_ms_p95=p95(gaps), setup_s=setup_s),
        layer=layer,
        note=(f"steps={i} envs={E} window_s={elapsed:.3f} "
              f"setup_s={setup_s:.3f} rate={i * E / elapsed:.1f} "
              f"p95_ms={p95(gaps):.3f} "
              f"dones={n_dones} median_step_ms={float(np.median(gaps)):.3f} "
              f"snapshots={sorted(snap_at)}"))


def _profiler(dev: torch.device, host: bool):
    """A profiler of the card's activity, and of the host's ops with
    ``host`` (only the host's on the CPU, where nothing else runs)."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    return torch.profiler.profile(activities=acts)


def _layer_record(stretches, steps, n_scans, beams, segments) -> dict:
    """What the per-layer readers read of a racing window's two profiled
    stretches of ``steps`` steps each (see ``run``)."""
    prof, window_s = stretches["device"]
    device, _ = devtrace.collect(prof)
    dev_b, host_b = devtrace.collect(stretches["host"][0])
    n_seg = int((np.asarray(segments)[:, 0] < 1e6).sum())
    bound_s, bound_by = roofline.k1_bound_s(n_scans, beams, n_seg)
    return dict(
        kind="race", steps=steps, window_s=window_s,
        busy_s=devtrace.busy_seconds(device),
        launches=sum(1 for name, _, _ in device if devtrace.is_launch(name)),
        k1_s=sum(devtrace.seconds_by_name(device, K1_NAME).values()),
        k1_bound_s=bound_s, k1_bound_by=bound_by,
        breakdown=dict(device_ops=devtrace.top_ops(device),
                       idle_gaps=devtrace.idle_gaps(dev_b, host_b)))
