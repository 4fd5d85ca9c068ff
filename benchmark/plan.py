"""The planner cell's runner: E envs of one car each, every env a candidate
of a pure-pursuit gain sweep, closed loop for a fixed time, then judged
against the plain references.

Set-up and the window are ``race.run``'s (its module docstring), with two
differences. The policy is the port's ``PurePursuitPlanner.fused_plan_step``
over the port's auto-reset step: each env plans from its current pose over
the configuration's raceline with its own lookahead and speed gain, drawn
uniformly in the configuration's bounds from ``--seed``. And the runner
calls the port's locality sort itself (``sort_envs_for_locality``, on the
map's culling grid, as ``worlds.build`` does) with ``return_order=True``,
so that at every sort the gains follow their envs by the sort's
permutation.

The checks are ``race.judge``'s, on the planner's recorded actions, and
``plan_gap``: over the cars and steps ``judge`` judges (the sampled envs
and every env reset, on two of the first steps, one of which sorts), the
largest, over cars, of the least gap between the program's action and an
action the plain planner (``reference.pure_pursuit.admitted``, float64)
admits for the car's pose and gains, as max(|speed - ref|, |steer - ref|)
in m/s and rad. Each snapshot keeps the gains that belong to its envs,
which the sort carries whether or not the program's own gains follow
(``follow=False``, a control that must fail).

With ``--trace 1`` the layer record is ``race._layer_record``'s, which the
racing cells' readers read too, with ``plan``: the cars planned a step in
the card-only stretch (the port's ``pure_pursuit_plan.cars`` counter) and
the planner's least time a step (``plan_bound_s``).
"""

from __future__ import annotations

import contextlib
import copy
import inspect
import os
import time

import numpy as np
import torch

from benchmark import generator, roofline, worlds
from benchmark.race import (Clock, _clone, _layer_record, _leaves,
                            _profiler, _rows, _sync, judge, p95)
from benchmark.reference import pure_pursuit as ref_pp
from benchmark.reference.step import IX_X, IX_Y, IX_YAW

# The planner's least work, counted from its inputs in the reference's
# formulation (``reference/pure_pursuit.py``), as K1's is: a nearest-point
# test a car and segment, a circle test a car and segment (the search
# visits every segment in the worst case, and a fused planner tests them
# all at once), the poses and gains read, the actions written, the raceline
# read once. A faster planner shows as a higher share, never as a smaller
# count.
NEAREST_TEST_FLOPS = 19   # the offset from the start (2), its dot with the
                          # segment (3), over the length squared (1), the
                          # clamp (2), the projection (4), the offset from
                          # it (2), its length (4), the least-distance test (1)
CIRCLE_TEST_FLOPS = 31    # b (6), c (7), the discriminant (4), its test
                          # and root (2), the two roots (4), their range
                          # tests (4) and combination (3), the first-in-order
                          # test (1)
POSE_FLOATS, GAIN_FLOATS, ACTION_FLOATS, POINT_FLOATS = 3, 2, 2, 3


def plan_flops(cars: int, n_points: int) -> int:
    return cars * ((n_points - 1) * NEAREST_TEST_FLOPS
                   + n_points * CIRCLE_TEST_FLOPS)


def plan_bytes(cars: int, envs: int, n_points: int) -> int:
    return roofline.F32 * (cars * (POSE_FLOATS + ACTION_FLOATS)
                           + envs * GAIN_FLOATS + n_points * POINT_FLOATS)


def plan_bound_s(cars: int, envs: int, n_points: int):
    """(least seconds, "bytes" or "operations": which of the two binds)."""
    tb = plan_bytes(cars, envs, n_points) / roofline.PEAK_BYTES_PER_S
    tf = plan_flops(cars, n_points) / roofline.PEAK_F32_FLOPS
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def load_waypoints(cfg: dict) -> np.ndarray:
    """The configuration's raceline as (N, 3) float64 [x, y, speed]."""
    pc = cfg["planner"]
    w = np.loadtxt(os.path.join(cfg["_dir"], pc["waypoints"]),
                   delimiter=pc["delimiter"], skiprows=pc["skiprows"],
                   ndmin=2)
    return w[:, [pc["x_col"], pc["y_col"], pc["speed_col"]]]


def draw_gains(cfg: dict, E: int, dev, seed: int):
    """Each env's (lookahead, speed gain), (E, 1) each, uniform in the
    configuration's bounds."""
    pc = cfg["planner"]
    u = torch.rand((2, E, 1), generator=generator.generator(dev, seed),
                   dtype=generator.DTYPE, device=dev)
    return tuple(lo + (hi - lo) * u[k] for k, (lo, hi) in
                 enumerate((pc["tlad_bounds"], pc["vgain_bounds"])))


def judged_rows(rng, snaps, E: int, traffic: dict):
    """The rows ``judge`` judges in each snapshot, drawn from a copy of the
    generator ``judge`` is handed, in ``judge``'s order."""
    n = traffic["check"]["sample_envs"]
    out = []
    for rec in snaps:
        done = torch.nonzero(rec["done"]).flatten()[:n].cpu().numpy()
        pick = rng.choice(E, min(E, n), replace=False)
        out.append(torch.as_tensor(np.union1d(pick, done),
                                   device=rec["done"].device))
    return out


def _spread(values, car, n):
    """Per car (n,): the largest less the least of its rows' ``values``."""
    v = values.double()
    hi = torch.full((n,), -np.inf, dtype=v.dtype, device=v.device)
    lo = torch.full((n,), np.inf, dtype=v.dtype, device=v.device)
    return (hi.scatter_reduce(0, car, v, "amax")
            - lo.scatter_reduce(0, car, v, "amin"))


def plan_check(cfg, snaps, rows_each, waypoints, limit,
               control=False) -> dict:
    """``plan_gap`` over the judged rows: each judged car's gap
    (``gaps``), the cars with more than one admitted action (``ties``)
    and those whose admitted actions differ by more than ``limit``
    (``splits``)."""
    pc = cfg["planner"]
    wb, mr = float(pc["wheelbase"]), float(pc["max_reacquire"])
    gaps, ties, splits = [], 0, 0
    for rec, rows in zip(snaps, rows_each):
        x = rec["in"]["x"][rows]
        A = x.shape[1]
        poses = torch.stack([x[..., IX_X], x[..., IX_Y], x[..., IX_YAW]],
                            -1).reshape(-1, 3)
        tlad, vgain = (g[rows].expand(-1, A).reshape(-1)
                       for g in rec["gains"])
        if control:
            speed, steer = ref_pp.plan(poses, tlad, vgain, waypoints, wb, mr,
                                       dtype=torch.bfloat16)
        else:
            a = rec["actions"][rows].reshape(-1, 2)
            steer, speed = a[:, 0], a[:, 1]
        car, r_speed, r_steer = ref_pp.admitted(poses, tlad, vgain,
                                                waypoints, wb, mr)
        gaps.append(ref_pp.action_gap(speed, steer, car, r_speed, r_steer))
        n = poses.shape[0]
        ties += int((torch.bincount(car, minlength=n) > 1).sum())
        splits += int(((_spread(r_speed, car, n) > limit)
                       | (_spread(r_steer, car, n) > limit)).sum())
    return dict(gaps=torch.cat(gaps), ties=ties, splits=splits)


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False, follow: bool = True) -> dict:
    """One run of a planner cell: the result's fields (``race.run``'s).
    ``control`` (the references in bfloat16 in the program's place) and
    ``follow=False`` (the program's gains stay in their slots at a sort)
    are for the benchmark's tests and must come out not correct."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.planning.pure_pursuit import (
        PurePursuitPlanner, pure_pursuit_plan)

    if "return_order" not in inspect.signature(
            P.sort_envs_for_locality).parameters:
        raise RuntimeError("this port's sort_envs_for_locality gives back no "
                           "permutation, so per-env gains cannot follow "
                           "their envs")
    cfg, tr = cell["config"], cell["traffic"]
    pc = cfg["planner"]
    dev = torch.device(device)
    s_pose, s_noise, s_check, s_gain = generator.seeds(seed)
    rng = np.random.default_rng(s_check)
    E, A = int(tr["envs"]), int(cfg["num_agents"])
    period = int(cfg["sort_period"])

    if cfg["world"]["kind"] != "map":
        raise ValueError("the planner cell runs on a map world")
    world = worlds.build(cfg, dev)
    noise_gen = generator.generator(dev, s_noise)
    sim, params, tables, step = worlds.system(cfg, world, dev, noise_gen)
    tm = world.map_data.tile_meta_host
    grid = dict(tile_size=1.0 / tm[2], origin=(tm[0], tm[1])) if tm else {}
    waypoints = load_waypoints(cfg)
    planner = PurePursuitPlanner(waypoints.astype(cfg["dtype"]),
                                 pc["wheelbase"], pc["max_reacquire"],
                                 device=dev)
    poses = world.sampler(generator.generator(dev, s_pose), (E, A))
    gains = draw_gains(cfg, E, dev, s_gain)   # the envs' own, sorted along
    start_rows = torch.as_tensor(
        np.sort(rng.choice(E, min(E, tr["check"]["sample_envs"]),
                           replace=False)), device=dev)
    noise0 = noise_gen.get_state()
    s, *_ = P.batch_reset(poses, params, world.map_data, tables, sim,
                          cfg["timestep"], generator=noise_gen, device=dev)
    start = dict(rows=start_rows, poses=poses[start_rows].clone(),
                 noise=noise0, state=_clone(_rows(_leaves(s), start_rows)))

    last = {}

    def recorded(s, a):   # the step the planner drives; keeps its actions
        last["actions"] = a
        return step(s, a)

    plan_step = planner.fused_plan_step(recorded, *gains)
    span = (torch.profiler.record_function if trace
            else (lambda name: contextlib.nullcontext()))
    gstep = 0

    def one_step(s, keep=None):
        nonlocal gstep, gains, plan_step
        if gstep % period == 0:
            if keep is not None:
                keep["pre"] = _clone(_leaves(s))
            with span("race.sort"):
                s, order = P.sort_envs_for_locality(s, return_order=True,
                                                    **grid)
                gains = tuple(g[order] for g in gains)
                if follow:
                    plan_step = planner.fused_plan_step(recorded, *gains)
        if keep is not None:
            keep.update(**{"in": _clone(_leaves(s))},
                        noise=noise_gen.get_state(),
                        gains=gains)
        with span("race.step"):
            s, _, _, done, _ = plan_step(s)
        if keep is not None:
            keep.update(actions=last["actions"].clone(),
                        out=_clone(_leaves(s)), done=done.clone())
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
    # race.run's two profiled stretches: the card's activity alone, then
    # the host's ops beside it
    stages = {first: "device", first + trace_steps: "host"} if trace else {}
    min_steps = first + 2 * trace_steps * trace

    clock, snaps, stretches = Clock(dev), [], {}
    dones = torch.zeros((), dtype=torch.int64, device=dev)
    cars = {}
    i, prof = 0, None
    t0 = time.perf_counter()
    clock.mark()
    while i < min_steps or time.perf_counter() - t0 < seconds:
        if i in stages:
            _sync(dev)
            prof = _profiler(dev, host=stages[i] == "host")
            prof.start()
            ta, kind = time.perf_counter(), stages[i]
            cars[kind] = pure_pursuit_plan.cars
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
            cars[kind] = pure_pursuit_plan.cars - cars[kind]
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
        per_step = cars["device"] / trace_steps
        bound_s, bound_by = plan_bound_s(int(per_step), E, len(waypoints))
        layer["plan"] = dict(cars=per_step, bound_s=bound_s,
                             bound_by=bound_by)
    # the program's state goes before the references run
    del s, step, plan_step, planner
    last.clear()
    world.map_data = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rows_each = judged_rows(copy.deepcopy(rng), snaps, E, tr)
    verdict = judge(cfg, tr, world, segments, start, snaps, E, dev, rng,
                    control)
    limit = tr["limits"]["plan_gap"]
    pl = plan_check(cfg, snaps, rows_each, waypoints, limit, control)
    checks = dict(verdict["checks"],
                  plan_gap=(float(pl["gaps"].max()), limit))
    failed = verdict["failed"] + int((pl["gaps"] > limit).sum())
    return dict(
        attempted=i * E, failed=failed, judged=verdict["judged"],
        checks=checks, memory_peak_bytes=int(peak),
        end_to_end=dict(env_steps_per_s=i * E / elapsed,
                        step_ms_p95=p95(gaps), setup_s=setup_s),
        layer=layer,
        note=(f"steps={i} envs={E} window_s={elapsed:.3f} "
              f"setup_s={setup_s:.3f} rate={i * E / elapsed:.1f} "
              f"p95_ms={p95(gaps):.3f} "
              f"dones={n_dones} median_step_ms={float(np.median(gaps)):.3f} "
              f"snapshots={sorted(snap_at)} plan_cars={pl['gaps'].numel()} "
              f"plan_ties={pl['ties']} plan_splits={pl['splits']}"))
