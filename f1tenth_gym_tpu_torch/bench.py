"""Headline benchmark of the port: env-steps/s of 2-agent, 1080-beam
racing envs on one card, with the correctness gates before the timing.

The port's counterpart of the repository's ``bench.py`` (the JAX
package's, which stays as it is), with the same workload, gates and
output line:

    python -m f1tenth_gym_tpu_torch.bench

The workload: BENCH_ENVS envs of BENCH_AGENTS agents on the map, each
auto-reset to its own start grid, the gap-follow policy of
``bench.py:297-310``, the batch re-sorted for locality every
BENCH_SORT_PERIOD steps; one warm-up sort period, then BENCH_STEPS timed
steps. Before it, the gates: the kernel engine against the marching engine
at MSE < 2.0 on the bench map and the BENCH_GATE_MAPS (32 poses each,
over the beams whose march stays in the map raster; the all-beam MSE is
printed beside it), and the iTTC and collision spot checks.

Env knobs (``bench.py``'s): BENCH_ENVS (4096), BENCH_STEPS (256),
BENCH_BEAMS (1080), BENCH_MAP (a map yaml; default the bundled
example_map), BENCH_ENGINE ("pallas", the scan kernel), BENCH_AGENTS (2),
BENCH_CULL_TS (1.25), BENCH_SORT_PERIOD (16), BENCH_GATE_MAPS
("berlin,stata_basement"), BENCH_WEAK ("1": run the weak scaling), and
BENCH_DEVICE (default: the card). The weak-scaling stand-in of
``bench.py:54-149`` runs 1, 2, 4 and 8 gloo processes on the CPU,
BENCH_WEAK_ENVS_PER_DEVICE (64) envs each of 2 agents x 108 beams with the
segments engine, BENCH_WEAK_STEPS (16) steps, one thread a process; a
count's rate is the sum of its ranks' rates, and the retention the rate
at 8 over the rate at 1. Those rates are the host CPU's and say nothing
about the card. A failed weak-scaling rank raises.

The last line of stdout is one JSON object: ``metric``, ``value``,
``unit``, ``vs_baseline`` (value / 500, the reference's rate,
``bench.py:8-12``), ``scan_mse_by_map``, ``scan_mse_all_beams_by_map``,
``ittc_collision_gate``, ``weak_scaling_retention_8shard`` and
``weak_scaling_total_rates``; a ``#`` line on stderr gives the device,
the elapsed seconds, the dones, the scan kernel's launches by the host
(``k1_launches``; none in a step that replays the step's CUDA graph) and
the graph's replays (``graph_replays``).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

REFERENCE_FULL_STEP_RATE = 500.0  # env-steps/s, one CPU core (BASELINE.md)
GATE_POSES = 32
MSE_BAR = 2.0   # the reference's cross-engine bar (unittest/scan_sim.py:342)
THETA_DIS = 2000
WEAK_RANKS = (1, 2, 4, 8)  # bench.py:115


def grid_of(m):
    """The map's culling tile grid, as tile_snake_key takes it."""
    tm = m.tile_meta_host
    return dict(tile_size=1.0 / tm[2], origin=(tm[0], tm[1]))


def bench_poses(m, seed, envs=4096, agents=2, **kw):
    """(envs, agents, 3) start poses of the bench sampler
    (``bench.py:201-208``) on the map's device, in tile-snake order when
    the map has a culling pack."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.parallel.vector import tile_snake_key

    sampler = P.uniform_pose_sampler(m, clearance=0.6, grouped=True,
                                     align_theta=True, **kw)
    poses = sampler(P.make_generator(m.device, seed), (envs, agents))
    if m.tile_meta_host is None:
        return poses
    key = tile_snake_key(poses[..., 0].mean(1), poses[..., 1].mean(1),
                         **grid_of(m))
    return poses[torch.argsort(key, stable=True)]


def gap_follow(scans):
    """The gap-follow policy of bench.py:297-310: (..., B) -> (..., 2)."""
    B = scans.shape[-1]
    lo, hi = 2 * B // 5, 3 * B // 5
    best = torch.argmax(scans[..., lo:hi], -1) + lo
    angle = (best.to(scans.dtype) / (B - 1) - 0.5) * 4.7
    steer = torch.clamp(0.6 * angle, -0.4, 0.4)
    front = scans[..., lo:hi].amin(-1)
    speed = torch.clamp(0.8 * front, 1.0, 4.0)
    return torch.stack([steer, speed], -1)


def main_path(m, tables, poses, sort_period=16, scan_noise=True,
              engine="kernel"):
    """The bench racing step on ``m`` from ``poses`` (E, A, 3): returns the
    reset states and ``drive(states, n_steps) -> (states, dones)``, which
    steps with the gap-follow policy and re-sorts for locality every
    ``sort_period`` steps (never when 0; only with a culling pack)."""
    import f1tenth_gym_tpu_torch as P

    dev = m.device
    cfg = P.SimConfig(num_agents=poses.shape[1],
                      num_beams=tables.scan_angles.shape[0], dtype="float32",
                      scan_engine=engine, scan_noise=scan_noise)
    params = P.VehicleParams.create(device=dev)
    gen = P.make_generator(dev, 0)
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               generator=gen, device=dev)
    astep = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                  reset_to_start=True, generator=gen,
                                  device=dev)
    sort_kw = grid_of(m) if m.tile_meta_host is not None else {}
    sorting = sort_period and cfg.resolved_scan_engine(
        dev, m.seg_table is not None) == "kernel"

    def drive(s, n_steps):
        dones = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(n_steps):
            if sorting and i % sort_period == 0:
                s = P.sort_envs_for_locality(s, **sort_kw)
            s, _, _, done, _ = astep(s, gap_follow(s.scans))
            dones += done.sum()
        return s, dones

    return states, drive


def gate_poses(name, dev):
    """The gate sampler's 32 poses on bundled map ``name`` (bench.py:258),
    drawn on the CPU so that they are the same on every machine."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.maps import map_path

    host_map = P.load_map(map_path(name), device="cpu")
    return P.uniform_pose_sampler(host_map, clearance=0.5)(
        P.make_generator("cpu", 11), (GATE_POSES,)).to(dev)


def inside_raster(m, cp, ranges, tables):
    """(n, B) bool: the marched beam ends inside the map raster. A march
    that leaves the raster stops on the reference's wrapped out-of-bounds
    cell (ops/lidar.py dt_lookup), which is no wall to the segment sweep:
    those beams measure the map's open edges, not the kernel
    (tests/test_torch_gate.py shows the JAX package's engines part the
    same way on the same poses)."""
    from f1tenth_gym_tpu_torch.ops import lidar as lidar_ops

    idx = lidar_ops.beam_theta_indices(cp[:, 2], tables, ranges.shape[-1],
                                       THETA_DIS)
    xt = cp[:, 0:1] + ranges * tables.cosines[idx] - m.orig_x
    yt = cp[:, 1:2] + ranges * tables.sines[idx] - m.orig_y
    xr = xt * m.orig_c + yt * m.orig_s
    yr = -xt * m.orig_s + yt * m.orig_c
    return ((xr >= 0) & (xr < m.width * m.resolution)
            & (yr >= 0) & (yr < m.height * m.resolution))


def gate_mse(m, cp, tables):
    """The kernel scan against the march on poses ``cp`` (n, 3): the MSE
    over the beams that stay in the raster, over all beams, and the count
    of beams that leave it."""
    from f1tenth_gym_tpu_torch.ops import lidar as lidar_ops
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    B = tables.scan_angles.shape[0]
    march = lidar_ops.get_scan(cp, m, tables, B, THETA_DIS)
    kern = sk.scan(cp, m, tables, B, THETA_DIS, device=m.device)
    inside = inside_raster(m, cp, march, tables)
    d2 = (march - kern) ** 2
    return float(d2[inside].mean()), float(d2.mean()), int((~inside).sum())


def ittc_collision_gate(tables, params):
    """bench.py:267-289: the iTTC check fires for a wall 0.18 m out at
    8 m/s and not for one 25 m out; two cars on one spot collide, two 5 m
    apart do not. Raises otherwise."""
    from f1tenth_gym_tpu_torch.ops import collision as col_ops
    from f1tenth_gym_tpu_torch.ops import lidar as lidar_ops

    dev = tables.max_range.device
    B = tables.scan_angles.shape[0]
    vel = torch.full((2,), 8.0, device=dev)
    hot = lidar_ops.check_ttc(torch.full((2, B), 0.18, device=dev), vel,
                              tables)
    cold = lidar_ops.check_ttc(torch.full((2, B), 25.0, device=dev), vel,
                               tables)
    if not (bool(hot.all()) and not bool(cold.any())):
        raise AssertionError(f"iTTC gate: hot={hot} cold={cold}")
    overlap = col_ops.get_vertices(torch.tensor(
        [[0.0, 0.0, 0.0], [0.1, 0.0, 0.5]], device=dev), params.length,
        params.width)
    apart = col_ops.get_vertices(torch.tensor(
        [[0.0, 0.0, 0.0], [5.0, 0.0, 0.5]], device=dev), params.length,
        params.width)
    c_hot, _ = col_ops.collision_multiple(overlap)
    c_cold, _ = col_ops.collision_multiple(apart)
    if not (bool((c_hot > 0).all()) and not bool((c_cold > 0).any())):
        raise AssertionError(f"collision gate: overlap={c_hot} apart={c_cold}")
    return "ok"


def weak_rank(rank, nprocs, port, envs, steps):
    """One rank of the weak-scaling stand-in (module docstring): its
    env-steps/s."""
    import torch.distributed as dist

    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.maps import map_path
    from f1tenth_gym_tpu_torch.parallel import multihost
    from f1tenth_gym_tpu_torch.parallel.sharding import make_mesh

    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=nprocs, process_id=rank,
                         devices="cpu")
    mesh = make_mesh(devices="cpu")
    cfg = P.SimConfig(num_agents=2, num_beams=108, dtype="float32",
                      scan_engine="segments")
    params = P.VehicleParams.create(device="cpu")
    tables = P.make_scan_tables(num_beams=108, device="cpu")
    m = P.load_map(map_path("example_map"), extract_segments=True,
                   device="cpu")
    sampler = P.uniform_pose_sampler(m, clearance=0.6,
                                     component_seed=(0.7, 0.0), grouped=True,
                                     align_theta=True)

    def make_local(n):
        poses = sampler(P.make_generator("cpu", 7 + rank), (n, 2))
        states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                                   generator=P.make_generator("cpu", rank),
                                   device="cpu")
        return states

    s = multihost.host_local_states(make_local, mesh, envs)
    astep = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                  reset_to_start=True, device="cpu")
    actions = torch.zeros((envs, 2, 2))
    actions[..., 1] = 2.0
    s, *_ = astep(s, actions)  # warm-up
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        s, *_ = astep(s, actions)
    rate = envs * steps / (time.perf_counter() - t0)
    dist.barrier()
    return rate


def weak_rates(ranks, envs, steps, worker=weak_rank, timeout_s=300.0):
    """{ranks: summed env-steps/s} of ``worker`` spawned over each count of
    ``ranks`` on the CPU (the card hidden from them). A failed rank
    raises."""
    from f1tenth_gym_tpu_torch.parallel.multihost import spawn

    rates = {}
    for n in ranks:
        rates[n] = sum(spawn(worker, n, (envs, steps), timeout_s=timeout_s,
                             env={"CUDA_VISIBLE_DEVICES": ""}))
        print(f"# ranks={n}: {rates[n]:.0f} env-steps/s "
              f"({rates[n] / n:.0f}/rank, host CPU)", file=sys.stderr,
              flush=True)
    return rates


def main():
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.config import resolve_device
    from f1tenth_gym_tpu_torch.maps import map_path as bundled_map
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    env = os.environ.get
    num_envs = int(env("BENCH_ENVS", 4096))
    num_steps = int(env("BENCH_STEPS", 256))
    num_beams = int(env("BENCH_BEAMS", 1080))
    num_agents = int(env("BENCH_AGENTS", 2))
    engine = P.SimConfig(scan_engine=env("BENCH_ENGINE", "pallas")).scan_engine
    sort_period = int(env("BENCH_SORT_PERIOD", 16))
    dev = resolve_device(env("BENCH_DEVICE") or None)
    default_map = bundled_map("example_map")
    map_file = env("BENCH_MAP") or default_map
    kernel = engine == "kernel"

    tables = P.make_scan_tables(num_beams=num_beams, device=dev)
    params = P.VehicleParams.create(device=dev)
    m = P.load_map(map_file, ".png", extract_segments=engine in (
        "segments", "kernel"), tile_culling=kernel,
        culling_tile_size=float(env("BENCH_CULL_TS", 1.25)), device=dev)
    # the cars spawn on the track corridor (the free component of the
    # reference start pose) in adjacent pairs
    seed_xy = dict(component_seed=(0.7, 0.0)) if map_file == default_map \
        else {}
    poses = bench_poses(m, 7, num_envs, num_agents, **seed_xy)

    result = {"metric": "env_steps_per_sec_per_chip"}
    gates, gates_all = {}, {}
    if kernel:
        name = os.path.splitext(os.path.basename(map_file))[0]
        gates[name], gates_all[name], _ = gate_mse(
            m, poses[:GATE_POSES].reshape(-1, 3), tables)
        for name in filter(None, env("BENCH_GATE_MAPS",
                                     "berlin,stata_basement").split(",")):
            gm = P.load_map(bundled_map(name), extract_segments=True,
                            tile_culling=True, device=dev)
            gates[name], gates_all[name], _ = gate_mse(
                gm, gate_poses(name, dev), tables)
        for name, mse in gates.items():
            if not mse < MSE_BAR:
                raise AssertionError(
                    f"kernel-vs-march MSE {mse} >= {MSE_BAR} on {name}")
        gate = ittc_collision_gate(tables, params)

    states, drive = main_path(m, tables, poses, sort_period, engine=engine)
    t0 = time.time()
    s, _ = drive(states, max(sort_period, 1))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    warm = time.time() - t0
    sk.sweep.launches = 0
    replays = P.make_autoreset_step.replays
    t0 = time.time()
    s, dones = drive(s, num_steps)
    dones = int(dones)  # waits for the device
    elapsed = time.time() - t0
    launches = sk.sweep.launches
    replays = P.make_autoreset_step.replays - replays

    rate = num_envs * num_steps / elapsed
    result.update(value=rate, unit="env-steps/s",
                  vs_baseline=rate / REFERENCE_FULL_STEP_RATE)
    if kernel:
        result.update(scan_mse_by_map=gates,
                      scan_mse_all_beams_by_map=gates_all,
                      ittc_collision_gate=gate)
    if env("BENCH_WEAK", "1") == "1":
        rates = weak_rates(WEAK_RANKS,
                           int(env("BENCH_WEAK_ENVS_PER_DEVICE", 64)),
                           int(env("BENCH_WEAK_STEPS", 16)))
        result["weak_scaling_retention_8shard"] = rates[8] / rates[1]
        result["weak_scaling_total_rates"] = {str(n): r
                                              for n, r in rates.items()}
    print(json.dumps(result), flush=True)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"# envs={num_envs} agents={num_agents} steps={num_steps} "
          f"beams={num_beams} engine={engine} device={name} "
          f"elapsed={elapsed:.3f}s warmup={warm:.1f}s dones={dones} "
          f"k1_launches={launches} graph_replays={replays}", file=sys.stderr,
          flush=True)
    return result


if __name__ == "__main__":
    main()
