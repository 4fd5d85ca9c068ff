"""Drive the PyTorch port (f1tenth_gym_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. build   — the CUDA scan kernel (nvcc, sm_90a) and the native host
             library (g++), started together;
2. maps    — example_map culled at 1.25 m tiles, berlin and stata_basement
             culled at the default 2.5 m, compact with a split pack;
3. kernel  — the scan kernel against its plain torch version on 8192 bench
             poses, bit for bit, culled and full, and culled == full bit
             for bit on example_map; the same on the split pack, whose
             per-scan extras sweep runs, where culled == full except on
             beams that leak through a wall vertex: over eight seeds every
             differing beam must be such a leak, and they may be at most
             1e-6 of the beams;
4. gates   — kernel vs marching engine MSE < 2.0 on the three maps
             (32 poses each, over the beams whose march stays inside the
             map raster; the all-beam MSE is printed beside it), the iTTC
             and the SAT collision spot checks;
5. main    — the bench racing step: 4096 envs x 2 agents x 1080 beams,
             auto-reset to each env's start grid, gap-follow policy,
             locality re-sort every 16 steps; 16 warm-up + 256 timed steps;
             one kernel launch per step;
6. timing  — CUDA-event times of the kernel (culled and full) and of the
             plain version at the main path's shapes, beside the bound.

Then the ``kernels`` line, the card's name and power limit, and the result
line. Exits non-zero without a result when no CUDA device is present.
"""

import concurrent.futures
import json
import subprocess
import sys
import time

import torch

H100_F32_FLOPS = 67e12      # float32 outside the tensor cores (SXM, 700 W)
H100_BYTES_PER_S = 3.35e12  # HBM3
HIT_OPS = 14                # operations per (beam, row) hit test
ENVS, AGENTS, BEAMS, THETA_DIS = 4096, 2, 1080, 2000
WARMUP, STEPS, SORT_PERIOD = 16, 256, 16
LEAK_SEEDS = range(8, 16)   # bench-pose seeds swept on the split pack
LEAK_CAP = 1e-6             # vertex-leak beams allowed, share of beams swept


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def grid_of(m):
    """The map's culling tile grid, as tile_snake_key takes it."""
    tm = m.tile_meta_host
    return dict(tile_size=1.0 / tm[2], origin=(tm[0], tm[1]))


def bench_poses(m, seed, **kw):
    """(ENVS, AGENTS, 3) start poses of the bench sampler (bench.py:201-208)
    on the map's device, in tile-snake order."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.parallel.vector import tile_snake_key

    sampler = P.uniform_pose_sampler(m, clearance=0.6, grouped=True,
                                     align_theta=True, **kw)
    poses = sampler(P.make_generator(m.device, seed), (ENVS, AGENTS))
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


def main_path(m, tables, poses):
    """The bench racing step on ``m`` from ``poses``: returns the reset
    states and ``drive(states, n_steps) -> (states, dones)``, which steps
    with the gap-follow policy and re-sorts for locality every
    SORT_PERIOD steps."""
    import f1tenth_gym_tpu_torch as P

    dev = m.device
    cfg = P.SimConfig(num_agents=AGENTS, num_beams=BEAMS, dtype="float32",
                      scan_engine="kernel")
    params = P.VehicleParams.create(device=dev)
    gen = P.make_generator(dev, 0)
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               generator=gen, device=dev)
    astep = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                  reset_to_start=True, generator=gen,
                                  device=dev)
    sort_kw = grid_of(m)

    def drive(s, n_steps):
        dones = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(n_steps):
            if i % SORT_PERIOD == 0:
                s = P.sort_envs_for_locality(s, **sort_kw)
            s, _, _, done, _ = astep(s, gap_follow(s.scans))
            dones += done.sum()
        return s, dones

    return states, drive


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.maps import map_path
    from f1tenth_gym_tpu_torch.ops import collision as col_ops
    from f1tenth_gym_tpu_torch.ops import lidar as lidar_ops
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
    from f1tenth_gym_tpu_torch.utils import native

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build: nvcc and g++ side by side
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        f_cuda = pool.submit(sk.build_cuda)
        f_native = pool.submit(native.build)
        ptxas = f_cuda.result()
        f_native.result()
    build_s = time.time() - t0
    report = [ln.strip() for ln in ptxas.splitlines()
              if "registers" in ln or "spill" in ln]
    emit("build", seconds=build_s, ptxas=report)

    # ---- 2. maps (tile packs are disk-cached under the package's _build/)
    def timed_load(name, **kw):
        t = time.time()
        m = P.load_map(map_path(name), extract_segments=True,
                       tile_culling=True, device=dev, **kw)
        return m, time.time() - t

    maps, host_s = {}, {}
    maps["example_map"], host_s["example_map"] = timed_load(
        "example_map", culling_tile_size=1.25)
    for name in ("berlin", "stata_basement"):
        maps[name], host_s[name] = timed_load(name)
    split, host_s["compact_split"] = timed_load(
        "compact", culling_tile_size=2.0, culling_split_cap=96)
    require(split.tile_ext is not None, "compact split pack has no extras")
    emit("maps", host_seconds=host_s, packs={
        name: {"seg_table": list(m.seg_table.shape),
               "tile_tables": list(m.tile_tables.shape),
               "eligible": m.cull_eligible is not None}
        for name, m in list(maps.items()) + [("compact_split", split)]})

    m_ex = maps["example_map"]
    tables = P.make_scan_tables(num_beams=BEAMS, device=dev)

    # ---- 3. kernel vs plain, bit for bit; culled vs full
    def sweeps(m, flat):
        return (sk.sweep(sk.prepare_map(flat, m, tables, BEAMS, THETA_DIS)),
                sk.sweep(sk.prepare_map(flat, m, tables, BEAMS, THETA_DIS,
                                        culled=False)))

    def kernel_vs_plain(m, flat, label):
        w_c = sk.prepare_map(flat, m, tables, BEAMS, THETA_DIS, culled=True)
        w_f = sk.prepare_map(flat, m, tables, BEAMS, THETA_DIS, culled=False)
        k_c, k_f = sk.sweep(w_c), sk.sweep(w_f)
        p_c, p_f = sk.sweep_plain(w_c), sk.sweep_plain(w_f)
        torch.cuda.synchronize()
        require(torch.equal(k_c, p_c), f"{label}: culled kernel != plain, "
                f"max |d| {float((k_c - p_c).abs().max())}")
        require(torch.equal(k_f, p_f), f"{label}: full kernel != plain, "
                f"max |d| {float((k_f - p_f).abs().max())}")
        require(bool(torch.isfinite(k_c).all()), f"{label}: non-finite")
        stats = dict(scans=flat.shape[0], culled_subgroups=int(
            (w_c.bid > 0).sum()), subgroups=int(w_c.bid.numel()),
            mean_swept_rows=float(w_c.swept_rows().float().mean()),
            extras_rows=int(w_c.ecnt.sum()) * sk.GROUP)
        return k_c, k_f, stats

    def leak_beams(m, flat, k_c, k_f, label):
        """Count the beams on which culled != full, and require each to be
        a vertex leak: a beam through the shared vertex of two wall
        segments can fail both f32 hit tests and pass through the wall
        (the TPU kernel's formulation, kept bit for bit;
        tests/test_torch_scan_kernel.py pins one such beam on the split
        pack), and the full sweep then finds a wall behind it that the
        culled table rightly left out. So both sweeps must overshoot the
        marched range by more than the contour tolerance: a culled table
        missing a visible wall fails this, since the full sweep would then
        agree with the march."""
        n = flat.shape[0]
        diff = k_c[:n] != k_f[:n]
        rows = diff.any(-1).nonzero().flatten()
        if rows.numel():
            march = lidar_ops.get_scan(flat[rows], m, tables, BEAMS,
                                       THETA_DIS)
            d = diff[rows]
            nearer = torch.minimum(k_c[rows][d], k_f[rows][d])
            require(bool((march[d] < nearer - 0.5).all()),
                    f"{label}: culled != full on a beam that is no leak")
        return int(diff.sum())

    poses_ex = bench_poses(m_ex, 7, component_seed=(0.7, 0.0))
    flat = poses_ex.reshape(-1, 3)
    k_c, k_f, st_ex = kernel_vs_plain(m_ex, flat, "example_map")
    st_ex["culled_ne_full_beams"] = int((k_c[:flat.shape[0]]
                                         != k_f[:flat.shape[0]]).sum())
    require(st_ex["culled_ne_full_beams"] == 0,
            f"example_map: culled != full on {st_ex['culled_ne_full_beams']}"
            " beams")
    leaks = {}
    for seed in LEAK_SEEDS:
        flat = bench_poses(split, seed).reshape(-1, 3)
        if seed == LEAK_SEEDS[0]:
            k_c, k_f, st_split = kernel_vs_plain(split, flat, "compact_split")
            require(st_split["extras_rows"] > 0, "split pack swept no extras")
        else:
            k_c, k_f = sweeps(split, flat)
        leaks[seed] = leak_beams(split, flat, k_c, k_f,
                                 f"compact_split seed {seed}")
    swept = len(LEAK_SEEDS) * ENVS * AGENTS * BEAMS
    st_split.update(leak_beams_by_seed=leaks, beams_swept=swept)
    require(sum(leaks.values()) <= LEAK_CAP * swept,
            f"compact_split: {sum(leaks.values())} leak beams in {swept}")
    emit("kernel_vs_plain", example_map=st_ex, compact_split=st_split)

    # ---- 4. gates of bench.py:230-289
    def inside_raster(m, cp, ranges):
        """(n, B) bool: the marched beam ends inside the map raster. A
        march that leaves the raster stops on the reference's wrapped
        out-of-bounds cell (ops/lidar.py dt_lookup), which is no wall to
        the segment sweep: those beams measure the map's open edges, not
        the kernel (tests/test_torch_gate.py shows the JAX package's
        engines part the same way on the same poses)."""
        idx = lidar_ops.beam_theta_indices(cp[:, 2], tables, BEAMS, THETA_DIS)
        xt = cp[:, 0:1] + ranges * tables.cosines[idx] - m.orig_x
        yt = cp[:, 1:2] + ranges * tables.sines[idx] - m.orig_y
        xr = xt * m.orig_c + yt * m.orig_s
        yr = -xt * m.orig_s + yt * m.orig_c
        return ((xr >= 0) & (xr < m.width * m.resolution)
                & (yr >= 0) & (yr < m.height * m.resolution))

    mse, mse_all, left, pose_sum = {}, {}, {}, {}
    checks = {"example_map": poses_ex[:32].reshape(-1, 3)}
    for name in ("berlin", "stata_basement"):
        # the gate sampler of bench.py:258, drawn on the CPU so that the
        # poses are the same on every machine (tests/test_torch_gate.py
        # draws them too)
        host_map = P.load_map(map_path(name), device="cpu")
        checks[name] = P.uniform_pose_sampler(host_map, clearance=0.5)(
            P.make_generator("cpu", 11), (32,)).to(dev)
    for name, cp in checks.items():
        march = lidar_ops.get_scan(cp, maps[name], tables, BEAMS, THETA_DIS)
        kern = sk.scan(cp, maps[name], tables, BEAMS, THETA_DIS, device=dev)
        inside = inside_raster(maps[name], cp, march)
        d2 = (march - kern) ** 2
        mse[name] = float(d2[inside].mean())
        mse_all[name] = float(d2.mean())
        left[name] = int((~inside).sum())
        pose_sum[name] = float(cp.double().sum())
        require(mse[name] < 2.0, f"kernel vs march MSE {mse[name]} on {name}")
    vel = torch.full((2,), 8.0, device=dev)
    hot = lidar_ops.check_ttc(torch.full((2, BEAMS), 0.18, device=dev), vel,
                              tables)
    cold = lidar_ops.check_ttc(torch.full((2, BEAMS), 25.0, device=dev), vel,
                               tables)
    require(bool(hot.all()) and not bool(cold.any()), "iTTC gate")
    params = P.VehicleParams.create(device=dev)
    overlap = col_ops.get_vertices(torch.tensor(
        [[0.0, 0.0, 0.0], [0.1, 0.0, 0.5]], device=dev), params.length,
        params.width)
    apart = col_ops.get_vertices(torch.tensor(
        [[0.0, 0.0, 0.0], [5.0, 0.0, 0.5]], device=dev), params.length,
        params.width)
    c_hot, _ = col_ops.collision_multiple(overlap)
    c_cold, _ = col_ops.collision_multiple(apart)
    require(bool((c_hot > 0).all()) and not bool((c_cold > 0).any()),
            "collision gate")
    emit("gates", scan_mse_by_map=mse, scan_mse_all_beams=mse_all,
         beams_leaving_raster=left, beams_per_map=32 * BEAMS,
         gate_pose_sum=pose_sum, ittc_collision_gate="ok")

    # ---- 5. main path: the bench racing step on the port
    states, drive = main_path(m_ex, tables, poses_ex)
    s, _ = drive(states, WARMUP)
    torch.cuda.synchronize()
    sk.sweep.launches = 0
    t0 = time.time()
    s, dones = drive(s, STEPS)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = sk.sweep.launches
    dones = int(dones)
    require(launches == STEPS, f"{launches} kernel launches in {STEPS} steps")
    sc = s.scans
    require(bool(torch.isfinite(sc).all()), "non-finite scans")
    require(bool((sc[s.steps > 0] > 0).all())
            and float(sc.max()) <= 30.0 + 5 * 0.01, "scans out of (0, 30+5s]")
    require(dones > 0 and bool((s.steps < int(s.steps.max())).any()),
            "no env was done and reset")
    rate = ENVS * STEPS / elapsed
    emit("main_path", envs=ENVS, agents=AGENTS, beams=BEAMS, steps=STEPS,
         seconds=elapsed, env_steps_per_s=rate, dones=dones,
         kernel_launches=launches)

    # ---- 6. kernel timing at the main path's shapes, mid sort period
    s, _ = drive(s, SORT_PERIOD // 2)
    pose = torch.stack([s.x[..., 0], s.x[..., 1], s.x[..., 4]], -1)
    w_c = sk.prepare_map(pose.reshape(-1, 3), m_ex, tables, BEAMS, THETA_DIS)
    w_f = sk.prepare_map(pose.reshape(-1, 3), m_ex, tables, BEAMS, THETA_DIS,
                         culled=False)

    def cuda_ms(fn, iters):
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

    k_c = sk.sweep(w_c)
    p_c = sk.sweep_plain(w_c)
    max_err = float((k_c - p_c).abs().max())
    require(max_err == 0.0, f"main-path kernel != plain: {max_err}")
    ms_culled = cuda_ms(lambda: sk.sweep(w_c), 50)
    ms_full = cuda_ms(lambda: sk.sweep(w_f), 20)
    ms_plain = cuda_ms(lambda: sk.sweep_plain(w_c), 3)
    rows = w_c.swept_rows().double()
    ops = float(rows.sum()) * BEAMS * HIT_OPS
    n_pad = w_c.scal.shape[0]
    in_bytes = sum(t.numel() * t.element_size() for t in (
        w_c.scal, w_c.fan, w_c.full, w_c.tabs, w_c.bid, w_c.ng, w_c.est,
        w_c.ecnt))
    out_bytes = n_pad * BEAMS * 4
    t_ops = ops / H100_F32_FLOPS * 1e3
    t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    emit("kernel_timing", ms_culled=ms_culled, ms_full=ms_full,
         plain_ms=ms_plain, bound_ms=max(t_ops, t_bytes), ops=ops,
         bytes=in_bytes + out_bytes,
         mean_swept_rows=float(rows.mean()),
         mean_swept_groups=float(rows.mean()) / sk.GROUP,
         culled_subgroups=int((w_c.bid > 0).sum()),
         subgroups=int(w_c.bid.numel()))

    print(json.dumps({"kernels": [{
        "name": "scan_kernel",
        "route": "cuda",
        "source": "f1tenth_gym_tpu_torch/csrc/scan_kernel.cu",
        "replaces": "f1tenth_gym_tpu/ops/pallas_scan.py:168",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms_culled,
        "ms_full": ms_full,
        "plain_ms": ms_plain,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
