"""Drive the PyTorch port (f1tenth_gym_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. build   — the CUDA scan, overlay and opponent clip kernels (nvcc,
             sm_90a) and the native host library (g++), all started
             together; each
             kernel's registers, shared memory and spills, and its resident
             blocks an SM and waves at the main path's shape;
2. maps    — example_map culled at 1.25 m tiles, berlin and stata_basement
             culled at the default 2.5 m, compact with a split pack;
3. kernel  — the scan kernel against its plain torch version on 8192 bench
             poses, bit for bit, culled and full, and culled == full bit
             for bit on example_map; the same on the split pack, whose
             per-scan extras sweep runs, where culled == full except on
             beams that leak through a wall vertex: over eight seeds every
             differing beam must be such a leak, and they may be at most
             1e-6 of the beams; the same on berlin and stata_basement,
             on their 32 gate poses and on 8192 bench poses each; on every
             input the plain transcription of the kernel's row skip keeps
             every pair that hits (its kept and hit shares are printed);
4. overlay — the overlay kernel's path, ``overlay_opponents`` on the 8192
             bench scans, each clipped by the other agent's box (O = 1),
             one launch; then the kernel against its plain torch version
             bit for bit there and on a fuzz ensemble of 4096 scans with
             three opponents each, against the racing step's
             ``ray_cast_opponents`` within 2e-3 m except on at most 1e-6
             of the beams, each at the edge of its blocked-view window
             (a beam grazing a box corner), and its times beside the
             bound;
4b. opp_clip — K3, the racing step's opponent clip: the clip's own
             inputs at step CLIP_STEP of the benchmark's racing step
             (example_map, 16,384 envs x 2 agents x 1080 beams) and the
             fuzz ensemble (``ops/opp_clip_fuzz.py``: 4096 envs of 2 and
             4 agents, 1080 and 1081 beams, power-of-two and default scan
             tables; 8 envs of CLIP_MANY_AGENTS, more opponents than one
             chunk of K3's shared memory), in float32 and float64: K3 ==
             its plain version bit for bit after each synchronised launch;
             CLIP_PARITY_STEPS steps with K3 against the same steps
             with the plain clip from the same state and noise, every
             state leaf bit for bit, one launch a step; K3's time at
             32,768 scans beside the plain version's, a copy of the scans
             and the bytes bound;
5. gates   — kernel vs marching engine MSE < 2.0 on the three maps
             (32 poses each, over the beams whose march stays inside the
             map raster; the all-beam MSE is printed beside it), the iTTC
             and the SAT collision spot checks;
6. segments — the segments engine vs the march, MSE < 2.0 on example_map
             and berlin over the same beams, and a batch step with it;
7. scan_sim — ScanSimulator2D: the kernel engine with its culled pack
             equals the kernel scan bit for bit on the 8192 bench poses,
             and its segments engine passes the MSE bar against its march;
8. main    — the bench racing step: 4096 envs x 2 agents x 1080 beams,
             auto-reset to each env's start grid, gap-follow policy,
             locality re-sort every 16 steps; 16 warm-up + 256 timed steps;
             one scan-kernel and one opponent-clip launch per step, no
             overlay launch;
9. timing  — times of the scan kernel (culled, full, and culled with its
             row skip off) and of the plain version at the main path's
             shapes, beside the bound recounted from the pairs that hit
             and the table rows read;
10. f110env — the reference-compatible F110Env on the card ("auto", so the
             scan kernel): reset, 200 gap-follow steps with one kernel
             launch each, steps per second; then a few steps with the
             segments engine.
11. ppo     — the learner of f1tenth_gym_tpu_torch.train_ppo at the
             configuration of examples/train_ppo.py: compact culled, 1024
             one-agent envs x 1080 beams, float32, engine "pallas", scan
             noise on, PPOConfig() widths (hidden 256, 64 pooled beams,
             32 rollout steps, 4 epochs x 4 minibatches); one warm-up and
             PPO_ITERS timed iterations with one scan-kernel launch a
             rollout step and none of the overlay, finite metrics, a
             changed policy, scans in range; then the TrainState saved,
             loaded into a freshly built learner, and one more iteration
             from both: bit-identical parameters and env states;
12. planner — pure pursuit: the 500-step closed loop of
             tests/test_planner.py on the card (example_map, float64,
             march, no noise) within 1e-6 of the reference's actions and
             poses; then ``batched_policy`` on example_map's raceline
             through ``rollout(collect=False)``, PLAN_STEPS steps of the
             main path's 4096 x 2 x 1080 envs (its culled pack and start
             poses, engine "kernel"), one scan-kernel launch a step;
13. multi_track — the 16-track world of examples/domain_randomization.py
             (seed 0; its culling pack, neighborhood 2, 2.5 m tiles, windows
             capped at 64 groups, is built in a process of its own on the
             CPU from the start of the run, and its seconds printed): the
             scan kernel against its plain version bit for bit, culled and
             full, on the sampler's 8192 poses after the arc sort, culled ==
             full except on vertex leaks (at most LEAK_CAP), no hit pair
             dropped by the row skip; the share of subgroups that fall back
             to the full table under the arc sort, the square-block sort and
             none; tracks 0 and 15 from three racing-line poses, in the world
             and on the track's own map: the marching engine within 0.08 m
             (the same raster), the kernel within the gate's MSE of the
             march on each map, and its composed-vs-standalone difference
             printed (the two maps' contours are simplified apart);
14. domain_randomization — the example's rollout through its own
             functions: 4096 envs x 2 agents x 1080 beams on the world,
             engine "pallas", auto-reset to the start grid, arc sort every
             32 steps, gap-follow policy; 16 warm-up + 256 timed steps with
             one scan-kernel launch a step and none of the overlay, dones,
             scans in range, the distance from the start grid per track;
             the kernel's time at this shape beside its bound; then its
             --train learner: one warm-up and two timed PPO iterations with
             32 launches each and finite metrics;
15. trackgen — examples/waypoint_follow on the track of seed 9 written by
             save_track (F110Env "auto", so the kernel): 500 pure-pursuit
             steps without a collision; then on
             examples/config_example_map.yaml (50 steps); then
             examples/param_sweep at the yaml's budget (1000 envs, per-env
             mass and lf, per-env gains) for one 512-step chunk;
16. sharded — the sharded path (parallel/sharding.py, multihost.py,
             PPO(mesh=...), save_orbax/load_orbax). At world size 1 on the
             card: multihost.initialize() (no cluster variables: stays
             local), global_mesh(), host_local_states and shard_states;
             SHARD_STEPS steps of the main path's auto-reset step (scan
             noise off, no locality sort) bit for bit equal to the same
             steps unsharded, one K1 launch a step; PPO(mesh=make_mesh())
             at the ppo phase's configuration bit for bit equal to PPO()
             after one iteration and after SHARD_PPO_TURNS timed ones taken
             in turns (plain, mesh, mesh, plain). Then RANKS ranks on the
             one card over gloo (NCCL refuses two ranks on one device),
             spawned here: the main path's envs split between them,
             RANK_STEPS steps without scan noise, the stitched scans and
             states bit for bit the one-process run's; save_orbax of the
             ranks' states at world size RANKS, load_orbax at world size 1,
             bit for bit; one sharded PPO iteration of train_ppo's learner
             without scan noise, parameters within RANK_PPO_ATOL of one
             process's (the reduction order differs); each rank's K1
             launches;
17. bench  — ``python -m f1tenth_gym_tpu_torch.bench`` at its defaults
             (the main path's workload and gates on the card, then the
             weak-scaling stand-in over 1, 2, 4 and 8 gloo processes on
             the machine's CPU, whose rates say nothing about the card):
             the keys of its line, its gates under 2.0, one K1 launch a
             timed step;
18. tools  — the probes of f1tenth_gym_tpu_torch/tools in-process, at
             reduced reps and steps: ``kernel_phases`` (each masked output
             of K1 bit for bit its plain version on 8192 bench scans, and
             the three phase times); ``kernel_sweep`` at 1.25 m (the main
             path's pack, no split blocks) over warps 5, 9 and 16, chunk
             64 and 128, sub 4 and 8 (and 1, 2 and 16 at 9 warps of 128
             beams), the skip on and off, every row bit for bit the
             default row, and at 0.85 m and 2.5 m (split packs, the
             probe's split cap 96) over warps 9 and 16, bit for bit that
             size's default row, and sub 4 at 0.85 m held to the
             vertex-leak rule; ``step_trace single`` and ``multi`` (busy
             share in (0, 1], K1 in the profile with one launch a step);
             ``ppo_profile`` at world size 1 on the card (busy share) and
             over 2 gloo ranks on the one card (collective share in (0,
             1]); ``step_probe`` and ``step_variants`` (every key with a
             counterpart; their K2 launches); ``culling_stats`` and
             ``rect_tier_estimate`` at 1.25 m. Their packs at 0.85 m and
             2.5 m are built in a process of their own from the start of
             the run.

A kernel's time is the CUDA-event time a launch of a CUDA graph of
launches (``kernel_ms``), printed beside the eager launches' time and the
host's enqueue time a call, which is of the same order as the kernels.
Then the ``kernels`` line (K1's entry carries its launches on each path:
``launches`` on the main path, and those of the later phases, among them
``sharded_launches``, ``sharded_rank_launches``, ``bench_launches`` and
``tools_launches``; K2's carries the probes' ``tools_launches``; K3's
carries its main-path ``launches`` and those of phase 4b's step parity
run, ``parity_launches``),
the card's name and power limit, and the result line. Exits non-zero without a result when no CUDA device is present.
"""

import concurrent.futures
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from f1tenth_gym_tpu_torch.bench import bench_poses as _bench_poses
from f1tenth_gym_tpu_torch.ops.opp_clip_fuzz import (
    fuzz_opp_clip_inputs,
    opp_clip_tables,
    same_bits,
)
from f1tenth_gym_tpu_torch.bench import (
    gap_follow,
    gate_mse,
    gate_poses,
    grid_of,
    inside_raster,
    ittc_collision_gate,
    main_path,
)

H100_F32_FLOPS = 67e12      # float32 outside the tensor cores (SXM, 700 W)
H100_BYTES_PER_S = 3.35e12  # HBM3
HIT_OPS = 14                # operations per (beam, row) hit test
# overlay operations per in-window (beam, edge) pair: den (3), s (1),
# b (5), s - b (1), two compares (2), max (1)
PAIR_OPS = 13
ENVS, AGENTS, BEAMS, THETA_DIS = 4096, 2, 1080, 2000
WARMUP, STEPS, SORT_PERIOD = 16, 256, 16
LEAK_SEEDS = range(8, 16)   # bench-pose seeds swept on the split pack
LEAK_CAP = 1e-6             # vertex-leak beams allowed, share of beams swept
FUZZ_SCANS, FUZZ_OPPONENTS = 4096, 3
OVERLAY_ATOL = 2e-3         # overlay kernel vs ray_cast_opponents, metres
OVERLAY_CAP = 1e-6          # beams allowed beyond it, share of beams
# the opponent clip (K3): the benchmark's batch, the step whose clip
# inputs it is checked and timed on, and the steps of the step parity run
CLIP_ENVS, CLIP_STEP, CLIP_PARITY_STEPS = 16384, 40, 8
# agent counts above one chunk of opponents in K3's shared memory (16),
# on few envs: the plain clip's broadcast grows as A^2
CLIP_MANY_AGENTS, CLIP_MANY_ENVS = (18, 40, 64), 8
SEG_ENVS, SEG_STEPS = 64, 4
ENV_STEPS = 200             # F110Env gap-follow steps
PPO_MAP, PPO_ENVS, PPO_ITERS = "compact", 1024, 3  # examples/train_ppo.py
PLAN_STEPS = 64             # batched pure-pursuit rollout steps
CLOSED_LOOP_ATOL = 1e-6     # tests/test_planner.py::test_closed_loop_parity
DR_TRACKS, DR_SEED, DR_ENVS = 16, 0, 4096  # examples/domain_randomization.py
DR_PPO_ITERS = 2            # timed PPO iterations on the world
SOLO_ATOL = 0.08            # tests/test_multi_track.py: composed vs standalone
TRACK_STEPS, CONFIG_STEPS = 500, 50  # waypoint_follow steps
SWEEP_STEPS = 512           # param_sweep: one chunk
SHARD_STEPS = 64            # sharded racing steps at world size 1
SHARD_PPO_TURNS = 4         # timed PPO iterations, plain and mesh in turn
RANKS, RANK_STEPS = 2, 16   # ranks on the one card (gloo), their steps
RANK_PPO_ATOL = 1e-5        # 2-rank PPO parameters vs one process (f32)
RANK_TIMEOUT_S = 300.0
TOOL_REPS, TOOL_TRACE_STEPS, TOOL_SV_STEPS = 20, 4, 8   # phase tools
TOOL_RANKS = 2
# kernel_sweep rows (warps:chunk:ts:sub): the main path's pack at 1.25 m,
# and split packs (split cap 96, the probe's) at 0.85 m and 2.5 m
SWEEP_MAIN = [f"{w}:{c}:1.25:{s}" for w in (9, 5, 16) for c in (128, 64)
              for s in (8, 4)] + [f"9:128:1.25:{s}" for s in (1, 2, 16)]
SWEEP_SPLIT = ["9:128:0.85", "16:128:0.85", "9:128:0.85:4", "9:128:2.5",
               "16:128:2.5"]
SWEEP_SPLIT_CAP = 96
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "scan_mse_by_map",
              "ittc_collision_gate", "weak_scaling_retention_8shard",
              "weak_scaling_total_rates")
ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bench_poses(m, seed, **kw):
    """(ENVS, AGENTS, 3) start poses of the bench sampler on the map's
    device, in tile-snake order (``bench.bench_poses``)."""
    return _bench_poses(m, seed, ENVS, AGENTS, **kw)


# cuda_ms, kernel_ms and other_agent_boxes are tools/common.py's too: they
# stay defined here because ab_kernels.py loads this module's helpers with
# another tree's package, which may predate the tools
def cuda_ms(fn, iters):
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


def kernel_ms(fn, iters):
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


def k1_bound(w, pairs):
    """K1's bound on the prepared sweep ``w``: HIT_OPS for each pair whose
    beam lies in the row's arc (``pairs``, ``sk.pair_counts(w)``: the least
    work the sweep needs on these inputs), against the bytes: the output,
    each table row some scan sweeps once (a subgroup's block and the
    extras, 32 B a row), the scalars, the fan and the selection (the
    extras' start and count only where the pack has them). The bound over
    all swept pairs is kept beside it."""
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    table_rows = sk.rows_read(w)
    selection = (w.bid, w.ng) + ((w.est, w.ecnt) if w.has_extras else ())
    in_bytes = table_rows * 8 * 4 + sum(
        t.numel() * t.element_size() for t in (w.scal, w.fan) + selection)
    out_bytes = w.scal.shape[0] * w.num_beams * 4
    t_ops = pairs["hit"] * HIT_OPS / H100_F32_FLOPS * 1e3
    t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), ops_bound_ms=t_ops,
                bytes_bound_ms=t_bytes,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bytes=in_bytes + out_bytes, table_rows_read=table_rows,
                bound_ms_all_swept_pairs=max(
                    pairs["swept"] * HIT_OPS / H100_F32_FLOPS * 1e3, t_bytes))


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def other_agent_boxes(poses, params):
    """(E, 2, 3) poses -> (E, 2, 1, 4, 2): each agent's one opponent is
    the other agent's box (tools/step_probe.py:93-103)."""
    from f1tenth_gym_tpu_torch.ops import collision as col_ops

    verts = col_ops.get_vertices(poses, params.length, params.width)
    return verts.flip(1)[:, :, None]


def fuzz_overlay_inputs(n, O, params, dev, seed=0):
    """Scans, scan poses and opponent boxes 0.5-12 m away in every
    direction, drawn like tests/test_pallas_scan.py:123-138 (on the host,
    from ``seed``)."""
    from f1tenth_gym_tpu_torch.ops import collision as col_ops

    rng = np.random.default_rng(seed)
    poses = np.stack([rng.uniform(-6, 6, n), rng.uniform(-6, 6, n),
                      rng.uniform(0, 2 * np.pi, n)], axis=1)
    ang = rng.uniform(0, 2 * np.pi, (n, O))
    dist = rng.uniform(0.5, 12.0, (n, O))
    opp = np.stack([poses[:, None, 0] + dist * np.cos(ang),
                    poses[:, None, 1] + dist * np.sin(ang),
                    rng.uniform(0, 2 * np.pi, (n, O))], axis=-1)
    scans = rng.uniform(2.0, 30.0, (n, BEAMS))

    def dev_f32(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    verts = col_ops.get_vertices(dev_f32(opp), params.length, params.width)
    return dev_f32(scans), dev_f32(poses), verts


def overlay_phase(bench_scans, bench_poses, tables, params, card_name):
    """The overlay kernel's path and checks at the probe's shape (module
    docstring, phase 4). Returns the kernel's entry of the kernels line."""
    from f1tenth_gym_tpu_torch.ops import collision as col_ops
    from f1tenth_gym_tpu_torch.ops import overlay_kernel as ok

    dev = bench_scans.device
    scans = bench_scans.reshape(ENVS, AGENTS, BEAMS)
    opp = other_agent_boxes(bench_poses, params)

    # the path: one call of the entry point a user makes, counted
    ok.overlay.launches = 0
    out = ok.overlay_opponents(scans, bench_poses, opp, tables, BEAMS,
                               device=dev)
    torch.cuda.synchronize()
    launches = ok.overlay.launches
    require(launches == 1, f"overlay_opponents made {launches} launches")
    require(bool(torch.isfinite(out).all()), "overlay: non-finite scans")

    def check(label, scans, poses, opp):
        """Kernel == plain bit for bit; kernel vs ray_cast_opponents."""
        O = opp.shape[-3]
        w = ok.prepare_overlay(scans.reshape(-1, BEAMS), poses.reshape(-1, 3),
                               opp.reshape(-1, O, 4, 2), tables, BEAMS)
        k, p = ok.overlay(w), ok.overlay_plain(w)
        torch.cuda.synchronize()
        require(torch.equal(k, p), f"overlay {label}: kernel != plain, max "
                f"|d| {float((k - p).abs().max())}")
        ref = col_ops.ray_cast_opponents(poses, scans, opp,
                                         tables).reshape(-1, BEAMS)
        d = (k - ref).abs()
        far = (d > OVERLAY_ATOL).nonzero()
        # where the far beams lie: beams from the nearest window edge
        lo, hi = w.rows[far[:, 0], ::4, 6], w.rows[far[:, 0], ::4, 7]
        j = far[:, 1:2].float()
        edge = torch.minimum((j - lo).abs(), (j - hi).abs()).amin(-1)
        fired = int((k != w.scans).sum())
        require(fired > 0, f"overlay {label}: no beam was clipped")
        # the two passes may part only on a beam that grazes a box corner
        # at the edge of its blocked-view window, and on few of those
        # (tests/test_torch_overlay.py::test_bench_grazes_side_with_float64
        # recomputes the bench's in float64)
        require(far.shape[0] <= OVERLAY_CAP * k.numel()
                and bool((edge <= 1).all()),
                f"overlay {label}: {far.shape[0]} beams beyond "
                f"{OVERLAY_ATOL} m of ray_cast_opponents, "
                f"{int((edge > 1).sum())} inside their window")
        return w, k, dict(
            scans=k.shape[0], opponents=O, clipped_beams=fired,
            max_abs_err_vs_plain=float((k - p).abs().max()),
            beams_beyond_atol=far.shape[0], beams=k.numel(),
            # each such beam with its f32 inputs, exact in JSON, for a
            # float64 recomputation on the host
            beyond_atol=[dict(scan=a, beam=b, overlay=float(k[a, b]),
                              ray_cast=float(ref[a, b]),
                              scan_in=float(w.scans[a, b]),
                              beams_from_window_edge=e,
                              pose=poses.reshape(-1, 3)[a].tolist(),
                              boxes=opp.reshape(-1, O, 4, 2)[a].tolist())
                         for (a, b), e in zip(far.tolist()[:20],
                                              edge.tolist()[:20])],
            max_abs_err_inside_atol=float(d[d <= OVERLAY_ATOL].max()))

    w, k, st_bench = check("bench", scans, bench_poses, opp)
    require(torch.equal(k.view_as(out), out),
            "overlay_opponents != the prepared kernel call")
    fz = fuzz_overlay_inputs(FUZZ_SCANS, FUZZ_OPPONENTS, params, dev)
    _, _, st_fuzz = check("fuzz", *fz)
    emit("overlay", path_launches=launches, bench=st_bench, fuzz=st_fuzz)

    # timing at the probe's shape: 8192 scans, one opponent box each
    t_k = kernel_ms(lambda: ok.overlay(w), 50)
    ms = t_k["ms"]
    # the memory's floor for these bytes: a copy of the scans
    copy_ms = kernel_ms(lambda: w.scans.clone(), 50)["ms"]
    plain_ms = cuda_ms(lambda: ok.overlay_plain(w), 5)
    ray_ms = cuda_ms(lambda: col_ops.ray_cast_opponents(
        bench_poses, scans, opp, tables), 20)
    # bytes: scans read once and written once, rows, scalars and fan read
    # once; operations: PAIR_OPS for each in-window (beam, edge) pair
    in_bytes = sum(t.numel() * t.element_size()
                   for t in (w.scans, w.rows, w.scal, w.fan))
    out_bytes = w.scans.numel() * 4
    pairs = w.window_pairs()
    t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    t_ops = pairs * PAIR_OPS / H100_F32_FLOPS * 1e3
    emit("overlay_timing", card=card_name, ms=ms,
         eager_ms=t_k["eager_ms"], enqueue_us=t_k["enqueue_us"],
         plain_ms=plain_ms, ray_cast_opponents_ms=ray_ms,
         bound_ms=max(t_ops, t_bytes), bound_share=max(t_ops, t_bytes) / ms,
         scans_copy_ms=copy_ms,
         bytes=in_bytes + out_bytes, window_pairs=pairs,
         ops=pairs * PAIR_OPS, occupancy=ok.occupancy(*w.scans.shape))
    return {
        "name": "overlay_kernel",
        "route": "cuda",
        "source": "f1tenth_gym_tpu_torch/csrc/overlay_kernel.cu",
        "replaces": "f1tenth_gym_tpu/ops/pallas_scan.py:712",
        "launches": launches,
        "max_abs_err": st_bench["max_abs_err_vs_plain"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "ray_cast_opponents_ms": ray_ms,
        "enqueue_us": t_k["enqueue_us"],
    }


def opp_clip_phase(m, tables, params, card_name):
    """K3, the opponent clip (module docstring, phase 4b). Returns the
    kernel's entry of the kernels line."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.ops import opp_clip_kernel as oc

    dev = tables.fov.device
    cfg = P.SimConfig(num_agents=AGENTS, num_beams=BEAMS, dtype="float32",
                      scan_engine="kernel", scan_noise=True)
    gen = P.make_generator(dev, 0)
    poses = _bench_poses(m, 7, CLIP_ENVS, AGENTS, component_seed=(0.7, 0.0))
    s, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01, generator=gen,
                          device=dev)
    astep = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                  reset_to_start=True, generator=gen,
                                  device=dev)
    sort_kw = grid_of(m)

    def drive(s, n):
        for _ in range(n):
            s = astep(s, gap_follow(s.scans))[0]
        return s

    s = drive(P.sort_envs_for_locality(s, **sort_kw), CLIP_STEP - 1)

    # the racing step's own inputs to the clip, at step CLIP_STEP
    real = oc._opp_clip_cuda
    seen = {}

    def keep(x, scans, vertices, t):
        seen["in"] = (x.clone(), scans.clone(), vertices.clone())
        return real(x, scans, vertices, t)

    oc._opp_clip_cuda = keep
    try:
        s = drive(s, 1)
    finally:
        oc._opp_clip_cuda = real
    x, scans, verts = seen["in"]

    # K3 == plain, bit for bit, each launch synchronised; the largest
    # difference over the beams that are not NaN in both
    checks = {}

    def check(label, x, scans, verts, t):
        before = oc.opp_clip.launches
        got = oc.opp_clip(x, scans, verts, t)
        torch.cuda.synchronize()
        require(oc.opp_clip.launches == before + 1, f"opp_clip {label}: "
                f"{oc.opp_clip.launches - before} launches")
        want = oc.opp_clip_plain(x, scans, verts, t)
        require(same_bits(got, want), f"opp_clip {label}: K3 != plain on "
                f"{int((got != want).sum())} beams")
        both_nan = torch.isnan(got) & torch.isnan(want)
        err = torch.where((got == want) | both_nan, 0.0,
                          (got - want).abs()).max()
        checks[label] = dict(scans=got.numel() // got.shape[-1],
                             clipped=int((got != scans).sum()),
                             max_abs_err=float(err))

    t64 = P.make_scan_tables(num_beams=BEAMS, dtype=torch.float64,
                             device=dev)
    check("bench_f32", x, scans, verts, tables)
    check("bench_f64", x.double(), scans.double(), verts.double(), t64)
    for dt in (torch.float32, torch.float64):
        for agents in (2, 4):
            for beams, exact in ((BEAMS, True), (BEAMS, False),
                                 (BEAMS + 1, True)):
                t = (opp_clip_tables(beams, dt, dev) if exact else
                     P.make_scan_tables(num_beams=beams, dtype=dt,
                                        device=dev))
                fz = fuzz_opp_clip_inputs(FUZZ_SCANS, agents, t,
                                          seed=agents + beams)
                check(f"fuzz_{str(dt)[6:]}_A{agents}_B{beams}"
                      f"{'_exact' if exact else ''}", *fz, t)
        # more opponents than one chunk of K3's shared memory holds
        for agents in CLIP_MANY_AGENTS:
            t = opp_clip_tables(BEAMS, dt, dev)
            fz = fuzz_opp_clip_inputs(CLIP_MANY_ENVS, agents, t, seed=agents)
            check(f"fuzz_{str(dt)[6:]}_A{agents}_B{BEAMS}_exact", *fz, t)

    # the step with K3 against the same steps with the plain clip: the
    # same states, bit for bit, and one launch a step
    start, g0 = s.map(torch.clone), gen.get_state()
    before = oc.opp_clip.launches
    s_k = drive(start, CLIP_PARITY_STEPS)
    torch.cuda.synchronize()
    parity_launches = oc.opp_clip.launches - before
    require(parity_launches == CLIP_PARITY_STEPS,
            f"opp_clip: {parity_launches} launches in {CLIP_PARITY_STEPS} "
            "steps")
    gen.set_state(g0)
    oc._opp_clip_cuda = oc.opp_clip_plain
    try:
        s_p = drive(start, CLIP_PARITY_STEPS)
    finally:
        oc._opp_clip_cuda = real
    torch.cuda.synchronize()
    for f in dataclasses.fields(s_k):
        require(same_bits(getattr(s_k, f.name), getattr(s_p, f.name)),
                f"opp_clip: the step with K3 parts from the plain clip's "
                f"in {f.name}")

    # times at the benchmark's 16,384 x 2 x 1080 (32,768 scans)
    t_k = kernel_ms(lambda: oc.opp_clip(x, scans, verts, tables), 50)
    copy_ms = kernel_ms(lambda: scans.clone(), 50)["ms"]
    plain_ms = cuda_ms(lambda: oc.opp_clip_plain(x, scans, verts, tables), 5)
    # bytes: scans read once and written once (the poses' three columns
    # and the boxes add 0.7 %)
    t_bytes = 2 * scans.numel() * 4 / H100_BYTES_PER_S * 1e3
    emit("opp_clip", card=card_name, checks=checks,
         step_parity_steps=CLIP_PARITY_STEPS, parity_launches=parity_launches,
         ms=t_k["ms"], eager_ms=t_k["eager_ms"], enqueue_us=t_k["enqueue_us"],
         plain_ms=plain_ms, bound_ms=t_bytes, bound_share=t_bytes / t_k["ms"],
         scans_copy_ms=copy_ms,
         occupancy=oc.occupancy(scans.numel() // BEAMS, AGENTS, BEAMS))
    return {
        "name": "opp_clip_kernel",
        "route": "cuda",
        "source": "f1tenth_gym_tpu_torch/csrc/opp_clip_kernel.cu",
        "replaces": None,
        "parity_launches": parity_launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        "ms": t_k["ms"],
        "plain_ms": plain_ms,
        "bound_ms": t_bytes,
        "bound_by": "bytes",
        "library_ms": None,
        "enqueue_us": t_k["enqueue_us"],
    }


def f110env_phase(start, dev):
    """F110Env on the card (module docstring, phase 10)."""
    from f1tenth_gym_tpu_torch.envs import F110Env
    from f1tenth_gym_tpu_torch.maps import map_path
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    def policy(obs):
        return gap_follow(torch.as_tensor(obs["scans"])).numpy()

    env = F110Env(map=map_path("example_map"), num_agents=AGENTS,
                  num_beams=BEAMS, device=dev)
    engine = env.cfg.resolved_scan_engine(dev, env.map_data.seg_table
                                          is not None)
    require(engine == "kernel", f"F110Env 'auto' resolved to {engine}")
    obs, _, done, _ = env.reset(start)
    torch.cuda.synchronize()
    sk.sweep.launches = 0
    resets = 0
    t0 = time.time()
    for _ in range(ENV_STEPS):
        if done:
            obs, _, done, _ = env.reset(start)
            resets += 1
        obs, _, done, _ = env.step(policy(obs))
        require(bool(np.isfinite(obs["scans"]).all()), "F110Env: non-finite")
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = sk.sweep.launches
    require(launches == ENV_STEPS + resets,
            f"F110Env: {launches} kernel launches in {ENV_STEPS} steps and "
            f"{resets} resets")

    seg = F110Env(map=map_path("example_map"), num_agents=AGENTS,
                  num_beams=BEAMS, scan_engine="segments", device=dev)
    sk.sweep.launches = 0
    obs, _, done, _ = seg.reset(start)
    for _ in range(SEG_STEPS):
        obs, _, done, _ = seg.step(policy(obs))
    require(bool(np.isfinite(obs["scans"]).all()) and sk.sweep.launches == 0,
            "F110Env segments engine")
    emit("f110env", engine=engine, steps=ENV_STEPS, resets=resets,
         seconds=elapsed, steps_per_s=ENV_STEPS / elapsed,
         kernel_launches=launches, segments_steps=SEG_STEPS,
         segments_min_range=float(obs["scans"].min()))


def scans_in_range(s, tables, label):
    """Every scan finite and in (0, max_range + 5 sigma]: the noise is
    added after the clamp, as in the reference. An env that an auto-reset
    has just replaced holds init_state's zero scans (steps 0) and is left
    out of the lower bound."""
    sc, sigma = s.scans, float(tables.scan_std)
    stepped = s.steps > 0
    require(bool(torch.isfinite(sc).all()), f"{label}: non-finite scans")
    require(float(sc.max()) <= float(tables.max_range) + 5 * sigma
            and bool((sc[stepped] > 0).all()),
            f"{label}: scans out of (0, max_range + 5 sigma]: min "
            f"{float(sc[stepped].min())}, max {float(sc.max())}")
    return dict(min=float(sc[stepped].min()), max=float(sc.max()),
                envs_just_reset=int((~stepped).sum()))


def ppo_phase(dev, card_name):
    """The learner of train_ppo at examples/train_ppo.py's configuration
    (module docstring, phase 11). Returns K1's launches in the timed
    iterations."""
    from f1tenth_gym_tpu_torch.ops import overlay_kernel as ok
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
    from f1tenth_gym_tpu_torch.state import SimState
    from f1tenth_gym_tpu_torch.train_ppo import make_learner
    from f1tenth_gym_tpu_torch.utils.checkpoint import load_pytree, save_pytree

    t_phase = time.time()
    ppo, ts = make_learner(PPO_MAP, PPO_ENVS, BEAMS, "pallas", dev)
    map_s = time.time() - t_phase
    T = ppo.pc.rollout_steps
    ts, _ = ppo.train_step(ts)  # warm-up
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in ts.net.parameters()]
    sk.sweep.launches = 0
    ok.overlay.launches = 0
    iters = []
    for _ in range(PPO_ITERS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        ts, traj, value_T = ppo.rollout(ts)
        ev[1].record()
        ts, metrics = ppo.update(ts, traj, value_T)
        ev[2].record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        met = {k: float(v) for k, v in metrics.items()}
        require(all(np.isfinite(v) for v in met.values()),
                f"ppo: non-finite metrics {met}")
        iters.append(dict(seconds=host_s,
                          env_steps_per_s=PPO_ENVS * T / host_s,
                          rollout_ms=ev[0].elapsed_time(ev[1]),
                          update_ms=ev[1].elapsed_time(ev[2]), **met))
    launches = sk.sweep.launches
    require(launches == T * PPO_ITERS,
            f"ppo: {launches} kernel launches in {PPO_ITERS} iterations of "
            f"{T} steps")
    require(ok.overlay.launches == 0, "ppo: the rollout launched the overlay")
    require(any(not torch.equal(a, b) for a, b in
                zip(before, ts.net.parameters())), "ppo: the policy is unchanged")
    scan_stats = scans_in_range(ts.env_states, ppo.tables, "ppo")
    # K1 at the rollout's shape, from the last step's poses
    x = ts.env_states.x
    w = sk.prepare_map(torch.stack([x[..., 0], x[..., 1], x[..., 4]],
                                   -1).reshape(-1, 3), ppo.map_data,
                       ppo.tables, BEAMS, THETA_DIS)
    k = sk.sweep(w)
    require(torch.equal(k, sk.sweep_plain(w)), "ppo shape: kernel != plain")
    k1 = kernel_ms(lambda: sk.sweep(w), 50)

    # resume: the TrainState into a freshly built learner, then one more
    # iteration from both
    with tempfile.TemporaryDirectory() as tmp:
        path = save_pytree(os.path.join(tmp, "train_state"), ts)
        ppo_b, ts_b = make_learner(PPO_MAP, PPO_ENVS, BEAMS, "pallas", dev)
        ts_b = load_pytree(path, target=ts_b)
    ts, _ = ppo.train_step(ts)
    ts_b, _ = ppo_b.train_step(ts_b)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in
                zip(ts.net.parameters(), ts_b.net.parameters())),
            "ppo: resumed parameters differ")
    for f in dataclasses.fields(SimState):
        a, b = getattr(ts.env_states, f.name), getattr(ts_b.env_states, f.name)
        require(a is None and b is None or torch.equal(a, b),
                f"ppo: resumed env state {f.name} differs")
    emit("ppo", card=card_name, map=PPO_MAP, envs=PPO_ENVS, agents=1,
         beams=BEAMS, hidden=ppo.pc.hidden, obs_beams=ppo.pc.obs_beams,
         rollout_steps=T, epochs=ppo.pc.epochs,
         minibatches=ppo.pc.minibatches, iterations=iters,
         env_steps_per_s=[i["env_steps_per_s"] for i in iters],
         kernel_launches=launches, overlay_launches=ok.overlay.launches,
         scans=scan_stats, k1_ms=k1, resume_bit_identical=True,
         map_seconds=map_s,
         seconds=time.time() - t_phase)
    return launches


def planner_phase(m, tables, poses, dev, card_name):
    """Pure pursuit on the card (module docstring, phase 12). Returns K1's
    launches in the batched rollout."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.maps import map_path
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
    from f1tenth_gym_tpu_torch.parallel import rollout
    from f1tenth_gym_tpu_torch.planning import PurePursuitPlanner, pure_pursuit_plan
    from f1tenth_gym_tpu_torch.utils.waypoints import load_waypoints

    t_phase = time.time()
    d = np.load(os.path.join(ROOT, "tests", "fixtures", "closed_loop.npz"))
    tlad, vgain = float(d["tlad"]), float(d["vgain"])
    f64 = torch.float64
    cfg = P.SimConfig(num_agents=1, scan_noise=False, dtype="float64",
                      scan_engine="march")
    params = P.VehicleParams.create(dtype=f64, device=dev)
    tables64 = P.make_scan_tables(dtype=f64, device=dev)
    m64 = P.load_map(map_path("example_map"), dtype=f64, device=dev)
    wpts = torch.as_tensor(d["wpts_xyv"], device=dev)
    state, obs, *_ = P.env_reset(torch.as_tensor(d["start"], device=dev)[None],
                                 params, m64, tables64, cfg, 0.01)
    acts, seen = [], []
    for _ in range(d["poses"].shape[0]):
        speed, steer = pure_pursuit_plan(
            obs["poses_x"][0, 0], obs["poses_y"][0, 0],
            obs["poses_theta"][0, 0], wpts, tlad, vgain, 0.17145 + 0.15875)
        acts.append(torch.stack([steer, speed]))
        state, obs, *_ = P.env_step(state, acts[-1].reshape(1, 1, 2), params,
                                    m64, tables64, cfg, 0.01)
        seen.append(torch.stack([obs["poses_x"][0, 0], obs["poses_y"][0, 0],
                                 obs["poses_theta"][0, 0]]))
    err_a = float(np.abs(torch.stack(acts).cpu().numpy() - d["actions"]).max())
    err_p = float(np.abs(torch.stack(seen).cpu().numpy() - d["poses"]).max())
    require(err_a <= CLOSED_LOOP_ATOL and err_p <= CLOSED_LOOP_ATOL,
            f"planner closed loop: actions {err_a}, poses {err_p} from the "
            "reference's")
    loop_s = time.time() - t_phase

    # batched pure pursuit on the main path's envs
    E, A = poses.shape[:2]
    planner = PurePursuitPlanner(
        load_waypoints(map_path("example_map")[:-5] + "_waypoints.csv"),
        device=dev)
    policy = planner.batched_policy(tlad, vgain)
    cfg = P.SimConfig(num_agents=A, num_beams=BEAMS, dtype="float32",
                      scan_engine="kernel")
    params = P.VehicleParams.create(device=dev)
    gen = P.make_generator(dev, 0)
    states, *_ = P.batch_reset(poses, params, m, tables, cfg, 0.01,
                               generator=gen, device=dev)
    astep = P.make_autoreset_step(params, m, tables, cfg, 0.01,
                                  reset_to_start=True, generator=gen,
                                  device=dev)

    def drive(s, n):
        return rollout(s, policy, n, params, m, tables, cfg, 0.01, gen,
                       step_fn=astep, collect=False)

    states, _ = drive(states, 2)  # warm-up
    torch.cuda.synchronize()
    sk.sweep.launches = 0
    t0 = time.perf_counter()
    s, (reward, dones) = drive(states, PLAN_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = sk.sweep.launches
    require(launches == PLAN_STEPS,
            f"planner: {launches} kernel launches in {PLAN_STEPS} steps")
    require(bool(torch.isfinite(reward)), "planner: non-finite reward")
    speed = float(s.x[..., 3].mean())
    require(speed > 0.1, f"planner: the cars do not drive ({speed} m/s)")
    emit("planner", card=card_name, closed_loop_steps=d["poses"].shape[0],
         closed_loop_max_action_err=err_a, closed_loop_max_pose_err=err_p,
         closed_loop_seconds=loop_s, envs=E, agents=A, beams=BEAMS,
         steps=PLAN_STEPS, seconds=elapsed,
         env_steps_per_s=E * PLAN_STEPS / elapsed, kernel_launches=launches,
         dones=int(dones), mean_speed=speed,
         scans=scans_in_range(s, tables, "planner"),
         phase_seconds=time.time() - t_phase)
    return launches


def start_world_build():
    """Build the domain-randomization world's culling pack in a process of
    its own, on the CPU, into the package's pack cache, while phases 1 and
    2 run. Returns the process; its one output line is a JSON object."""
    code = (
        "import json, time\n"
        "from f1tenth_gym_tpu_torch.tracks.multi import multi_track_map_data\n"
        "t = time.time()\n"
        f"m, _ = multi_track_map_data({DR_TRACKS}, seed={DR_SEED}, "
        "device='cpu')\n"
        "print(json.dumps(dict(seconds=time.time() - t, "
        "raster=list(m.dt.shape), pack=list(m.tile_tables.shape))))\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, text=True)


def start_sweep_packs():
    """Build example_map's split packs at the tile sizes of phase 18's
    knob sweep (SWEEP_SPLIT, split cap SWEEP_SPLIT_CAP) in a process of
    its own, on the CPU, into the pack cache. Returns the process; its one
    output line is a JSON object."""
    sizes = sorted({float(spec.split(":")[2]) for spec in SWEEP_SPLIT})
    code = (
        "import json, time\n"
        "import f1tenth_gym_tpu_torch as P\n"
        "from f1tenth_gym_tpu_torch.maps import map_path\n"
        "t = time.time()\n"
        f"for ts in {sizes!r}:\n"
        "    P.load_map(map_path('example_map'), extract_segments=True, "
        "tile_culling=True, culling_tile_size=ts, "
        f"culling_split_cap={SWEEP_SPLIT_CAP}, device='cpu')\n"
        "print(json.dumps(dict(seconds=time.time() - t)))\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, text=True)


def world_poses(world, sort):
    """The sampler's (DR_ENVS, AGENTS, 3) poses of ``world`` (generator
    seed 7, as ``make_world`` draws them), in the order ``sort`` gives the
    reset states: "arc" (the example's arc sort), "square"
    (``sort_envs_for_locality``) or "none"."""
    import f1tenth_gym_tpu_torch as P

    s = world.states
    if sort == "arc":
        s = world.sort(s)
    elif sort == "square":
        s = P.sort_envs_for_locality(s)
    return torch.stack([s.x[..., 0], s.x[..., 1], s.x[..., 4]], -1)


def multi_track_phase(world, tables, kernel_vs_plain, leak_beams, build,
                      card_name):
    """The 16-track world and K1 on it (module docstring, phase 13)."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.ops import lidar as lidar_ops
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
    from f1tenth_gym_tpu_torch.tracks.trackgen import (
        generate_centerline,
        rasterize_track,
    )

    m, dev = world.map_data, world.map_data.device
    flat = world_poses(world, "arc").reshape(-1, 3)
    k_c, k_f, stats = kernel_vs_plain(m, flat, "multi_track")
    leaks = leak_beams(m, flat, k_c, k_f, "multi_track")
    require(leaks <= LEAK_CAP * k_c.numel(),
            f"multi_track: {leaks} leak beams in {k_c.numel()}")
    full_share = {}
    for order in ("arc", "square", "none"):
        w = sk.prepare_map(world_poses(world, order).reshape(-1, 3), m,
                           tables, BEAMS, THETA_DIS)
        full_share[order] = float((w.bid == 0).double().mean())
    # composed vs standalone, from racing-line poses of two tracks: the
    # march (the raster is the same, so the scans are: the JAX test's
    # claim and bar), and K1 in the world (culled) and on the track's own
    # map (full table), each held to its march by the gate's MSE bar. The
    # two maps' wall contours are simplified from different starting
    # points, so K1's scans differ by the simplification, most on beams
    # that graze a wall: printed, not held to the march's bar
    solo = {}
    for k in (0, len(world.infos) - 1):
        center = generate_centerline(np.random.default_rng(DR_SEED + k))
        bitmap, res, origin = rasterize_track(center, 3.2)
        m_solo = P.make_map_data(bitmap, res, origin, extract_segments=True,
                                 device=dev)
        info = world.infos[k]
        n = len(center)
        idx = [int(n * f) for f in (0.2, 0.55, 0.8)]
        d = center[[(i + 1) % n for i in idx]] - center[idx]
        th = np.arctan2(d[:, 1], d[:, 0])
        poses = {
            "solo": np.stack([center[idx, 0], center[idx, 1], th], -1),
            "world": np.stack([info.waypoints[idx, 0],
                               info.waypoints[idx, 1], th], -1)}
        scans = {}
        for name, mm in (("solo", m_solo), ("world", m)):
            p = torch.as_tensor(poses[name], dtype=torch.float32, device=dev)
            scans[name] = (sk.scan(p, mm, tables, BEAMS, THETA_DIS,
                                   device=dev),
                           lidar_ops.get_scan(p, mm, tables, BEAMS,
                                              THETA_DIS))
        march_d = float((scans["solo"][1] - scans["world"][1]).abs().max())
        require(march_d < SOLO_ATOL, f"multi_track: track {k} composed vs "
                f"standalone march max |d| {march_d} m")
        k1_d = (scans["solo"][0] - scans["world"][0]).abs()
        mse = {name: float(((kk - mm) ** 2).mean())
               for name, (kk, mm) in scans.items()}
        require(max(mse.values()) < 2.0,
                f"multi_track: track {k} kernel vs march MSE {mse}")
        solo[k] = dict(march_max_m=march_d, k1_max_m=float(k1_d.max()),
                       k1_median_m=float(k1_d.median()),
                       k1_beams_beyond_bar=int((k1_d >= SOLO_ATOL).sum()),
                       beams=k1_d.numel(), k1_vs_march_mse=mse)
    emit("multi_track", card=card_name, tracks=len(world.infos),
         raster=list(m.dt.shape), seg_table_rows=m.seg_table.shape[0],
         pack=list(m.tile_tables.shape),
         pack_bytes=m.tile_tables.numel() * 4, tile_ext=m.tile_ext is not None,
         eligible=list(m.cull_eligible.shape), build_seconds=build,
         world_seconds=world.build_seconds, scans=flat.shape[0],
         kernel_vs_plain=stats, culled_ne_full_beams=leaks,
         full_table_share=full_share, composed_vs_standalone=solo,
         composed_vs_standalone_bar_m=SOLO_ATOL)


def domain_randomization_phase(world, tables, card_name):
    """The example's rollout and PPO on the world (module docstring, phase
    14). Returns K1's entry additions for the kernels line."""
    from f1tenth_gym_tpu_torch.examples import domain_randomization as dr
    from f1tenth_gym_tpu_torch.ops import overlay_kernel as ok
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    s, _, _ = dr.drive(world, world.states, WARMUP)
    torch.cuda.synchronize()
    sk.sweep.launches = 0
    ok.overlay.launches = 0
    t0 = time.time()
    s, dones, _ = dr.drive(world, s, STEPS)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches, dones = sk.sweep.launches, int(dones)
    require(launches == STEPS, f"domain_randomization: {launches} kernel "
            f"launches in {STEPS} steps")
    require(ok.overlay.launches == 0,
            "domain_randomization: the step launched the overlay")
    require(dones > 0, "domain_randomization: no env was done")
    scans = scans_in_range(s, tables, "domain_randomization")
    progress = dr.progress_per_track(s, world.infos)

    # K1 at this shape: the last step's poses, mid sort period
    x = s.x
    w = sk.prepare_map(torch.stack([x[..., 0], x[..., 1], x[..., 4]],
                                   -1).reshape(-1, 3), world.map_data,
                       tables, BEAMS, THETA_DIS)
    k = sk.sweep(w)
    require(torch.equal(k, sk.sweep_plain(w)),
            "domain_randomization shape: kernel != plain")
    pairs = sk.pair_counts(w)
    require(pairs["missed"] == 0, f"domain_randomization: {pairs}")
    t_k = kernel_ms(lambda: sk.sweep(w), 50)
    plain_ms = cuda_ms(lambda: sk.sweep_plain(w), 1)
    bound = k1_bound(w, pairs)
    emit("domain_randomization", card=card_name, envs=DR_ENVS, agents=AGENTS,
         beams=BEAMS, tracks=len(world.infos), steps=STEPS, seconds=elapsed,
         env_steps_per_s=DR_ENVS * STEPS / elapsed, dones=dones,
         kernel_launches=launches, overlay_launches=ok.overlay.launches,
         scans=scans, progress_per_track_m=progress, k1=t_k,
         k1_plain_ms=plain_ms, **bound,
         bound_share=bound["bound_ms"] / t_k["ms"],
         full_table_share=float((w.bid == 0).double().mean()),
         mean_swept_rows=float(w.swept_rows().double().mean()))

    # --train: PPO across all tracks on the same world
    ppo, ts = dr.make_learner(world)
    T = ppo.pc.rollout_steps
    ts, _ = ppo.train_step(ts)   # warm-up
    torch.cuda.synchronize()
    sk.sweep.launches = 0
    iters = []
    for _ in range(DR_PPO_ITERS):
        t0 = time.perf_counter()
        ts, metrics = ppo.train_step(ts)
        met = {key: float(v) for key, v in metrics.items()}
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        require(all(np.isfinite(v) for v in met.values()),
                f"domain_randomization ppo: non-finite metrics {met}")
        iters.append(dict(seconds=host_s, env_steps_per_s=DR_ENVS * T / host_s,
                          **met))
    ppo_launches = sk.sweep.launches
    require(ppo_launches == T * DR_PPO_ITERS,
            f"domain_randomization ppo: {ppo_launches} kernel launches in "
            f"{DR_PPO_ITERS} iterations of {T} steps")
    emit("domain_randomization_ppo", card=card_name, envs=DR_ENVS,
         agents=AGENTS, rollout_steps=T, iterations=iters,
         kernel_launches=ppo_launches,
         scans=scans_in_range(ts.env_states, tables, "dr ppo"))
    return dict(multi_track_launches=launches, multi_track_ms=t_k["ms"],
                multi_track_plain_ms=plain_ms,
                multi_track_bound_ms=bound["bound_ms"],
                multi_track_bound_by=bound["bound_by"],
                multi_track_ppo_launches=ppo_launches)


def trackgen_phase(dev, card_name):
    """A generated track, the experiment yaml and the parameter sweep on
    the card (module docstring, phase 15). Returns K1's launches."""
    from f1tenth_gym_tpu_torch.examples import param_sweep, waypoint_follow
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, argv, steps in (
                ("generated", ["--seed", "9", "--track-dir", tmp,
                               "--steps", str(TRACK_STEPS)], TRACK_STEPS),
                ("config", ["--config", os.path.join(
                    ROOT, "examples", "config_example_map.yaml"),
                    "--steps", str(CONFIG_STEPS)], CONFIG_STEPS)):
            sk.sweep.launches = 0
            r = waypoint_follow.main(argv + ["--device", str(dev)])
            torch.cuda.synchronize()
            require(r["steps"] == steps and r["collisions"] == [0.0],
                    f"trackgen {label}: {r}")
            require(sk.sweep.launches == steps + 1,   # the reset's too
                    f"trackgen {label}: {sk.sweep.launches} kernel launches")
            out[label] = dict(r, steps_per_s=steps / r["seconds"],
                              kernel_launches=sk.sweep.launches)
    sk.sweep.launches = 0
    r = param_sweep.main(["--steps", str(SWEEP_STEPS), "--device", str(dev)])
    torch.cuda.synchronize()
    launches = sk.sweep.launches
    require(launches == SWEEP_STEPS and r["poses_finite"],
            f"param_sweep: {launches} kernel launches, finite "
            f"{r['poses_finite']}")
    r.pop("states")
    emit("trackgen", card=card_name, **out,
         param_sweep=dict(r, kernel_launches=launches))
    return dict(trackgen_launches=sum(v["kernel_launches"]
                                      for v in out.values()),
                param_sweep_launches=launches)


def equal_states(a, b):
    """The names of the SimState fields on which ``a`` and ``b`` differ."""
    from f1tenth_gym_tpu_torch.state import SimState

    return [f.name for f in dataclasses.fields(SimState)
            if not torch.equal(getattr(a, f.name), getattr(b, f.name))]


def max_param_diff(a, b):
    """The largest |difference| between two flax parameter dicts."""
    if isinstance(a, dict):
        return max(max_param_diff(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float64) - b).max())


def sharded_rank(rank, nprocs, port, device_type, ckpt):
    """One of RANKS ranks on the one card over gloo (module docstring,
    phase 16): its rows of the main path's envs after RANK_STEPS steps,
    written to ``ckpt`` with save_orbax too; one sharded PPO iteration of
    train_ppo's learner without scan noise; its K1 launches."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.maps import map_path
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
    from f1tenth_gym_tpu_torch.parallel import multihost
    from f1tenth_gym_tpu_torch.parallel.sharding import env_shard, local_device
    from f1tenth_gym_tpu_torch.state import SimState
    from f1tenth_gym_tpu_torch.train_ppo import make_learner
    from f1tenth_gym_tpu_torch.utils.checkpoint import save_orbax
    from f1tenth_gym_tpu_torch.utils.convert import actor_critic_to_numpy

    t0 = time.time()
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=nprocs, process_id=rank,
                         backend="gloo", devices=device_type)
    mesh = multihost.global_mesh(devices=device_type)
    dev = local_device(mesh)
    m = P.load_map(map_path("example_map"), extract_segments=True,
                   tile_culling=True, culling_tile_size=1.25, device=dev)
    tables = P.make_scan_tables(num_beams=BEAMS, device=dev)
    per_rank = ENVS // nprocs
    idx, _ = env_shard(mesh)
    rows = slice(idx * per_rank, (idx + 1) * per_rank)
    poses = bench_poses(m, 7, component_seed=(0.7, 0.0))[rows]
    built, drive = main_path(m, tables, poses, sort_period=0,
                             scan_noise=False)
    states = multihost.host_local_states(lambda n: built, mesh, per_rank)
    sk.sweep.launches = 0
    s, _ = drive(states, RANK_STEPS)
    torch.cuda.synchronize()
    launches = sk.sweep.launches
    save_orbax(ckpt, s, mesh)

    ppo, ts = make_learner(PPO_MAP, PPO_ENVS, BEAMS, "pallas", mesh=mesh,
                           scan_noise=False)
    sk.sweep.launches = 0
    ts, metrics = ppo.train_step(ts)
    torch.cuda.synchronize()
    ppo_launches = sk.sweep.launches
    params = actor_critic_to_numpy(ts.net)  # whole: every rank calls it
    return dict(device=str(dev), rows=[rows.start, rows.stop],
                states={f.name: getattr(s, f.name).cpu().numpy()
                        for f in dataclasses.fields(SimState)},
                launches=launches, ppo_launches=ppo_launches,
                ppo_envs=ts.env_states.num_envs, net=params,
                metrics={k: float(v) for k, v in metrics.items()},
                seconds=time.time() - t0)


def sharded_phase(m, tables, poses, dev, card_name):
    """The sharded path on the card (module docstring, phase 16). Returns
    K1's launches on it: at world size 1 (the steps and the mesh
    learner's timed iterations) and on each of the RANKS ranks."""
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
    from f1tenth_gym_tpu_torch.parallel import multihost
    from f1tenth_gym_tpu_torch.parallel.sharding import make_mesh, shard_states
    from f1tenth_gym_tpu_torch.state import SimState
    from f1tenth_gym_tpu_torch.train_ppo import make_learner
    from f1tenth_gym_tpu_torch.utils.checkpoint import load_orbax
    from f1tenth_gym_tpu_torch.utils.convert import actor_critic_to_numpy

    t_phase = time.time()
    # world size 1: no cluster variables, so initialize() stays local
    multihost.initialize()
    require(not multihost.is_initialized(), "initialize() left the process "
            "in a group without cluster variables")
    mesh = multihost.global_mesh(devices=dev)
    require(mesh.size() == 1, f"world-size-1 mesh of {mesh.size()} ranks")
    states, drive = main_path(m, tables, poses, sort_period=0,
                              scan_noise=False)
    local = shard_states(multihost.host_local_states(
        lambda n: states, mesh, ENVS), mesh)
    torch.cuda.synchronize()
    sk.sweep.launches = 0
    s_sh, _ = drive(local, SHARD_STEPS)
    torch.cuda.synchronize()
    step_launches = sk.sweep.launches
    require(step_launches == SHARD_STEPS, f"sharded: {step_launches} K1 "
            f"launches in {SHARD_STEPS} steps")
    s_ref, _ = drive(states, SHARD_STEPS)
    bad = equal_states(s_sh, s_ref)
    require(not bad, f"sharded world-1 steps differ from unsharded in {bad}")

    # PPO(mesh=make_mesh()) against PPO() from the same seeds, timed in
    # turns: plain, mesh, mesh, plain
    ppo_p, ts_p = make_learner(PPO_MAP, PPO_ENVS, BEAMS, "pallas", dev)
    ppo_m, ts_m = make_learner(PPO_MAP, PPO_ENVS, BEAMS, "pallas",
                               mesh=make_mesh(devices=dev))
    ts_p, _ = ppo_p.train_step(ts_p)
    ts_m, _ = ppo_m.train_step(ts_m)

    def same(label):
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(
            ts_p.net.parameters(), ts_m.net.parameters())),
            f"sharded ppo: mesh parameters differ ({label})")
        bad = equal_states(ts_p.env_states, ts_m.env_states)
        require(not bad, f"sharded ppo: mesh env states differ in {bad} "
                f"({label})")

    same("first iteration")
    times = {"plain": [], "mesh": []}
    mesh_launches = 0
    for turn in range(SHARD_PPO_TURNS):
        kind = ("plain", "mesh", "mesh", "plain")[turn % 4]
        torch.cuda.synchronize()
        sk.sweep.launches = 0
        t0 = time.perf_counter()
        if kind == "plain":
            ts_p, _ = ppo_p.train_step(ts_p)
        else:
            ts_m, _ = ppo_m.train_step(ts_m)
        torch.cuda.synchronize()
        times[kind].append(time.perf_counter() - t0)
        if kind == "mesh":
            mesh_launches += sk.sweep.launches
    same("after the timed turns")
    T = ppo_m.pc.rollout_steps
    require(mesh_launches == T * len(times["mesh"]),
            f"sharded ppo: {mesh_launches} K1 launches")
    emit("sharded_world1", card=card_name, envs=ENVS, agents=AGENTS,
         beams=BEAMS, steps=SHARD_STEPS, kernel_launches=step_launches,
         steps_bit_identical=True, ppo_envs=PPO_ENVS, ppo_bit_identical=True,
         ppo_seconds=times, ppo_kernel_launches=mesh_launches,
         ppo_env_steps_per_s={k: [PPO_ENVS * T / t for t in v]
                              for k, v in times.items()})

    # RANKS ranks on the one card over gloo, against one process
    ref0, drive = main_path(m, tables, poses, sort_period=0,
                            scan_noise=False)
    ref, _ = drive(ref0, RANK_STEPS)
    ppo_r, ts_r = make_learner(PPO_MAP, PPO_ENVS, BEAMS, "pallas", dev,
                               scan_noise=False)
    ts_r, _ = ppo_r.train_step(ts_r)
    want = actor_critic_to_numpy(ts_r.net)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "states")
        t0 = time.time()
        outs = multihost.spawn(sharded_rank, RANKS, (dev.type, ckpt),
                               timeout_s=RANK_TIMEOUT_S)
        spawn_s = time.time() - t0
        loaded = load_orbax(ckpt, ref.map(torch.empty_like))
    stitched = SimState(**{f.name: torch.from_numpy(np.concatenate(
        [o["states"][f.name] for o in outs])).to(dev)
        for f in dataclasses.fields(SimState)})
    bad = equal_states(stitched, ref)
    require(not bad, f"{RANKS} ranks: stitched states differ in {bad}")
    bad = equal_states(loaded, ref)
    require(not bad, f"save_orbax at world {RANKS}, load_orbax at world 1: "
            f"differs in {bad}")
    diffs = [max_param_diff(o["net"], want) for o in outs]
    require(max(diffs) <= RANK_PPO_ATOL, f"{RANKS}-rank PPO parameters "
            f"{diffs} from one process's")
    rank_launches = [o["launches"] for o in outs]
    rank_ppo = [o["ppo_launches"] for o in outs]
    require(rank_launches == [RANK_STEPS] * RANKS
            and rank_ppo == [T] * RANKS,
            f"rank K1 launches {rank_launches}, PPO {rank_ppo}")
    emit("sharded_ranks", card=card_name, ranks=RANKS, backend="gloo",
         devices=[o["device"] for o in outs], rows=[o["rows"] for o in outs],
         steps=RANK_STEPS, states_bit_identical=True,
         checkpoint_world2_to_world1_bit_identical=True,
         ppo_envs=PPO_ENVS, ppo_max_param_diff=diffs,
         ppo_max_param_diff_bar=RANK_PPO_ATOL,
         ppo_metrics=[o["metrics"] for o in outs],
         rank_kernel_launches=rank_launches,
         rank_ppo_kernel_launches=rank_ppo,
         rank_seconds=[o["seconds"] for o in outs], spawn_seconds=spawn_s,
         phase_seconds=time.time() - t_phase)
    return dict(sharded_launches=step_launches + mesh_launches,
                sharded_rank_launches=[a + b for a, b in
                                       zip(rank_launches, rank_ppo)])


def bench_phase(card_name):
    """``python -m f1tenth_gym_tpu_torch.bench`` at its defaults on the
    card (module docstring, phase 17). Returns K1's launches in its timed
    steps."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "f1tenth_gym_tpu_torch.bench"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    seconds = time.time() - t0
    require(proc.returncode == 0, f"bench exited {proc.returncode}:\n"
            f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    missing = [k for k in BENCH_KEYS if k not in line]
    require(not missing, f"bench line lacks {missing}")
    require(all(v < 2.0 for v in line["scan_mse_by_map"].values())
            and line["ittc_collision_gate"] == "ok",
            f"bench gates: {line['scan_mse_by_map']}")
    note = [ln for ln in proc.stderr.splitlines() if ln.startswith("# envs=")]
    require(len(note) == 1, f"bench wrote no '# envs=' line:\n{proc.stderr}")
    launches = int(re.search(r"k1_launches=(\d+)", note[0]).group(1))
    steps = int(re.search(r"steps=(\d+)", note[0]).group(1))
    require(launches == steps, f"bench: {launches} K1 launches in {steps} "
            "steps")
    emit("bench", card=card_name, line=line, note=note[0],
         weak_scaling_on="the card machine's CPU (gloo ranks), not the card",
         kernel_launches=launches, seconds=seconds)
    return launches


def top_names(by_name, n=15, width=100):
    """The first ``n`` entries of a ``device_time_by_name`` table as
    [name cut to ``width`` characters, ms a step, calls a step]: a kernel's
    full name runs to hundreds of characters."""
    return [[k[:width], v["ms_per_step"], v["calls_per_step"]]
            for k, v in list(by_name.items())[:n]]


def tools_phase(dev, card_name, packs):
    """The probes on the card (module docstring, phase 18); ``packs`` is
    ``start_sweep_packs``' process. Returns the launches of K1 and of K2
    in the phase."""
    from f1tenth_gym_tpu_torch.ops import overlay_kernel as ok
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
    from f1tenth_gym_tpu_torch.tools import (
        common,
        culling_stats,
        kernel_phases,
        kernel_sweep,
        ppo_profile,
        rect_tier_estimate,
        step_probe,
        step_trace,
        step_variants,
    )

    t_phase = time.time()
    sk.sweep.launches = 0
    ok.overlay.launches = 0
    seconds = {}

    def lap(name):
        seconds[name] = time.time() - t_phase - sum(seconds.values())

    # K1's phase mask (run() holds every mask to its plain version)
    phases = kernel_phases.run(ENVS * AGENTS, BEAMS, 1.25, TOOL_REPS, dev)
    lap("kernel_phases")

    # the knob sweep: the main path's pack, then the split packs
    def swept(specs, skips, cap):
        rows, outs, loads = kernel_sweep.sweep_rows(
            specs, skips, ENVS * AGENTS, BEAMS, TOOL_REPS, cap=cap,
            device=dev)
        problems = kernel_sweep.compare(rows, outs, loads, BEAMS)
        require(not problems, f"kernel_sweep: {problems}")
        return rows

    main_rows = swept(SWEEP_MAIN, (True, False), 0)
    require(all(r["beams_differing_from_default"] == 0 for r in main_rows),
            "kernel_sweep at 1.25 m: a row parts from the default row")
    out, _ = packs.communicate()
    require(packs.returncode == 0,
            f"the sweep's pack build failed ({packs.returncode})")
    pack_s = json.loads(out.strip().splitlines()[-1])["seconds"]
    split_rows = swept(SWEEP_SPLIT, (True,), SWEEP_SPLIT_CAP)
    require(all(r["beams_differing_from_default"] == 0
                for r in split_rows if r["sub"] == sk.SUB),
            "kernel_sweep at 0.85 / 2.5 m: a row of the default sub parts "
            "from its default row")
    default = next(r for r in main_rows if (r["warps"], r["chunk"], r["sub"],
                                            r["skip"]) == (9, 128, 8, True))
    fastest = min(main_rows, key=lambda r: r["kernel_ms"])
    lap("kernel_sweep")

    # step_trace: the racing step and the 16-track step (its pack from
    # the cache that phase 13 filled)
    traces = {}
    for kind, envs in (("single", ENVS), ("multi", DR_ENVS)):
        t = step_trace.trace(kind, envs, TOOL_TRACE_STEPS, BEAMS, DR_TRACKS,
                             DR_SEED, dev)
        require(0 < t["busy_share"] <= 1, f"step_trace {kind}: busy share "
                f"{t['busy_share']}")
        require(t["k1"]["calls_per_step"] == 1
                and t["k1_wrapper_launches"] == TOOL_TRACE_STEPS,
                f"step_trace {kind}: K1 {t['k1']}, "
                f"{t['k1_wrapper_launches']} wrapper launches")
        require(t["k3"]["calls_per_step"] == 1
                and t["k3_wrapper_launches"] == TOOL_TRACE_STEPS,
                f"step_trace {kind}: K3 {t['k3']}, "
                f"{t['k3_wrapper_launches']} wrapper launches")
        names = list(t["by_name"])
        traces[kind] = dict(
            {k: v for k, v in t.items() if k != "by_name"},
            k1_rank=next(i for i, n in enumerate(names)
                         if common.K1_NAME in n),
            names=len(names), top=top_names(t["by_name"]))
        lap(f"step_trace_{kind}")

    # ppo_profile: world size 1 on the card, then gloo ranks on it
    w1 = ppo_profile.profile_world1(device=dev)
    require(0 < w1["busy_share"] <= 1, f"ppo_profile: busy share "
            f"{w1['busy_share']}")
    lap("ppo_profile_world1")
    ranks = ppo_profile.profile_ranks(TOOL_RANKS, device=dev,
                                      timeout_s=RANK_TIMEOUT_S)
    require(all(0 < x <= 1 for x in ranks["shares"]),
            f"ppo_profile: collective shares {ranks['shares']}")
    lap("ppo_profile_ranks")

    probe = step_probe.probe(ENVS, 1.25, ("scan", "overlay", "step"), BEAMS,
                             sk.SUB, dev)
    variants = step_variants.variants(step_variants.KEYS, ENVS,
                                      TOOL_SV_STEPS, BEAMS, dev)
    require(probe["k2_launches"] > 0 and variants["k2_launches"] > 0,
            "step_probe / step_variants launched no overlay kernel")
    lap("step_probe_variants")
    stats = culling_stats.run(1.25, ENVS, sk.SUB, BEAMS, "cpu")
    rect = rect_tier_estimate.run(1.25, ENVS, sk.SUB, "cpu")
    lap("host_probes")
    k1, k2 = sk.sweep.launches, ok.overlay.launches
    require(k1 > 0 and k2 > 0, f"tools: {k1} K1 and {k2} K2 launches")
    emit("tools", card=card_name, kernel_phases=phases,
         kernel_sweep=dict(main_pack=main_rows, split_packs=split_rows,
                           split_pack_build_seconds=pack_s,
                           default_ms=default["kernel_ms"],
                           fastest=fastest),
         step_trace=traces,
         ppo_profile=dict(world1={k: v for k, v in w1.items()
                                  if k != "by_name"},
                          world1_top=top_names(w1["by_name"]),
                          ranks=ranks),
         step_probe=probe, step_variants=variants, culling_stats=stats,
         rect_tier_estimate=rect, k1_launches=k1, k2_launches=k2,
         seconds=seconds, phase_seconds=time.time() - t_phase)
    return k1, k2


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    builds = [start_world_build(), start_sweep_packs()]
    try:
        return run(*builds)
    finally:
        for proc in builds:
            if proc.poll() is None:
                proc.kill()
            proc.stdout.close()
            proc.wait()


def run(world_build, sweep_packs):
    """Phases 1-18; ``world_build`` and ``sweep_packs`` are the processes
    of ``start_world_build`` and ``start_sweep_packs``."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.examples import domain_randomization as dr
    from f1tenth_gym_tpu_torch.maps import map_path
    from f1tenth_gym_tpu_torch.ops import lidar as lidar_ops
    from f1tenth_gym_tpu_torch.ops import opp_clip_kernel as oc
    from f1tenth_gym_tpu_torch.ops import overlay_kernel as ok
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
    from f1tenth_gym_tpu_torch.ops import segments as seg_ops
    from f1tenth_gym_tpu_torch.tools import common as tools_common
    from f1tenth_gym_tpu_torch.utils import native

    dev = torch.device("cuda")
    card_name = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build: one nvcc per kernel and g++, side by side
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        f_scan = pool.submit(sk.build_cuda)
        f_overlay = pool.submit(ok.build_cuda)
        f_clip = pool.submit(oc.build_cuda)
        f_native = pool.submit(native.build)
        ptxas = {"scan_kernel": f_scan.result(),
                 "overlay_kernel": f_overlay.result(),
                 "opp_clip_kernel": f_clip.result()}
        f_native.result()
    build_s = time.time() - t0
    # K1: one instantiation per (phase mask, subgroup size); the main
    # path's is the full mask at the default subgroup size
    variants = sk.resources(ptxas["scan_kernel"])
    prod = variants.get((sk.phase_mask(sk.FULL_PHASES), sk.SUB))
    require(prod is not None and len(variants) == 4 * len(sk.SUBS),
            f"scan kernel instantiations: {sorted(variants)}")
    require(all(v["spill_bytes"] == 0 for v in variants.values()),
            f"scan kernel spills: {variants}")
    report = {"scan_kernel": prod, "scan_kernel_variants": {
        f"phases={p},sub={q}": v for (p, q), v in sorted(variants.items())},
        **{name: [ln.strip() for ln in ptxas[name].splitlines()
                  if "registers" in ln or "spill" in ln]
           for name in ("overlay_kernel", "opp_clip_kernel")}}
    emit("build", seconds=build_s, ptxas=report, occupancy={
        "scan_kernel": sk.occupancy(ENVS * AGENTS, BEAMS),
        "overlay_kernel": ok.occupancy(ENVS * AGENTS, BEAMS),
        "opp_clip_kernel": oc.occupancy(ENVS * AGENTS, AGENTS, BEAMS)})

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
        # the row skip, from its plain transcription: the share of swept
        # pairs it keeps, and no pair that hits dropped
        pairs = {"culled": sk.pair_counts(w_c), "full": sk.pair_counts(w_f)}
        require(pairs["culled"]["missed"] == 0 and pairs["full"]["missed"]
                == 0, f"{label}: the row skip drops hit pairs: {pairs}")
        stats = dict(scans=flat.shape[0], culled_subgroups=int(
            (w_c.bid > 0).sum()), subgroups=int(w_c.bid.numel()),
            mean_swept_rows=float(w_c.swept_rows().float().mean()),
            extras_rows=int(w_c.ecnt.sum()) * sk.GROUP, pairs=pairs,
            kept_share={k: v["kept"] / v["swept"] for k, v in pairs.items()},
            hit_share={k: v["hit"] / v["swept"] for k, v in pairs.items()})
        return k_c, k_f, stats

    def leak_beams(m, flat, k_c, k_f, label):
        """Count the beams on which culled != full, and require each to be
        a vertex leak (``tools.common.vertex_leaks``: a beam through the
        shared vertex of two wall segments can fail both f32 hit tests,
        the TPU kernel's formulation, kept bit for bit;
        tests/test_torch_scan_kernel.py pins one such beam on the split
        pack)."""
        n, leaks = tools_common.vertex_leaks(m, flat, k_c, k_f, tables,
                                             BEAMS)
        require(leaks, f"{label}: culled != full on a beam that is no leak")
        return n

    poses_ex = bench_poses(m_ex, 7, component_seed=(0.7, 0.0))
    flat = poses_ex.reshape(-1, 3)
    k_c, k_f, st_ex = kernel_vs_plain(m_ex, flat, "example_map")
    bench_scans = k_c
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
    # the gate poses of berlin and stata_basement (the gate sampler of
    # bench.py:258, drawn on the CPU so that the poses are the same on
    # every machine; tests/test_torch_gate.py draws them too), and bench
    # poses there: other walls, other arcs for the row skip
    checks = {"example_map": poses_ex[:32].reshape(-1, 3)}
    st_maps = {}
    for name in ("berlin", "stata_basement"):
        checks[name] = gate_poses(name, dev)
        _, _, st_maps[f"{name}_gate"] = kernel_vs_plain(
            maps[name], checks[name], f"{name} gate poses")
        _, _, st_maps[f"{name}_bench"] = kernel_vs_plain(
            maps[name], bench_poses(maps[name], 7).reshape(-1, 3),
            f"{name} bench poses")
    emit("kernel_vs_plain", example_map=st_ex, compact_split=st_split,
         **st_maps)

    # ---- 4. overlay kernel: its path, its checks, its times
    params = P.VehicleParams.create(device=dev)
    overlay_entry = overlay_phase(bench_scans, poses_ex, tables, params,
                                  card_name)

    # ---- 4b. the opponent clip (K3): its checks, the step's parity, times
    clip_entry = opp_clip_phase(m_ex, tables, params, card_name)

    # ---- 5. gates of bench.py:230-289 (f1tenth_gym_tpu_torch/bench.py's)
    mse, mse_all, left, pose_sum = {}, {}, {}, {}
    for name, cp in checks.items():
        mse[name], mse_all[name], left[name] = gate_mse(maps[name], cp, tables)
        pose_sum[name] = float(cp.double().sum())
        require(mse[name] < 2.0, f"kernel vs march MSE {mse[name]} on {name}")
    ittc_collision_gate(tables, params)
    emit("gates", scan_mse_by_map=mse, scan_mse_all_beams=mse_all,
         beams_leaving_raster=left, beams_per_map=32 * BEAMS,
         gate_pose_sum=pose_sum, ittc_collision_gate="ok")

    # ---- 6. segments engine: the gate's bar, and a batch step with it
    seg_mse = {}
    for name in ("example_map", "berlin"):
        cp = checks[name]
        march = lidar_ops.get_scan(cp, maps[name], tables, BEAMS, THETA_DIS)
        seg = seg_ops.get_scan_segments(cp, maps[name].segments, tables,
                                        BEAMS, THETA_DIS)
        inside = inside_raster(maps[name], cp, march, tables)
        seg_mse[name] = float(((march - seg) ** 2)[inside].mean())
        require(seg_mse[name] < 2.0,
                f"segments vs march MSE {seg_mse[name]} on {name}")
    cfg_seg = P.SimConfig(num_agents=AGENTS, num_beams=BEAMS,
                          scan_engine="segments")
    gen = P.make_generator(dev, 1)
    sk.sweep.launches = 0
    s_seg, *_ = P.batch_reset(poses_ex[:SEG_ENVS], params, m_ex, tables,
                              cfg_seg, 0.01, generator=gen, device=dev)
    for _ in range(SEG_STEPS):
        s_seg, *_ = P.batch_step(s_seg, gap_follow(s_seg.scans), params, m_ex,
                                 tables, cfg_seg, 0.01, gen)
    require(bool(torch.isfinite(s_seg.scans).all())
            and sk.sweep.launches == 0, "segments batch step")
    emit("segments", scan_mse_by_map=seg_mse, batch_envs=SEG_ENVS,
         batch_steps=SEG_STEPS)

    # ---- 7. ScanSimulator2D: kernel engine with its culled pack, segments
    t = time.time()
    sim = P.ScanSimulator2D(num_beams=BEAMS, engine="kernel",
                            tile_culling=True, device=dev)
    sim.set_map(map_path("example_map"))
    sim_map_s = time.time() - t
    require(sim.map_data.tile_tables is not None, "ScanSimulator2D: no pack")
    flat = poses_ex.reshape(-1, 3)
    got = sim.scan_batch(flat)
    want = sk.scan(flat, sim.map_data, sim.tables, BEAMS, THETA_DIS,
                   device=dev)
    require(torch.equal(got, want), "ScanSimulator2D kernel != kernel scan")
    sims = {}
    for engine in ("march", "segments"):
        sims[engine] = P.ScanSimulator2D(num_beams=BEAMS, engine=engine,
                                         device=dev)
        sims[engine].set_map(map_path("example_map"))
    cp = checks["example_map"]
    a, b = sims["march"].scan_batch(cp), sims["segments"].scan_batch(cp)
    inside = inside_raster(sims["march"].map_data, cp, a, sims["march"].tables)
    sim_mse = float(((a - b) ** 2)[inside].mean())
    require(sim_mse < 2.0, f"ScanSimulator2D segments vs march MSE {sim_mse}")
    emit("scan_sim", map_seconds=sim_map_s, kernel_scans=flat.shape[0],
         pack=list(sim.map_data.tile_tables.shape),
         beams_differing_from_main_pack=int((got != bench_scans).sum()),
         segments_vs_march_mse=sim_mse)

    # ---- 8. main path: the bench racing step on the port
    states, drive = main_path(m_ex, tables, poses_ex)
    s, _ = drive(states, WARMUP)
    torch.cuda.synchronize()
    sk.sweep.launches = 0
    ok.overlay.launches = 0
    oc.opp_clip.launches = 0
    t0 = time.time()
    s, dones = drive(s, STEPS)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = sk.sweep.launches
    dones = int(dones)
    require(launches == STEPS, f"{launches} kernel launches in {STEPS} steps")
    require(ok.overlay.launches == 0, "the racing step launched the overlay")
    clip_launches = oc.opp_clip.launches
    require(clip_launches == STEPS,
            f"{clip_launches} opponent clip launches in {STEPS} steps")
    scan_stats = scans_in_range(s, tables, "main path")
    require(dones > 0 and bool((s.steps < int(s.steps.max())).any()),
            "no env was done and reset")
    rate = ENVS * STEPS / elapsed
    emit("main_path", envs=ENVS, agents=AGENTS, beams=BEAMS, steps=STEPS,
         seconds=elapsed, env_steps_per_s=rate, dones=dones,
         kernel_launches=launches, overlay_launches=ok.overlay.launches,
         opp_clip_launches=clip_launches, scans=scan_stats)

    # ---- 9. kernel timing at the main path's shapes, mid sort period
    s, _ = drive(s, SORT_PERIOD // 2)
    pose = torch.stack([s.x[..., 0], s.x[..., 1], s.x[..., 4]], -1)
    w_c = sk.prepare_map(pose.reshape(-1, 3), m_ex, tables, BEAMS, THETA_DIS)
    w_f = sk.prepare_map(pose.reshape(-1, 3), m_ex, tables, BEAMS, THETA_DIS,
                         culled=False)

    k_c, k_f = sk.sweep(w_c), sk.sweep(w_f)
    p_c, p_f = sk.sweep_plain(w_c), sk.sweep_plain(w_f)
    max_err = float((k_c - p_c).abs().max())
    require(max_err == 0.0, f"main-path kernel != plain: {max_err}")
    require(torch.equal(k_f, p_f), "main-path full kernel != plain")
    t_culled = kernel_ms(lambda: sk.sweep(w_c), 50)
    t_full = kernel_ms(lambda: sk.sweep(w_f), 20)
    # the same kernel with its row skip off: every pair tested
    t_noskip = kernel_ms(lambda: sk.sweep(w_c, skip=False), 20)
    ms_plain = cuda_ms(lambda: sk.sweep_plain(w_c), 3)
    pairs = {"culled": sk.pair_counts(w_c), "full": sk.pair_counts(w_f)}
    require(pairs["culled"]["missed"] == 0 and pairs["full"]["missed"] == 0,
            f"main path: the row skip drops hit pairs: {pairs}")
    bound = k1_bound(w_c, pairs["culled"])
    t_ops, t_bytes = bound["ops_bound_ms"], bound["bytes_bound_ms"]
    rows = w_c.swept_rows().double()
    emit("kernel_timing", card=card_name, culled=t_culled, full=t_full,
         culled_no_skip=t_noskip, plain_ms=ms_plain,
         **bound, bound_share=bound["bound_ms"] / t_culled["ms"],
         pairs=pairs,
         kept_share=pairs["culled"]["kept"] / pairs["culled"]["swept"],
         hit_share=pairs["culled"]["hit"] / pairs["culled"]["swept"],
         occupancy=sk.occupancy(w_c.scal.shape[0], BEAMS),
         mean_swept_rows=float(rows.mean()),
         mean_swept_groups=float(rows.mean()) / sk.GROUP,
         culled_subgroups=int((w_c.bid > 0).sum()),
         subgroups=int(w_c.bid.numel()))

    # ---- 10. the reference-compatible env on the card
    f110env_phase(poses_ex[0].cpu().numpy(), dev)

    # ---- 11. the PPO learner; 12. pure pursuit
    ppo_launches = ppo_phase(dev, card_name)
    planner_launches = planner_phase(m_ex, tables, poses_ex, dev, card_name)

    # ---- 13. the 16-track world; 14. domain randomization; 15. trackgen
    out, _ = world_build.communicate()
    require(world_build.returncode == 0,
            f"the world's pack build failed ({world_build.returncode})")
    build = json.loads(out.strip().splitlines()[-1])
    world = dr.make_world(DR_TRACKS, DR_ENVS, AGENTS, BEAMS, DR_SEED, dev)
    multi_track_phase(world, tables, kernel_vs_plain, leak_beams, build,
                      card_name)
    k1_extra = domain_randomization_phase(world, tables, card_name)
    del world
    k1_extra.update(trackgen_phase(dev, card_name))

    # ---- 16. the sharded path; 17. the port's bench entry point
    k1_extra.update(sharded_phase(m_ex, tables, poses_ex, dev, card_name))
    k1_extra["bench_launches"] = bench_phase(card_name)

    # ---- 18. the probes
    k1_extra["tools_launches"], overlay_entry["tools_launches"] = \
        tools_phase(dev, card_name, sweep_packs)

    print(json.dumps({"kernels": [{
        "name": "scan_kernel",
        "route": "cuda",
        "source": "f1tenth_gym_tpu_torch/csrc/scan_kernel.cu",
        "replaces": "f1tenth_gym_tpu/ops/pallas_scan.py:168",
        "launches": launches,
        "ppo_launches": ppo_launches,
        "planner_launches": planner_launches,
        **k1_extra,
        "max_abs_err": max_err,
        "ms": t_culled["ms"],
        "ms_full": t_full["ms"],
        "plain_ms": ms_plain,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "enqueue_us": t_culled["enqueue_us"],
    }, overlay_entry, {"launches": clip_launches, **clip_entry}]}),
        flush=True)
    print(card_name, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
