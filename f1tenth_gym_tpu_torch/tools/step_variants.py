"""Times of the full step and of each of its stages alone.

Port of ``tools/step_variants.py``, with its keys, on the bench workload
(SV_ENVS = 4096 envs x 2 agents x 1080 beams, example_map culled at 1.25
m, the sampler's poses in tile-snake order):

  step/unfused-arg    the auto-reset step (steer 0, 2 m/s)
  step/unfused-const  the same step: in eager torch there is no jit
                      argument or constant, so the two keys coincide
  step/scan16         16 steps a call, the time divided by 16
  kern/scan-unfused   the scan kernel (K1) alone through ``scan_pallas``,
                      on the 8192 scans sorted one by one in tile-snake
                      order
  kern/overlay        the overlay kernel (K2) alone through
                      ``overlay_opponents``, each of those scans clipped by
                      a box 1.5 m along x (O = 1)
  xla/extras          the step's scan noise, iTTC and opponent ray cast
  xla/noise           the scan noise alone (the port's generator: one
                      vector an env, shared by its agents)
  xla/ttc             ``check_ttc`` alone
  xla/opponents       ``get_vertices`` and ``ray_cast_opponents`` alone
  xla/collision       ``get_vertices`` and ``collision_multiple`` alone

Each is timed as in the JAX probe, host clock over SV_STEPS (64) fenced
calls after one warm-up (``ms``), with the CUDA-event time of the same
calls beside it on the card (``event_ms``). ``xla/noise-rbg`` has no
counterpart (JAX's RBG generator): asking for it exits with a message.

    python -m f1tenth_gym_tpu_torch.tools.step_variants [keys...]
"""

from __future__ import annotations

import argparse
import os

import torch

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.tools import common

DEFAULT_KEYS = ("step/unfused-arg", "step/unfused-const", "kern/scan-unfused",
                "kern/overlay", "xla/extras")
KEYS = DEFAULT_KEYS + ("step/scan16", "xla/noise", "xla/ttc",
                       "xla/opponents", "xla/collision")
NO_COUNTERPART = {
    "xla/noise-rbg": "xla/noise-rbg has no counterpart in the port: the RBG "
                     "generator is JAX's (xla/noise times the port's)"}
SAME_STEP = ("in eager torch there is no jit argument or constant: "
             "step/unfused-arg and step/unfused-const time the same step")


def variants(keys=DEFAULT_KEYS, envs: int = 4096, steps: int = 64,
             num_beams: int = 1080, device=None) -> dict:
    """{key: {ms, event_ms (on the card), scans_per_s}} for ``keys``, and
    the kernel wrappers' ``k1_launches`` / ``k2_launches`` over all of them
    (a replay of the step's CUDA graph calls no wrapper). Raises SystemExit
    on a key without a counterpart, or an unknown one."""
    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.ops import collision as col_ops
    from f1tenth_gym_tpu_torch.ops import lidar as lidar_ops
    from f1tenth_gym_tpu_torch.ops import overlay_kernel as ok
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
    from f1tenth_gym_tpu_torch.parallel.vector import tile_snake_key

    for k in keys:
        if k in NO_COUNTERPART:
            raise SystemExit(NO_COUNTERPART[k])
        if k not in KEYS:
            raise SystemExit(f"unknown key {k}")
    dev = resolve_device(device)
    m, tables, poses = common.bench_workload(1.25, envs, num_beams, dev)
    params = P.VehicleParams.create(device=dev)
    B = num_beams
    states, step, _ = common.racing_step(m, tables, poses)
    # the flat scans for the kernels alone, sorted one by one
    flat = poses.reshape(-1, 3)
    tm = m.tile_meta_host
    flat = flat[torch.argsort(tile_snake_key(
        flat[:, 0], flat[:, 1], 1.0 / tm[2], (tm[0], tm[1])), stable=True)]
    scans = torch.full((envs, 2, B), 10.0, device=dev)
    vel = torch.full((envs, 2), 2.0, device=dev)
    gen = P.make_generator(dev, 3)
    k = torch.arange(1, device=dev)
    opp_idx = torch.stack([k + (k >= i) for i in range(2)])   # (2, 1)

    def noise(sc):
        nz = torch.randn((envs, 1, B), generator=gen, device=dev)
        return sc + tables.scan_std * nz

    def opponents(sc):
        verts = col_ops.get_vertices(poses, params.length, params.width)
        return col_ops.ray_cast_opponents(poses, sc, verts[:, opp_idx],
                                          tables)

    def extras():
        sc = noise(scans)
        return opponents(sc), lidar_ops.check_ttc(sc, vel, tables)

    def step16():
        s = states
        for _ in range(16):
            s = step(s)
        return s

    sc_flat = torch.full((flat.shape[0], B), 10.0, device=dev)
    box = flat.clone()
    box[:, 0] += 1.5
    box = col_ops.get_vertices(box, params.length, params.width)[:, None]
    kw = dict(tile_tables=m.tile_tables, tile_ngroups=m.tile_ngroups,
              tile_meta=m.tile_meta, tile_blockmap=m.tile_blockmap,
              tile_ext=m.tile_ext, elig_raster=m.cull_eligible,
              elig_meta=sk.elig_meta(m))
    fns = {
        "step/unfused-arg": lambda: step(states),
        "step/unfused-const": lambda: step(states),
        "step/scan16": step16,
        "kern/scan-unfused": lambda: sk.scan_pallas(
            flat, m.seg_table, tables, B, common.THETA_DIS, **kw),
        "kern/overlay": lambda: ok.overlay_opponents(
            sc_flat, flat, box, tables, B, device=dev),
        "xla/extras": extras,
        "xla/noise": lambda: noise(scans),
        "xla/ttc": lambda: lidar_ops.check_ttc(scans, vel, tables),
        "xla/opponents": lambda: opponents(scans),
        "xla/collision": lambda: col_ops.collision_multiple(
            col_ops.get_vertices(poses, params.length, params.width)),
    }
    out = {}
    k1, k2 = sk.sweep.launches, ok.overlay.launches
    for key in keys:
        div = 16.0 if key == "step/scan16" else 1.0
        r = dict(ms=common.fenced_ms(fns[key], steps, dev) / div)
        if dev.type == "cuda":
            r["event_ms"] = common.cuda_ms(fns[key], steps) / div
        r["scans_per_s"] = envs * 2 / r["ms"] * 1e3
        out[key] = r
    return dict(variants=out, envs=envs, beams=B, steps=steps,
                device=common.device_name(dev),
                k1_launches=sk.sweep.launches - k1,
                k2_launches=ok.overlay.launches - k2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("keys", nargs="*")
    ap.add_argument("--beams", type=int, default=1080)
    common.device_arg(ap)
    args = ap.parse_args(argv)
    r = variants(tuple(args.keys) or DEFAULT_KEYS,
                 int(os.environ.get("SV_ENVS", 4096)),
                 int(os.environ.get("SV_STEPS", 64)), args.beams, args.device)
    for key, v in r["variants"].items():
        ev = f"  event {v['event_ms']:8.3f} ms" if "event_ms" in v else ""
        print(f"{key:20s} {v['ms']:8.3f} ms/call{ev}  "
              f"({v['scans_per_s'] / 1e3:7.0f}k scans/s)", flush=True)
    if {"step/unfused-arg", "step/unfused-const"} & set(r["variants"]):
        print(f"# {SAME_STEP}", flush=True)
    return r


if __name__ == "__main__":
    main()
