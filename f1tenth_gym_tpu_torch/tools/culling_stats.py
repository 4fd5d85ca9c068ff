"""Host-side culling statistics for the bench workload.

Port of ``tools/culling_stats.py``. For the bench's racing workload
(grouped corridor spawns, tile-snake locality sort) at culling tile size
BENCH_CULL_TS (2.5 m), reports how many ``sub``-scan subgroups resolve to
each window tier (1x1 / 2x2 / 4x4 / 8x8 / full) and the mean number of
8-row groups each scan sweeps, which the scan kernel's row loop scales
with (``tools/kernel_phases.py`` gives the fixed cost beside it).

The JAX probe's ``programs`` (scans / EA) has no counterpart: the scan
kernel runs one block per (scan, group of beam chunks), and ``blocks``
counts them, ``n_pad * ceil(ceil(B / CHUNK) / warps)``. The JAX probe pads
the scans to EA = 32 with poses at the origin; this one pads them to
``sub`` with the last pose, as the kernel's host side does, so the two
agree whenever the scan count is a multiple of 32 (the bench's 8192).

    BENCH_CULL_TS=1.25 python -m f1tenth_gym_tpu_torch.tools.culling_stats

Host-only: it runs on the CPU unless given ``--device``. Knobs:
BENCH_CULL_TS, BENCH_ENVS (4096); ``--sub`` (8), ``--beams`` (1080).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from f1tenth_gym_tpu_torch.ops import scan_kernel as sk
from f1tenth_gym_tpu_torch.tools import common


def stats_for(md, poses, sub: int = sk.SUB, num_beams: int = 1080,
              chunk: int = sk.CHUNK, warps=None) -> dict:
    """poses (N, 3), already locality-sorted: per-SUBGROUP window tier
    usage and the PER-SCAN swept group count (the subgroup's shared part
    plus each scan's own extras range), with the JAX probe's keys and
    ``blocks`` for its ``programs``."""
    x0, y0, inv_ts = md.tile_meta[:3].cpu()   # f32, as the kernel's
    nx, ny = int(md.tile_meta_host[3]), int(md.tile_meta_host[4])
    ng_all = md.tile_ngroups.cpu().long()
    blockmap = md.tile_blockmap.cpu()
    ext = None if md.tile_ext is None else md.tile_ext.cpu()
    full_ng = int(ng_all[0])

    p = torch.as_tensor(np.asarray(poses, np.float32)).reshape(-1, 3)
    n = p.shape[0]
    n_pad = -(-n // sub) * sub
    p = torch.cat([p, p[-1:].expand(n_pad - n, 3)])
    # the kernel's host side (ops/scan_kernel.py::prepare), in f32
    ti = torch.floor((p[:, 0] - x0) * inv_ts).long().view(-1, sub)
    tj = torch.floor((p[:, 1] - y0) * inv_ts).long().view(-1, sub)
    _, ng, _, ecnt = sk.select_windows(ti, tj, blockmap, ng_all, ext, nx, ny,
                                       full_ng)
    (use1, _), (use2, _), (use4, _), (use8, _) = sk.window_tiers(
        ti, tj, blockmap, nx, ny)
    ng = ng.numpy()
    per_scan = ng[:, None] + ecnt.numpy()   # (nsub, sub) groups a scan sweeps
    _, _, blocks_per_scan = sk.launch_shape(num_beams, chunk, warps)
    return {
        "blocks": n_pad * blocks_per_scan,
        "subgroups": len(ng),
        "w1": int(use1.sum()), "w2": int(use2.sum()),
        "w4": int(use4.sum()), "w8": int(use8.sum()),
        "full": int((~(use1 | use2 | use4 | use8)).sum()),
        "mean_ng": float(per_scan.mean()),
        "mean_common": float(ng.mean()),
        "full_ng": full_ng,
        "mean_segs": float(per_scan.mean()) * sk.GROUP,
        "speedup_vs_full": full_ng / float(per_scan.mean()),
    }


def run(ts: float = 2.5, envs: int = 4096, sub: int = sk.SUB,
        num_beams: int = 1080, device="cpu") -> dict:
    """``stats_for`` on the bench workload at tile size ``ts``."""
    m, _, poses = common.bench_workload(ts, envs, num_beams, device)
    s = stats_for(m, poses.reshape(-1, 3).cpu(), sub, num_beams)
    tm = m.tile_meta_host
    return dict(ts=ts, grid=[int(tm[3]), int(tm[4])], sub=sub,
                kmax_groups=m.tile_tables.shape[1] // sk.GROUP, **s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sub", type=int, default=sk.SUB)
    ap.add_argument("--beams", type=int, default=1080)
    common.device_arg(ap, default="cpu")
    args = ap.parse_args(argv)
    s = run(float(os.environ.get("BENCH_CULL_TS", 2.5)),
            int(os.environ.get("BENCH_ENVS", 4096)), args.sub, args.beams,
            args.device)
    print(f"ts={s['ts']} grid={s['grid'][0]}x{s['grid'][1]} SUB={s['sub']} "
          f"kmax={s['kmax_groups']}g")
    print(f"blocks={s['blocks']} subgroups={s['subgroups']}  "
          f"1x1={s['w1']}  2x2={s['w2']}  4x4={s['w4']}  8x8={s['w8']}  "
          f"full={s['full']}")
    print(f"mean swept groups/SCAN = {s['mean_ng']:.2f} "
          f"(shared/common part {s['mean_common']:.2f}; full set: "
          f"{s['full_ng']}) -> {s['speedup_vs_full']:.2f}x row cull")
    print(json.dumps(s), flush=True)
    return s


if __name__ == "__main__":
    main()
