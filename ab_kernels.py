"""Two trees' scan (K1) and overlay (K2) kernels, timed in turns on one GPU.

    python3 ab_kernels.py --other .trees/parent [--rounds 2]

``--other`` is another checkout of this repository (for example a
``git archive`` of an earlier commit unpacked under the git-ignored
``.trees/``). Each turn is a process of its own that imports
``f1tenth_gym_tpu_torch`` from one tree, builds that tree's two kernels
from its sources, and times them on the same inputs; the turns run in the
order other, this, this, other, ``--rounds`` times. The inputs are made
from seeds: the bench racing step of ``chip_smoke.py`` (4096 envs x 2
agents x 1080 beams on example_map with its 1.25 m culling pack) driven
24 steps from the seed-7 start poses; K1 is timed culled and full on the
poses reached, K2 on the scans reached, each scan clipped by the other
agent's box. Times are those of ``kernel_ms`` in this tree's
``f1tenth_gym_tpu_torch/tools/common.py``, loaded by path as chip_smoke.py
is, so that every turn times with the same code: a CUDA graph of
launches, the eager launches, and the host's enqueue time. Every turn
must give the same output bits (both trees' kernels equal their plain
versions bit for bit). One JSON line a turn, then a summary line, then the
card's name and power limit.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVE_STEPS = 24


def _this_tree(name, path):
    """The module at ``path`` of this tree, whatever tree the package
    comes from."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(t):
    return hashlib.sha1(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def child(tree):
    """One turn: this tree's inputs, ``tree``'s package and kernels."""
    import concurrent.futures

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import f1tenth_gym_tpu_torch as P
    from f1tenth_gym_tpu_torch.maps import map_path
    from f1tenth_gym_tpu_torch.ops import overlay_kernel as ok
    from f1tenth_gym_tpu_torch.ops import scan_kernel as sk

    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device available")
    pkg = os.path.dirname(os.path.abspath(P.__file__))
    if os.path.dirname(pkg) != os.path.abspath(tree):
        raise SystemExit(f"ab_kernels: imported {pkg}, not from {tree}")
    cs = _this_tree("ab_chip_smoke", "chip_smoke.py")
    tc = _this_tree("ab_tools_common",
                    "f1tenth_gym_tpu_torch/tools/common.py")
    dev = torch.device("cuda")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(sk.build_cuda), pool.submit(ok.build_cuda)]:
            f.result()

    m = P.load_map(map_path("example_map"), extract_segments=True,
                   tile_culling=True, culling_tile_size=1.25, device=dev)
    tables = P.make_scan_tables(num_beams=cs.BEAMS, device=dev)
    params = P.VehicleParams.create(device=dev)
    poses = cs.bench_poses(m, 7, component_seed=(0.7, 0.0))
    states, drive = cs.main_path(m, tables, poses)
    s, _ = drive(states, DRIVE_STEPS)
    pose = torch.stack([s.x[..., 0], s.x[..., 1], s.x[..., 4]], -1)
    flat = pose.reshape(-1, 3)
    w_c = sk.prepare_map(flat, m, tables, cs.BEAMS, cs.THETA_DIS)
    w_f = sk.prepare_map(flat, m, tables, cs.BEAMS, cs.THETA_DIS,
                         culled=False)
    w_o = ok.prepare_overlay(s.scans.reshape(-1, cs.BEAMS), flat,
                             tc.other_agent_boxes(pose, params).reshape(
                                 -1, 1, 4, 2), tables, cs.BEAMS)
    out = dict(tree=tree, package=pkg, card=cs.card())
    for name, fn, iters in (("scan_culled", lambda: sk.sweep(w_c), 50),
                            ("scan_full", lambda: sk.sweep(w_f), 20),
                            ("overlay", lambda: ok.overlay(w_o), 50)):
        res = fn()
        torch.cuda.synchronize()
        out[name] = dict(tc.kernel_ms(fn, iters), sha1=_digest(res))
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    if not args.other:
        ap.error("--other is required")
    # one tile-pack cache for both trees, so the pack is built once
    env = dict(os.environ, F1TENTH_TORCH_CACHE=os.path.join(
        HERE, "f1tenth_gym_tpu_torch", "_build", "map_cache"))
    order = [("other", args.other), ("this", HERE),
             ("this", HERE), ("other", args.other)] * args.rounds
    turns = []
    for label, tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", tree], capture_output=True,
                              text=True, timeout=900, env=env)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"ab_kernels: the {label} turn failed")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["turn"] = label
        turns.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {}
    for name in ("scan_culled", "scan_full", "overlay"):
        digests = {t[name]["sha1"] for t in turns}
        if len(digests) != 1:
            raise SystemExit(f"ab_kernels: {name} outputs differ between "
                             f"turns: {digests}")
        ms = {label: [t[name]["ms"] for t in turns if t["turn"] == label]
              for label in ("other", "this")}
        summary[name] = dict(ms, this_faster_every_turn=max(ms["this"])
                             < min(ms["other"]),
                             speedup=min(ms["other"]) / max(ms["this"]))
    print(json.dumps({"summary": summary}), flush=True)
    print(turns[0]["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
