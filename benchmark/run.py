"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port. The last line of stdout
is the JSON result: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer ones with
``--trace 1``), ``device`` and, last, ``checks``: each number compared
beside its limit. The same numbers are the last lines of stderr. Exits
non-zero, with no result, without a card (or fewer than the cell asks
for), without the port, or when JAX or the JAX package got loaded.
"""

import time

T_START = time.time()   # set-up counts from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def result_line(cell, out, trace, device_info) -> dict:
    """The result object of ``out``, what a cell's runner returned."""
    from benchmark import spec

    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            value = spec.reader(m["name"])(out["layer"])
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = dict(value=out["end_to_end"][m["name"]],
                                      unit=m["unit"])
    checks = {k: dict(value=v, limit=lim) for k, (v, lim) in
              out["checks"].items()}
    line = dict(correct=all(v <= lim for v, lim in out["checks"].values()),
                attempted=out["attempted"], failed=out["failed"],
                metrics=metrics, device=device_info)
    if trace:
        line["device"].update(busy_s=out["layer"]["busy_s"],
                              window_s=out["layer"]["window_s"])
        line["breakdown"] = out["layer"]["breakdown"]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import isolation, spec

    cell = spec.cell(spec.load(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"# {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    runner = importlib.import_module("benchmark." + cell["traffic"]["kind"])
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda:0", T_START)
    bad = isolation.forbidden_loaded()
    if bad:
        print(f"# forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=cell["chips"],
                memory_peak_bytes=out["memory_peak_bytes"])
    line = result_line(cell, out, bool(args.trace), info)
    print(f"# {args.workload} seed={args.seed} {out['note']} "
          f"judged={out['judged']}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
