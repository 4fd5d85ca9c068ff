"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file
``configs`` gives, and a traffic mix, ``benchmark/traffic/<traffic>.json``;
the mix's ``kind`` names the module that runs it, ``benchmark/<kind>.py``. A
per-layer metric is read by ``benchmark/metrics/<name>.py``. Adding a cell,
a mix of a known kind or a metric therefore adds files and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


def load() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell_name: str) -> bool:
    """Whether ``metric`` is reported in cell ``cell_name``."""
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell(spec: dict, name: str, root: str = ROOT, here: str = HERE) -> dict:
    """The cell ``name`` with its configuration and traffic loaded, and
    the metrics it reports: {name, chips, config, traffic, end_to_end,
    per_layer}. ``root``: where the configurations' paths start;
    ``here``: the folder of ``traffic/`` and ``metrics/``."""
    w = _named(spec["workloads"], name, "workload")
    c = _named(spec["configs"], w["config"], "configuration")
    with open(os.path.join(root, c["file"])) as f:
        config = json.load(f)
    config["_dir"] = os.path.dirname(os.path.join(root, c["file"]))
    return dict(
        name=name, chips=int(w["chips"]), config=config,
        traffic=load_traffic(w["traffic"], here),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name)])


def load_traffic(name: str, here: str = HERE) -> dict:
    with open(os.path.join(here, "traffic", name + ".json")) as f:
        t = json.load(f)
    t["name"] = name
    return t


def reader(metric_name: str, here: str = HERE):
    """The ``read(rec)`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(here, "metrics", metric_name + ".py")
    sp = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read
