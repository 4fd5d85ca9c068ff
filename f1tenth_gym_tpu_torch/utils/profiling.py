"""Profiling and throughput measurement.

Port of ``f1tenth_gym_tpu/utils/profiling.py``:

* ``trace(logdir)``: context manager around ``torch.profiler`` that writes
  a Chrome/Perfetto trace into ``logdir``; it records host and CUDA
  activity on the card and CPU activity only when ``device`` is the CPU
  (a CPU-only torch asked for CUDA activity floods the log with errors);
* ``measure_steps_per_sec``: fenced steady-state throughput of any step
  fn, fenced with ``torch.cuda.synchronize()`` on a CUDA carry and by
  nothing on a CPU carry;
* ``annotate``: named trace spans for host-side phases
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Optional, Tuple

import torch

from f1tenth_gym_tpu_torch.config import resolve_device


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Capture a profile: ``with trace('runs/t') as prof: run()``.

    ``device`` is where the traced work runs (default: the card). The
    trace is written to ``logdir/trace.json``; ``prof.key_averages()``
    gives the sums by op."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


annotate = torch.profiler.record_function


def _first_tensor(tree: Any) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            found = _first_tensor(leaf)
            if found is not None:
                return found
    return None


def _fence(tree: Any) -> None:
    leaf = _first_tensor(tree)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


def measure_steps_per_sec(
    step_fn: Callable[[Any], Any],
    init: Any,
    num_steps: int = 64,
    warmup: int = 2,
    items_per_step: int = 1,
) -> Tuple[float, Any]:
    """Steady-state throughput of ``carry = step_fn(carry)``.

    Returns (items/sec, final carry). items_per_step scales the rate (e.g.
    the env-batch size for env-steps/s).
    """
    carry = init
    for _ in range(warmup):
        carry = step_fn(carry)
    _fence(carry)
    t0 = time.perf_counter()
    for _ in range(num_steps):
        carry = step_fn(carry)
    _fence(carry)
    dt = time.perf_counter() - t0
    return num_steps * items_per_step / dt, carry
