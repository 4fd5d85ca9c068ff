"""Profiling and throughput measurement.

Port of ``f1tenth_gym_tpu/utils/profiling.py``:

* ``trace(logdir)``: context manager around ``torch.profiler`` that writes
  a Chrome/Perfetto trace into ``logdir``; it records host and CUDA
  activity on the card and CPU activity only when ``device`` is the CPU
  (a CPU-only torch asked for CUDA activity floods the log with errors);
* ``measure_steps_per_sec``: fenced steady-state throughput of any step
  fn, fenced with ``torch.cuda.synchronize()`` on a CUDA carry and by
  nothing on a CPU carry;
* ``annotate(name, extent=False)``: the port's span. Off (no profiler
  recording) it is one flag read and a shared null context. On, it is a
  ``torch.profiler.record_function`` range, so the span lies on the
  profiler's clock beside the kernels and in ``trace``'s Chrome trace, and
  a record in an in-memory table: host start and end
  (``time.perf_counter_ns``), the enclosing span and the top-level span it
  belongs to; with ``extent``, also a CUDA event at enter and at exit on
  the current stream once CUDA is in use. A span never launches a kernel,
  syncs or copies to the card;
* ``span_summary(top, first)`` / ``clear_spans()``: per-name sums of that
  table (calls, host ms, host self ms, extent ms), cut after the
  ``first``-th top-level span named ``top``. The kernels' own time a span
  is the profile's: the device time of the span's range in
  ``key_averages()``.

The step path's spans (one per stage; ``vector.step`` is a step's
top-level span, ``env.step`` for ``F110Env`` and ``make_env_fns`` users;
a replay of the auto-reset step's CUDA graph runs no Python, so it records
``vector.step`` alone, around its copies and the replay):
``vector.step`` > ``env.step`` > ``sim.physics``, ``sim.scan`` >
(``scan.prepare`` > ``scan.select_windows``; ``scan.k1``), ``sim.noise``,
``sim.collision``, ``sim.ittc``, ``sim.opp_clip``, ``env.laps``; then
``vector.reset`` under ``vector.step``; ``vector.sort`` at top level.
The planner's (``planning/pure_pursuit.py``): ``plan.step`` >
``plan.nearest``, ``plan.lookahead``, ``plan.actuation``, at top level
before the step it plans for. ``sim.opp_clip`` and ``plan.step`` record
their extent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time
from collections import defaultdict
from typing import Any, Callable, Optional, Tuple

import torch

from f1tenth_gym_tpu_torch.config import resolve_device


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Capture a profile: ``with trace('runs/t') as prof: run()``.

    ``device`` is where the traced work runs (default: the card). The
    trace is written to ``logdir/trace.json``; ``prof.key_averages()``
    gives the sums by op. The port's spans (``annotate``) are ranges of
    the trace, beside the kernels they launched."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


MAX_SPANS = 65536   # records the table holds; later ones are counted


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One closed span. ``parent``/``parent_seq``: the enclosing span's
    name and sequence number (None at top level); ``root``: the sequence
    number of the top-level span it runs under (its own at top level);
    ``extent_ms``: for a span opened with ``extent``, its extent on the
    card's timeline (the time between its two CUDA events, which it holds
    until ``span_summary`` reads them), or its host time on the CPU, where
    every op has finished when the host moves on; None otherwise."""
    name: str
    seq: int
    parent: Optional[str]
    parent_seq: Optional[int]
    root: int
    host_start_ns: int
    host_end_ns: int = 0
    start_event: Any = None
    end_event: Any = None
    extent_ms: Optional[float] = None


class SpanTable:
    """The spans recorded while a profiler records: closed spans in the
    order they closed, at most ``cap``, the number dropped past it, and the
    spans open now (``stack``; the step path runs on one thread)."""

    def __init__(self, cap: int = MAX_SPANS):
        self.cap = cap
        self.records = []
        self.dropped = 0
        self.stack = []
        self._seq = itertools.count()

    def add(self, rec: SpanRecord):
        if len(self.records) >= self.cap:
            self.dropped += 1
        else:
            self.records.append(rec)

    def settle(self):
        """Turn the events of the recorded spans into ``extent_ms``,
        waiting for the card to pass them."""
        for r in self.records:
            if r.end_event is not None:
                r.end_event.synchronize()
                r.extent_ms = r.start_event.elapsed_time(r.end_event)
                r.start_event = r.end_event = None

    def clear(self):
        self.records = []
        self.dropped = 0


TABLE = SpanTable()


class _Span:
    __slots__ = ("name", "extent", "range", "rec")

    def __init__(self, name: str, extent: bool):
        self.name = name
        self.extent = extent

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        table = TABLE
        up = table.stack[-1] if table.stack else None
        seq = next(table._seq)
        if up is None:
            rec = SpanRecord(self.name, seq, None, None, seq,
                             time.perf_counter_ns())
        else:
            rec = SpanRecord(self.name, seq, up.name, up.seq, up.root,
                             time.perf_counter_ns())
        # events only once the process uses CUDA: a span never initializes it
        if self.extent and torch.cuda.is_initialized():
            rec.start_event = torch.cuda.Event(enable_timing=True)
            rec.start_event.record()
        table.stack.append(rec)
        self.rec = rec
        return self

    def __exit__(self, *exc):
        rec = self.rec
        table = TABLE
        table.stack.pop()
        if rec.start_event is not None:
            rec.end_event = torch.cuda.Event(enable_timing=True)
            rec.end_event.record()
        rec.host_end_ns = time.perf_counter_ns()
        if self.extent and rec.start_event is None:
            rec.extent_ms = (rec.host_end_ns - rec.host_start_ns) / 1e6
        table.add(rec)
        self.range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()
_profiler = torch.autograd.profiler


def profiling_enabled() -> bool:
    """Whether a ``torch.profiler`` records now (the spans' flag)."""
    return _profiler._is_profiler_enabled


def annotate(name: str, extent: bool = False):
    """The span ``name`` around a stage: ``with annotate("sim.scan"):``.

    While no ``torch.profiler`` session records it returns a shared null
    context. While one records it is a ``record_function`` range and a
    record in ``TABLE`` (module docstring). ``extent``: also record the
    span's extent on the card's timeline, by a CUDA event at each end
    (under the profiler an event record costs the host tens of
    microseconds, so only spans whose extent is read ask for it)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, extent)


def clear_spans():
    """Empty the span table and its count of dropped spans."""
    TABLE.clear()


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def span_summary(top: str, first: Optional[int] = None) -> dict:
    """{name: {calls, host_ms, host_self_ms, extent_ms}} over the spans
    that closed up to the end of the ``first``-th top-level span named
    ``top`` (all of them when ``first`` is None or the table holds fewer).

    ``host_ms``: the spans' summed host time (enter to exit, the host's
    enqueue on the card); ``host_self_ms``: the host time minus the union
    of its child spans' host intervals; ``extent_ms``: the summed extent
    of spans opened with ``extent`` (``SpanRecord``), None for the others.
    An extent on the card holds the span's kernels and the time the card
    waited for the host to enqueue them. Waits for the card to pass the
    spans' events."""
    TABLE.settle()
    recs, n_top = [], 0
    for r in TABLE.records:
        recs.append(r)
        if r.parent_seq is None and r.name == top:
            n_top += 1
            if first is not None and n_top >= first:
                break
    children = defaultdict(list)
    for r in recs:
        if r.parent_seq is not None:
            children[r.parent_seq].append((r.host_start_ns, r.host_end_ns))
    out = {}
    for r in recs:
        host_ns = r.host_end_ns - r.host_start_ns
        d = out.setdefault(r.name, dict(calls=0, host_ms=0.0,
                                        host_self_ms=0.0, extent_ms=None))
        d["calls"] += 1
        d["host_ms"] += host_ns / 1e6
        d["host_self_ms"] += (host_ns - _union_ns(children[r.seq])) / 1e6
        if r.extent_ms is not None:
            d["extent_ms"] = (d["extent_ms"] or 0.0) + r.extent_ms
    return out


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
