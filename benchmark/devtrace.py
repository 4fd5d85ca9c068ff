"""Reading a ``torch.profiler`` trace of the card: device intervals, their
union, launches, time by name, and what the host did while the card idled.

Everything but ``collect`` works on plain lists, so that the arithmetic
is tested on synthetic traces on the CPU. Times are microseconds as the
profiler gives them; results are seconds.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Tuple

COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")
TOP = 10
NAME_CHARS = 160   # a kernel's name is cut to this in a breakdown


def collect(prof) -> Tuple[list, list]:
    """(device, host) events of a profile, each (name, start_us, end_us):
    the card's kernels, copies and sets, and the host's ops. The host's
    ``record_function`` ranges, which the profiler also draws on the
    device's timeline, are not device operations and are left out."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append(item)
        elif e.device_type == DeviceType.CPU:
            host.append(item)
    host_names = {name for name, _, _ in host}
    return [d for d in device if d[0] not in host_names], host


def is_launch(name: str) -> bool:
    """A kernel launch, not a copy or a set."""
    return not name.startswith(COPY_PREFIXES)


def merged(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_seconds(device_events) -> float:
    """Seconds in which some operation ran on the card: the union of the
    events' intervals, never their sum."""
    return sum(e - s for s, e in merged((s, e) for _, s, e in device_events)) \
        / 1e6


def seconds_by_name(device_events, part: str = None) -> dict:
    """{name: summed seconds} of the device events (whose name holds
    ``part``, when given)."""
    out = defaultdict(float)
    for name, s, e in device_events:
        if part is None or part in name:
            out[name] += (e - s) / 1e6
    return dict(out)


def top_ops(device_events) -> list:
    """The TOP device operations that took most time: [[name, s], ...]."""
    by = seconds_by_name(device_events)
    return [[k[:NAME_CHARS], v]
            for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def idle_gaps(device_events, host_events) -> list:
    """Idle seconds of the card between its first and last operation,
    summed by the innermost host op running at each gap's middle (the
    host's CUDA runtime calls left out): [[name, s], ...], largest
    first."""
    spans = merged((s, e) for _, s, e in device_events)
    ops = sorted((s, e, name) for name, s, e in host_events
                 if not name.startswith("cuda"))
    out = defaultdict(float)
    stack, j = [], 0   # the host ops open at the sweep's time, nested
    for (_, e0), (s1, _) in zip(spans, spans[1:]):
        mid = 0.5 * (e0 + s1)
        while j < len(ops) and ops[j][0] <= mid:
            while stack and stack[-1][1] <= ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else "(no host op)"] += (s1 - e0) / 1e6
    return [[k[:NAME_CHARS], v]
            for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:TOP]]
