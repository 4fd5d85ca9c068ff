"""The port's own span table (``f1tenth_gym_tpu_torch.utils.profiling``),
as the racing cells' span metrics read it.

The per-layer readers run in the process that ran the cell, after the
window, so they read the table the port's spans filled while the
profiler recorded. ``race.py`` profiles the card's activity alone first,
for ``rec["steps"]`` steps; the table's first ``rec["steps"]`` top-level
``vector.step`` spans, and every span that closed before the last of them
(the sorts among them), are that stretch.
"""


def race_spans(rec):
    """{span name: {calls, host_ms, host_self_ms, extent_ms}} of the first
    profiled stretch of a racing window, or None: another kind of cell,
    a port without the span table, or fewer ``vector.step`` spans than the
    stretch's steps."""
    if rec.get("kind") != "race" or not rec.get("steps"):
        return None
    from f1tenth_gym_tpu_torch.utils import profiling

    summary = getattr(profiling, "span_summary", None)
    if summary is None:
        return None
    spans = summary("vector.step", rec["steps"])
    if spans.get("vector.step", {}).get("calls", 0) < rec["steps"]:
        return None
    return spans
