"""The extent a step of the port's ``plan.step`` span (one pure-pursuit
plan of every car, ``planning/pure_pursuit.py``) on the card's timeline:
the time between the CUDA events the span records at its enter and exit,
as ``opp_clip_extent_ms.race`` reads ``sim.opp_clip``. It holds the
planner's kernels and any time the card waits inside the span for the host
to enqueue them. Read from the port's span table over the profiled stretch
of the card's activity alone (``benchmark/spans.py``); None without it, or
without a planner."""

from benchmark.spans import race_spans


def read(rec):
    spans = race_spans(rec)
    if spans is None or spans.get("plan.step", {}).get("extent_ms") is None:
        return None
    return spans["plan.step"]["extent_ms"] / rec["steps"]
