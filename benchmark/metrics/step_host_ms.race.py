"""The host's ms a racing step inside the port's ``vector.step`` span:
the time the host takes to enqueue one step. Set beside the step's
period it tells host pacing (about equal) from card pacing (shorter).
Read from the port's span table over the profiled stretch of the card's
activity alone (``benchmark/spans.py``); None without it."""

from benchmark.spans import race_spans


def read(rec):
    spans = race_spans(rec)
    if spans is None:
        return None
    s = spans["vector.step"]
    return s["host_ms"] / s["calls"]
