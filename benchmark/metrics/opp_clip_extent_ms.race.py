"""The extent a racing step of the port's ``sim.opp_clip`` span (the
opponent clip, ``ray_cast_opponents``) on the card's timeline: the time
between the CUDA events the span records at its enter and exit. An extent
holds the clip's kernels and any time the card waits inside the span for
the host to enqueue them; where the card runs behind the host all through
the span, as the racing cells' host times say it does (the clip's host ms
a fraction of its extent), it is the kernels' time. Read from the port's
span table over the profiled stretch of the card's activity alone
(``benchmark/spans.py``); None without it, or without opponents."""

from benchmark.spans import race_spans


def read(rec):
    spans = race_spans(rec)
    if spans is None or spans.get("sim.opp_clip", {}).get("extent_ms") is None:
        return None
    return spans["sim.opp_clip"]["extent_ms"] / rec["steps"]
