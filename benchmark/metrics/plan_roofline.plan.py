"""The planner's share of its roofline, in %: its least time a step (the
larger of its operations over the card's float32 peak and its bytes over
the card's memory peak, counted from the cars the port's
``pure_pursuit_plan.cars`` counter saw a step, ``benchmark/plan.py``) over
the extent a step of the port's ``plan.step`` span (``plan_extent_ms.plan``).
None without a planner or its span."""

from benchmark.spans import race_spans


def read(rec):
    spans = race_spans(rec)
    plan = rec.get("plan")
    if spans is None or not plan or not plan["cars"]:
        return None
    extent = spans.get("plan.step", {}).get("extent_ms")
    if not extent:
        return None
    return 100.0 * plan["bound_s"] * 1e3 / (extent / rec["steps"])
