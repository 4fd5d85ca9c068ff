"""The learner's update's share of its roofline, in %: its least time an
iteration (``benchmark/ppo.py::update_bound_s``: the forward and backward
flops of the agent-samples the port's ``ppo.update.samples`` counter saw in
the profiled stretch over the card's float32 peak, or their inputs' bytes
over its memory peak, whichever is larger, over the stretch's
``ppo.iterations``) over the extent of the port's ``ppo.update`` span an
iteration (``update_ms.ppo``). None where either is missing."""

from benchmark.spec import reader


def read(rec):
    ppo = rec.get("ppo") or {}
    counters = ppo.get("counters") or {}
    if not counters.get("ppo.update.samples") or \
            not counters.get("ppo.iterations"):
        return None
    ms = reader("update_ms.ppo")(rec)
    if not ms:
        return None
    bound_ms = 1e3 * ppo["update_bound_s"] / counters["ppo.iterations"]
    return 100.0 * bound_ms / ms
