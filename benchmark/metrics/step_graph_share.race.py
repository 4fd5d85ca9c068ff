"""The share of the run's auto-reset steps that replayed a CUDA graph: the
port's counters ``make_autoreset_step.replays`` over ``.calls``
(``parallel/vector.py``), totals over the run's process, set-up's warm-up
included. None where the port has no such counters, or made no step."""


def read(rec):
    if rec.get("kind") != "race":
        return None
    from f1tenth_gym_tpu_torch.parallel import vector

    calls = getattr(vector.make_autoreset_step, "calls", None)
    replays = getattr(vector.make_autoreset_step, "replays", None)
    if not calls or replays is None:
        return None
    return replays / calls
