"""The update's share of a PPO iteration on the card's timeline: the
extent of the port's ``ppo.update`` span over that of ``ppo.iteration``
(the sort, the rollout and the update), both over the profiled iteration
of the card's activity alone. None in another kind of cell, or where the
port has no such spans."""


def read(rec):
    spans = (rec.get("ppo") or {}).get("spans") or {}
    update = spans.get("ppo.update", {}).get("extent_ms")
    iteration = spans.get("ppo.iteration", {}).get("extent_ms")
    if not update or not iteration:
        return None
    return update / iteration
