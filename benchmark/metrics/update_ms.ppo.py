"""The learner's update a PPO iteration on the card's timeline, in ms: the
extent of the port's ``ppo.update`` span (GAE, the advantages'
normalization and every minibatch's forward, backward and clipped Adam
step), the time between the CUDA events it records at its enter and exit,
summed over the profiled iteration of the card's activity alone and divided
by its ``ppo.iteration`` spans. The extent holds the update's kernels and
any time the card waits inside it for the host. None in another kind of
cell, or where the port has no such spans."""


def read(rec):
    spans = (rec.get("ppo") or {}).get("spans") or {}
    update = spans.get("ppo.update", {}).get("extent_ms")
    iters = spans.get("ppo.iteration", {}).get("calls", 0)
    if not update or not iters:
        return None
    return update / iters
