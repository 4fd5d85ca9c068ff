"""The benchmark's import isolation: the process that prints a result may
not hold JAX, Flax or the JAX package. Names are compared by their top
level, the part before the first dot, whole: ``f1tenth_gym_tpu_torch``
(the port) is not ``f1tenth_gym_tpu`` (the JAX package)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "f1tenth_gym_tpu"})


def forbidden_loaded(modules=None) -> list:
    """Sorted top-level names of ``modules`` (default ``sys.modules``)
    that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
