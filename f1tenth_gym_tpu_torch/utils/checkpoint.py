"""Checkpoint/resume for simulation and training state.

Port of ``f1tenth_gym_tpu/utils/checkpoint.py``'s ``.npz`` form: the same
layout (``leaf_i`` arrays and a ``__keypaths__`` array of key strings), so
that a file the JAX package's ``save_pytree`` wrote loads here, and a
file written here loads there with a target. The keypaths are JAX's
``keystr``: ``['key']`` for a dict key, ``.name`` for a dataclass field,
``[i]`` for a list or tuple item. Dict keys are taken in sorted order, as
JAX flattens them.

A tree is nested dicts, lists, tuples and dataclasses whose leaves are
tensors, numpy arrays or Python numbers; ``None`` holds no leaf. Besides:

* an ``nn.Module`` is its ``state_dict()``, and an object with
  ``state_dict``/``load_state_dict`` (an optimizer) is its state dict;
* a ``torch.Generator`` is its ``get_state()``: a learner's checkpoint
  must hold every generator, or a resumed run is not bit for bit the
  uninterrupted one.

``load_pytree(path, target)`` restores into ``target``'s structure,
checking every keypath, shape and dtype; it fills modules, optimizers and
generators of the target in place and returns the rebuilt tree. Nothing
is ever unpickled: the JAX package's ``__treedef__`` entry is ignored, and
without a target the file loads as a flat ``{keypath: array}`` dict.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _is_dataclass(obj) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def _has_state_dict(obj) -> bool:
    return (isinstance(obj, nn.Module)
            or (hasattr(obj, "state_dict") and hasattr(obj, "load_state_dict")))


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(keystr fragment, child) pairs of an inner node; None for a leaf."""
    if _has_state_dict(tree):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_dataclass(tree):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for frag, child in kids:
        yield from _leaves(child, prefix + frag)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        leaf = leaf.get_state()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> str:
    """Save ``tree`` to ``path`` (.npz: the leaves as ``leaf_i`` and their
    keypaths). Tensors come to the host; dtypes and shapes are kept
    exactly. Returns the path written."""
    leaves = list(_leaves(tree))
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(leaves)}
    keypaths = np.array([kp for kp, _ in leaves], dtype=str)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if not path.endswith(".npz"):
        path = path + ".npz"
    # an empty structure entry keeps the file loadable by the JAX
    # package's target form, which reads the entry without unpickling it
    np.savez(path, __treedef__=np.zeros(0, np.uint8), __keypaths__=keypaths,
             **arrays)
    return path


def _rebuild(target, arrays: Iterator[Tuple[str, np.ndarray]]):
    """``target`` with its leaves taken in order from ``arrays``."""
    if target is None:
        return None
    if _has_state_dict(target):
        target.load_state_dict(_rebuild(target.state_dict(), arrays))
        return target
    if isinstance(target, dict):
        out = {k: _rebuild(target[k], arrays) for k in sorted(target)}
        return type(target)((k, out[k]) for k in target)
    if _is_dataclass(target):
        return dataclasses.replace(target, **{
            f.name: _rebuild(getattr(target, f.name), arrays)
            for f in dataclasses.fields(target) if f.init})
    if isinstance(target, (list, tuple)):
        items = [_rebuild(v, arrays) for v in target]
        return (type(target)(*items) if hasattr(target, "_fields")
                else type(target)(items))
    kp, arr = next(arrays)
    want = _to_numpy(target)
    if arr.shape != want.shape or arr.dtype != want.dtype:
        raise ValueError(
            f"checkpoint leaf {kp} is {arr.dtype}{list(arr.shape)}, the "
            f"target's is {want.dtype}{list(want.shape)}")
    if isinstance(target, torch.Generator):
        target.set_state(torch.from_numpy(arr.copy()))
        return target
    if isinstance(target, torch.Tensor):
        return torch.from_numpy(arr.copy()).to(target.device)
    if isinstance(target, np.ndarray):
        return arr
    return arr.item()


def load_pytree(path: str, target: Optional[Any] = None) -> Any:
    """Load a file written by ``save_pytree`` (either package's).

    With ``target`` (a tree of the expected structure, e.g. a freshly
    built ``TrainState``), the leaves are restored into its structure
    after checking that the keypaths match, and each leaf's shape and
    dtype; tensors land on the target leaf's device. Without a target,
    returns ``{keypath: numpy array}``."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        n = len([k for k in z.files if k.startswith("leaf_")])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        keypaths = [str(k) for k in z["__keypaths__"]]
    if target is None:
        return dict(zip(keypaths, leaves))
    want = [kp for kp, _ in _leaves(target)]
    if len(want) != n:
        raise ValueError(f"checkpoint has {n} leaves but target has "
                         f"{len(want)}")
    if want != keypaths:
        bad = next(i for i, (w, g) in enumerate(zip(want, keypaths)) if w != g)
        raise ValueError(
            f"checkpoint structure mismatch at leaf {bad}: "
            f"file has {keypaths[bad]!r}, target has {want[bad]!r}")
    return _rebuild(target, iter(zip(keypaths, leaves)))

