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

``save_orbax``/``load_orbax`` (JAX ``:98-114``) are the sharded form, on
``torch.distributed.checkpoint``: every rank calls them, and the files
are torch's distributed-checkpoint format, not orbax's.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Iterator, List, Optional, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch import nn

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.parallel.sharding import env_batch_sharding
from f1tenth_gym_tpu_torch.state import SimState, VehicleParams


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


def load_pytree(path: str, target: Optional[Any] = None, device=False,
                allow_pickle: bool = False) -> Any:
    """Load a file written by ``save_pytree`` (either package's).

    With ``target`` (a tree of the expected structure, e.g. a freshly
    built ``TrainState``), the leaves are restored into its structure
    after checking that the keypaths match, and each leaf's shape and
    dtype; tensors land on the target leaf's device. Without a target,
    returns ``{keypath: leaf}``: numpy arrays when ``device`` is False (the
    default), tensors on the card when it is True, else tensors on the
    device it names.

    ``allow_pickle=True`` is the JAX package's way to rebuild the stored
    tree structure by unpickling it. The port never unpickles, so it
    raises: pass ``target=`` for the structure instead."""
    if allow_pickle:
        raise ValueError(
            "load_pytree never unpickles a stored tree structure; pass "
            "target=<template tree> to restore into a structure (or no "
            "target for a flat {keypath: leaf} dict)")
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        n = len([k for k in z.files if k.startswith("leaf_")])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        keypaths = [str(k) for k in z["__keypaths__"]]
    if target is None:
        if device is not False:
            dev = resolve_device(None if device is True else device)
            leaves = [torch.from_numpy(x).to(dev) for x in leaves]
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


def _env_sharded(tree, prefix: str = "") -> Set[str]:
    """Keypaths of the leaves of ``tree`` that lead with the env axis and
    are split over 'env' under a mesh: every leaf of a ``SimState``, and
    the (E, 1) leaves of a ``VehicleParams`` (``sharding.replicate``)."""
    if isinstance(tree, SimState):
        return {kp for kp, _ in _leaves(tree, prefix)}
    if isinstance(tree, VehicleParams):
        return {kp for kp, leaf in _leaves(tree, prefix) if leaf.dim() == 2}
    kids = None if tree is None else _children(tree)
    return set().union(*(_env_sharded(child, prefix + frag)
                         for frag, child in kids or ()))


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.as_tensor(np.asarray(leaf))


def _dcp_state(tree, mesh, fill):
    """{keypath: tensor} of ``tree``'s leaves (``fill`` makes each from the
    leaf), the env-sharded ones as the global ``DTensor`` under a mesh."""
    sharded = _env_sharded(tree) if mesh is not None else set()
    view = env_batch_sharding(mesh).global_view if mesh is not None else None
    return {kp: view(fill(_as_tensor(leaf))) if kp in sharded
            else fill(_as_tensor(leaf))
            for kp, leaf in _leaves(tree)}


def _dcp(fn, state, path):
    with warnings.catch_warnings():
        # the one-process form warns that it assumes one process
        warnings.simplefilter("ignore", UserWarning)
        fn(state, checkpoint_id=path, no_dist=not dist.is_initialized())


def save_orbax(path: str, tree: Any, mesh=None) -> str:
    """Save ``tree`` with ``torch.distributed.checkpoint`` into directory
    ``path``: every rank of the process group calls it (or one process
    without a group). The files are torch's format, not orbax's.

    Keys are ``save_pytree``'s keypaths. Under ``mesh`` the env-sharded
    leaves (those of a ``SimState``, and a ``VehicleParams``' (E, 1)
    leaves) are saved as their global batch, each rank writing its rows,
    so that a checkpoint written at one world size loads at another; the
    other leaves are taken as replicated and written once. A ``shard``-ed
    net's split parameters are not whole on any rank: save a split net
    through ``convert.actor_critic_to_numpy``. Returns the absolute
    path."""
    path = os.path.abspath(path)
    _dcp(dcp.save, _dcp_state(tree, mesh, lambda t: t.contiguous()), path)
    return path


def load_orbax(path: str, target: Any, mesh=None) -> Any:
    """Restore a ``save_orbax`` checkpoint into the structure of
    ``target`` (as ``load_pytree`` does, leaves checked by shape and
    dtype). Under ``mesh`` each rank reads the rows of the env-sharded
    leaves that its 'env' index owns, whatever world size wrote them."""
    path = os.path.abspath(path)
    state = _dcp_state(target, mesh, torch.empty_like)
    _dcp(dcp.load, state, path)
    arrays = ((kp, (t.to_local() if hasattr(t, "to_local") else t)
               .cpu().numpy()) for kp, t in state.items())
    return _rebuild(target, arrays)
