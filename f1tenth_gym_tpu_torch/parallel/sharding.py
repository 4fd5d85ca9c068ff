"""Sharding of env batches over an ('env', 'model') mesh of ranks.

Port of ``f1tenth_gym_tpu/parallel/sharding.py`` on ``torch.distributed``.
One process (a rank) drives one device, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of the ranks with dims
('env', 'model'). The env batch is split over 'env' and replicated over
'model'; the PPO learner splits its MLP over 'model' and reduces its
gradients over 'env' (``parallel/ppo.py``).

Where JAX lays one global array out over the devices, the env state here
stays plain local tensors: each rank holds the contiguous slice of the
global E axis that its 'env' index owns, on its own device. So the scan
kernel (bound through ctypes) and the eager step run unchanged on each
rank's shard, and stepping never communicates. ``env_batch_sharding`` and
``replicated_sharding`` give the ``DTensor`` view of the two layouts, for
code that needs the global batch (the sharded checkpoint).

A rank's scans must be whole 8-scan subgroups of the scan kernel
(``E_local * A % 8 == 0``): the kernel picks the culled window per
subgroup, so a subgroup cut at a shard boundary could change the window,
and on a split pack the bits of its scans. ``shard_states`` checks it.

``make_mesh`` needs no launcher: in a process without a process group it
starts a one-rank gloo group on an in-process store (no port, no
``MASTER_*`` variables), so a plain ``python`` run is world size 1.

The collectives the port needs (``all_reduce_sum``, ``all_gather_cat``)
return their input at group size 1. Under gloo they stage CUDA tensors
through the host explicitly: two ranks that share one card cannot use
NCCL, and the gloo path then holds only a few small tensors a call (the
learner's gradients, metrics, shapes); the env step never leaves the card.
"""

from __future__ import annotations

import atexit
import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.ops.scan_kernel import SUB
from f1tenth_gym_tpu_torch.state import SimState, VehicleParams

ENV_AXIS = "env"
MODEL_AXIS = "model"


# the one-rank group that ``make_mesh`` starts when there is none
_local_group = None


def _destroy_local_group():
    if in_local_group():
        dist.destroy_process_group()


def in_local_group() -> bool:
    """True when this process's group is the one-rank group that
    ``make_mesh`` started for want of another."""
    return dist.is_initialized() and dist.group.WORLD is _local_group


def make_mesh(num_env_shards: Optional[int] = None, num_model_shards: int = 1,
              devices=None) -> DeviceMesh:
    """('env', 'model') mesh over the ranks of the process group.

    ``devices`` is the device this rank's shard lives on, as
    ``resolve_device`` takes it (default: the card; ``"cpu"`` for CPU
    ranks); the mesh takes its type. Without a process group the mesh is
    world size 1 on a one-rank gloo group that this call starts; a later
    ``multihost.initialize`` that would join ranks then raises."""
    global _local_group
    dev = resolve_device(devices)
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        _local_group = dist.group.WORLD
        atexit.register(_destroy_local_group)
    n = dist.get_world_size()
    if num_env_shards is None:
        num_env_shards = n // num_model_shards
    if num_env_shards * num_model_shards != n:
        raise ValueError(f"{num_env_shards}x{num_model_shards} != {n} ranks")
    return init_device_mesh(dev.type, (num_env_shards, num_model_shards),
                            mesh_dim_names=(ENV_AXIS, MODEL_AXIS))


def local_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's shard."""
    return resolve_device(mesh.device_type)


def env_shard(mesh: Optional[DeviceMesh]) -> Tuple[int, int]:
    """(index, count) of this rank's shard on the 'env' axis; (0, 1)
    without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(ENV_AXIS), mesh.size(0)


def axis_group(mesh: Optional[DeviceMesh], axis: str):
    """The process group of ``axis`` through this rank, or None when the
    axis has one rank (nothing to reduce) or there is no mesh."""
    if mesh is None or mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
        return None
    return mesh.get_group(axis)


class Sharding(NamedTuple):
    """A layout on ``mesh``: the ``DTensor`` placements of its dims."""

    mesh: DeviceMesh
    placements: Tuple

    def global_view(self, local: torch.Tensor) -> DTensor:
        """``local`` (this rank's piece) as the global ``DTensor``."""
        shape = list(local.shape)
        for dim, p in enumerate(self.placements):
            if isinstance(p, Shard):
                shape[p.dim] *= self.mesh.size(dim)
        local = local.contiguous()
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)


def env_batch_sharding(mesh: DeviceMesh) -> Sharding:
    """Leaves with a leading E axis: split over 'env', whole over 'model'."""
    return Sharding(mesh, (Shard(0), Replicate()))


def replicated_sharding(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, (Replicate(), Replicate()))


def tree_map(fn: Callable[[Any], Any], tree,
             is_leaf: Optional[Callable[[Any], bool]] = None):
    """``fn`` on every tensor of ``tree`` (dicts, lists, tuples, named
    tuples and dataclasses), or on every node ``is_leaf`` picks; other
    leaves stay as they are."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree) if is_leaf is None else tree
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, is_leaf))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, is_leaf) for v in tree]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), is_leaf)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _rows(mesh: DeviceMesh, num_envs: int) -> slice:
    idx, n = env_shard(mesh)
    if num_envs % n:
        raise ValueError(f"{num_envs} envs do not split over {n} 'env' "
                         "shards")
    e = num_envs // n
    return slice(idx * e, (idx + 1) * e)


def shard_env_pytree(tree, mesh: DeviceMesh):
    """This rank's rows of every leaf of ``tree``, each of which leads
    with the global E axis, on this rank's device (copies)."""
    dev = local_device(mesh)
    return tree_map(lambda x: x[_rows(mesh, x.shape[0])].to(dev, copy=True),
                    tree)


def shard_states(states: SimState, mesh: DeviceMesh) -> SimState:
    """This rank's rows of the global batch ``states``, on its device.

    The rows must be whole 8-scan subgroups of the scan kernel (module
    docstring)."""
    rows = _rows(mesh, states.num_envs)
    if ((rows.stop - rows.start) * states.num_agents) % SUB:
        raise ValueError(
            f"{rows.stop - rows.start} envs x {states.num_agents} agents a "
            f"shard is not a whole number of {SUB}-scan kernel subgroups")
    return shard_env_pytree(states, mesh)


def replicate(tree, mesh: DeviceMesh):
    """Put map rasters, tables and params whole on this rank's device.

    The exception is a ``VehicleParams`` leaf of shape (E, 1), one value an
    env (``examples/param_sweep.py``): it is sharded like the states, so
    that it lines up with this rank's envs."""
    dev = local_device(mesh)

    def put_param(x):
        return x[_rows(mesh, x.shape[0])].to(dev) if x.dim() == 2 \
            else x.to(dev)

    def put(node):
        if isinstance(node, VehicleParams):
            return tree_map(put_param, node)
        return node.to(dev)

    return tree_map(put, tree, is_leaf=lambda node: isinstance(
        node, (torch.Tensor, VehicleParams)))


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``t`` that the group's backend can take."""
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        return t.detach().cpu()
    return t.detach().clone()


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` as a new tensor on ``t``'s device;
    ``t`` itself when ``group`` is None."""
    if group is None:
        return t
    buf = _staged(t, group)
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The pieces of ``t`` of every rank of ``group``, joined along
    ``dim`` in rank order; ``t`` itself when ``group`` is None."""
    if group is None:
        return t
    buf = _staged(t, group).contiguous()
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim).to(t.device)
