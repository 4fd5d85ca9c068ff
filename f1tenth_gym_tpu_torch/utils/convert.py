"""Carry state across from the JAX package's containers.

The JAX package's ``VehicleParams``, ``ScanTables``, ``MapData`` and
``SimState`` are pytrees. Given their leaves as a dict of numpy arrays
(``{name: np.asarray(leaf)}``), these functions build the port's
containers on a chosen device, so both packages can be fed identical
inputs. A batched JAX ``SimState`` carries the env axis E from ``vmap``
as the leading axis of every leaf; its PRNG ``key`` has no counterpart
here (the port draws from a ``torch.Generator``) and is dropped.
``actor_critic_from_flax`` and ``actor_critic_to_numpy`` carry a PPO
policy's weights across (``parallel/ppo.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.parallel.ppo import ActorCritic
from f1tenth_gym_tpu_torch.parallel.sharding import all_gather_cat, local_device
from f1tenth_gym_tpu_torch.state import MapData, ScanTables, SimState, VehicleParams


def _tensors(cls, leaves: Dict[str, np.ndarray], dev, skip=()):
    out = {}
    for f in dataclasses.fields(cls):
        if f.name in skip:
            continue
        v = leaves.get(f.name)
        out[f.name] = None if v is None else torch.from_numpy(
            np.array(v)).to(dev)
    return out


def vehicle_params_from_jax(leaves, device=None) -> VehicleParams:
    return VehicleParams(**_tensors(VehicleParams, leaves,
                                    resolve_device(device)))


def scan_tables_from_jax(leaves, device=None) -> ScanTables:
    return ScanTables(**_tensors(ScanTables, leaves, resolve_device(device)))


def map_data_from_jax(leaves, device=None) -> MapData:
    kw = _tensors(MapData, leaves, resolve_device(device),
                  skip=("tile_meta_host",))
    meta = leaves.get("tile_meta")
    kw["tile_meta_host"] = (None if meta is None
                            else tuple(float(v) for v in np.asarray(meta)))
    return MapData(**kw)


def sim_state_from_jax(leaves, device=None) -> SimState:
    """Leaves of an E-batched JAX SimState -> the port's SimState."""
    return SimState(**_tensors(SimState, leaves, resolve_device(device)))


def to_numpy(obj) -> Dict[str, np.ndarray]:
    """Tensor leaves of a port container as numpy arrays (None kept)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
    return out


_DENSE_LAYERS = ("fc1", "fc2", "pi_mean", "vf")


def actor_critic_from_flax(params, device=None, mesh=None):
    """The port's ``ActorCritic`` holding the weights of a flax
    ``ActorCritic``: ``params`` is its nested dict of numpy arrays,
    ``{'params': {'fc1': {'kernel', 'bias'}, 'fc2': ..., 'pi_mean': ...,
    'vf': ..., 'pi_log_std'}}``. A flax kernel is (in, out), so each
    ``weight`` is its transpose; ``pi_log_std`` keeps its dtype, which
    becomes the module's sim dtype. Under a ``mesh`` the full tree comes
    in and the net takes this rank's slice (``ActorCritic.shard``); the
    device is then the rank's unless ``device`` says otherwise."""
    if device is None and mesh is not None:
        device = local_device(mesh)
    p = params["params"]
    log_std = np.asarray(p["pi_log_std"])
    kernel = np.asarray(p["fc1"]["kernel"])
    net = ActorCritic(kernel.shape[0], kernel.shape[1],
                      act_dim=log_std.shape[0],
                      dtype=getattr(torch, log_std.dtype.name), device=device)
    with torch.no_grad():
        for name in _DENSE_LAYERS:
            layer = getattr(net, name)
            layer.weight.copy_(torch.from_numpy(
                np.asarray(p[name]["kernel"]).T.copy()))
            layer.bias.copy_(torch.from_numpy(np.array(p[name]["bias"])))
        net.pi_log_std.copy_(torch.from_numpy(log_std.copy()))
    return net.shard(mesh)


def actor_critic_to_numpy(net) -> Dict[str, Dict]:
    """The inverse of ``actor_critic_from_flax``: the flax parameter dict
    of ``net`` as numpy arrays (the layout ``save_pytree`` of a flax
    ``net_params`` writes). A net split over 'model' is gathered whole:
    every rank of its group must call this."""
    def whole(name, part):
        t = getattr(getattr(net, name), part).detach()
        if f"{name}.{part}" in ActorCritic.MODEL_SPLIT:
            t = all_gather_cat(t, net.model_group,
                               dim=1 if name == "fc2" else 0)
        return t.cpu().numpy().copy()

    p = {name: {"kernel": whole(name, "weight").T, "bias": whole(name, "bias")}
         for name in _DENSE_LAYERS}
    p["pi_log_std"] = net.pi_log_std.detach().cpu().numpy().copy()
    return {"params": p}
