"""Carry state across from the JAX package's containers.

The JAX package's ``VehicleParams``, ``ScanTables``, ``MapData`` and
``SimState`` are pytrees. Given their leaves as a dict of numpy arrays
(``{name: np.asarray(leaf)}``), these functions build the port's
containers on a chosen device, so both packages can be fed identical
inputs. A batched JAX ``SimState`` carries the env axis E from ``vmap``
as the leading axis of every leaf; its PRNG ``key`` has no counterpart
here (the port draws from a ``torch.Generator``) and is dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from f1tenth_gym_tpu_torch.config import resolve_device
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
