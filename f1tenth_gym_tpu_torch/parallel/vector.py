"""Batched envs: reset/step, pose sampling, locality sort, auto-reset.

Port of ``f1tenth_gym_tpu/parallel/vector.py`` (``batch_reset``,
``batch_step``, ``uniform_pose_sampler``, ``tile_snake_key``,
``sort_envs_for_locality``, ``make_autoreset_step``). The JAX package
vmaps one env; here the env axis is explicit, so the batch functions are
the env functions on a device the caller chose.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from f1tenth_gym_tpu_torch.config import DEFAULT_SEED, SimConfig, resolve_device
from f1tenth_gym_tpu_torch.core.env import env_reset, env_step, init_state
from f1tenth_gym_tpu_torch.state import MapData, ScanTables, SimState, VehicleParams
from f1tenth_gym_tpu_torch.utils.profiling import annotate


def make_generator(device, seed: int = DEFAULT_SEED) -> torch.Generator:
    """A torch.Generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen


def _check_map_device(map_data: MapData, dev: torch.device):
    if map_data.device != dev:
        raise ValueError(f"map tensors are on {map_data.device}, the envs "
                         f"were asked to run on {dev}")


def batch_reset(poses: torch.Tensor, params: VehicleParams, map_data: MapData,
                tables: ScanTables, cfg: SimConfig, timestep,
                generator: Optional[torch.Generator] = None, device=None):
    """Reset E envs at ``poses`` (E, A, 3) on ``device`` (default: the
    card). Returns (states, obs, reward, done, info)."""
    dev = resolve_device(device)
    _check_map_device(map_data, dev)
    if cfg.scan_noise and generator is None:
        generator = make_generator(dev)
    return env_reset(torch.as_tensor(poses).to(dev), params, map_data, tables,
                     cfg, timestep, generator)


def batch_step(states: SimState, actions: torch.Tensor, params: VehicleParams,
               map_data: MapData, tables: ScanTables, cfg: SimConfig, timestep,
               generator: Optional[torch.Generator] = None):
    """Step E envs in lockstep; actions (E, A, 2)."""
    return env_step(states, actions, params, map_data, tables, cfg, timestep,
                    generator)


def uniform_pose_sampler(map_data: MapData, clearance: float = 0.6,
                         max_candidates: int = 65536,
                         component_seed: Optional[Tuple[float, float]] = None,
                         grouped: bool = False,
                         align_theta: bool = False):
    """Start-pose sampler over the map's free space.

    Host side (numpy/scipy, once): candidate cells whose obstacle distance
    exceeds ``clearance``, optionally on the free component of
    ``component_seed``; with ``grouped``, the 16-slot oriented start-grid
    ring around each candidate (pairwise >= 0.688 m apart); with
    ``grouped`` or ``align_theta``, the corridor tangent. Device side:
    ``sample(generator, shape) -> (*shape, 3)`` poses. Same semantics as
    the JAX sampler; the random numbers come from ``generator``.
    """
    dt = map_data.dt.cpu().numpy()
    dev, dtype = map_data.dt.device, map_data.dt.dtype
    res = float(map_data.resolution)
    free = dt > clearance
    orig_c, orig_s = float(map_data.orig_c), float(map_data.orig_s)
    orig_x, orig_y = float(map_data.orig_x), float(map_data.orig_y)
    if component_seed is not None:
        from scipy import ndimage

        sx, sy = component_seed
        mx = (sx - orig_x) * orig_c + (sy - orig_y) * orig_s
        my = -(sx - orig_x) * orig_s + (sy - orig_y) * orig_c
        r0, c0 = int(my / res), int(mx / res)
        labels, _ = ndimage.label(free)
        if (not (0 <= r0 < free.shape[0] and 0 <= c0 < free.shape[1])
                or not free[r0, c0]):
            raise ValueError(f"component_seed {component_seed} is not free space")
        free = labels == labels[r0, c0]
    rows, cols = np.nonzero(free)
    if len(rows) == 0:
        raise ValueError("no free space with requested clearance")
    if len(rows) > max_candidates:
        sel = np.random.default_rng(0).choice(len(rows), max_candidates,
                                              replace=False)
        rows, cols = rows[sel], cols[sel]
    xs_m = (cols + 0.5) * res
    ys_m = (rows + 0.5) * res
    xs_w = xs_m * orig_c - ys_m * orig_s + orig_x
    ys_w = xs_m * orig_s + ys_m * orig_c + orig_y
    tangents = None
    if align_theta or grouped:
        gy, gx = np.gradient(dt)
        gxc, gyc = gx[rows, cols], gy[rows, cols]
        gxw = gxc * orig_c - gyc * orig_s
        gyw = gxc * orig_s + gyc * orig_c
        tangents = np.arctan2(gxw, -gyw)  # grad rotated by -90 deg
    slot_xy = slot_counts = None
    if grouped:
        # oriented ring of 16 start slots: 4 line rotations x offsets
        # +-0.9 / +-1.8 m, valid slots first
        k_off = np.array([1, -1] * 4 + [2, -2] * 4, np.float64)
        rot = np.array([0.0, 0.0, 0.25, 0.25, 0.5, 0.5, 0.75, 0.75] * 2,
                       np.float64) * np.pi
        ang = tangents[:, None] + rot[None, :]
        dxw = 0.9 * k_off[None, :] * np.cos(ang)
        dyw = 0.9 * k_off[None, :] * np.sin(ang)
        dxm = dxw * orig_c + dyw * orig_s
        dym = -dxw * orig_s + dyw * orig_c
        pc = (cols + 0.5)[:, None] + dxm / res
        pr = (rows + 0.5)[:, None] + dym / res
        inb = (pr >= 0) & (pr < dt.shape[0]) & (pc >= 0) & (pc < dt.shape[1])
        rr = np.clip(pr.astype(np.int64), 0, dt.shape[0] - 1)
        cc = np.clip(pc.astype(np.int64), 0, dt.shape[1] - 1)
        valid = inb & free[rr, cc]
        counts = valid.sum(1)
        order = np.argsort(~valid, axis=1, kind="stable")
        sx = xs_w[:, None] + np.take_along_axis(dxw, order, 1)
        sy = ys_w[:, None] + np.take_along_axis(dyw, order, 1)
        none = counts == 0
        sx[none] = xs_w[none, None]
        sy[none] = ys_w[none, None]
        slot_xy = torch.as_tensor(np.stack([sx, sy], -1), dtype=dtype,
                                  device=dev)  # (n, 16, 2)
        slot_counts = torch.as_tensor(counts, dtype=torch.int64, device=dev)
    candidates = torch.as_tensor(np.stack([xs_w, ys_w], 1), dtype=dtype,
                                 device=dev)
    if tangents is not None:
        tangents = torch.as_tensor(tangents, dtype=dtype, device=dev)

    def sample(generator: torch.Generator, shape: Tuple[int, ...]):
        n = int(np.prod(shape)) if shape else 1

        def randint(high, size):
            return torch.randint(0, high, size, generator=generator,
                                 device=dev)

        def uniform(size):
            return torch.rand(size, generator=generator, dtype=dtype,
                              device=dev)

        idx = randint(candidates.shape[0], (n,))
        group = grouped and len(shape) >= 1 and shape[-1] > 1
        grp_xy = None
        if group:
            # agents 1..a-1 take consecutive slots of agent 0's ring from
            # a random shift bounded to the 8 nearest slots
            a = shape[-1]
            idx = idx.view(-1, a)
            cnt = slot_counts[idx[:, 0]]
            max_shift = torch.clamp(torch.clamp(cnt, max=8) - (a - 2), min=1)
            shift = randint(1 << 30, (idx.shape[0],)) % max_shift
            slots = ((shift[:, None] + torch.arange(a - 1, device=dev))
                     % torch.clamp(cnt, min=1)[:, None])
            grp_xy = slot_xy[idx[:, :1], slots]  # (groups, a-1, 2)
            idx = idx.reshape(-1)
        xy = candidates[idx]
        if grp_xy is not None:
            xy = xy.view(-1, a, 2)
            xy[:, 1:] = grp_xy
            xy = xy.view(-1, 2)
        if align_theta:
            flip = uniform((n,)) < 0.5
            jitter = uniform((n,)) * 0.6 - 0.3
            theta = tangents[idx] + torch.where(flip, np.pi, 0.0) + jitter
            if group:
                # one racing direction per group: agent 0's heading
                theta = theta.view(-1, a)[:, :1].expand(-1, a).reshape(-1)
            theta = torch.remainder(theta, 2.0 * np.pi)[:, None]
        else:
            theta = uniform((n, 1)) * (2.0 * np.pi)
        return torch.cat([xy, theta], 1).view(*shape, 3)

    return sample


def tile_snake_key(x, y, tile_size: float, origin=(0.0, 0.0)):
    """Boustrophedon (snake) tile-order sort key: snake order over the
    culling tiles, then the snaked tile quadrant."""
    tx = (x - origin[0]) / tile_size
    ty = (y - origin[1]) / tile_size
    ti = torch.floor(tx)
    tj = torch.floor(ty)
    snake = torch.where(torch.remainder(tj, 2.0) == 0.0, ti, 4095.0 - ti)
    fx = torch.floor((tx - ti) * 2.0)
    fy = torch.floor((ty - tj) * 2.0)
    fxs = torch.where(torch.remainder(fy, 2.0) == 0.0, fx, 1.0 - fx)
    return (tj * 4096.0 + snake) * 4.0 + fy * 2.0 + fxs


def sort_envs_for_locality(states: SimState, tile_size: float = None,
                           origin: Tuple[float, float] = (0.0, 0.0),
                           return_order: bool = False):
    """Reorder the env batch so spatially near envs are batch-adjacent.

    A pure relabeling (envs are independent) that keeps the kernel's
    8-scan subgroups on one culling tile. With ``tile_size``/``origin``
    (the map's culling grid) envs are keyed on the tile of their agents'
    midpoint in snake order; without, on a 6 m / 1.5 m block key. Not to
    be combined with positional ``reset_poses`` auto-reset.

    Returns the sorted states; with ``return_order``, ``(states, order)``:
    the (E,) int64 permutation applied, new slot k holding the env of old
    slot ``order[k]``, so that per-env data kept outside the state follows
    its env as ``data[order]``.
    """
    with annotate("vector.sort"):
        if tile_size is None:
            x = states.x[:, 0, 0]
            y = states.x[:, 0, 1]
            by = torch.floor(y / 6.0)
            bx = torch.floor(x / 6.0)
            fy = torch.remainder(torch.floor(y / 1.5), 4.0)
            fx = torch.remainder(torch.floor(x / 1.5), 4.0)
            key = ((by * 4096.0 + bx) * 4.0 + fy) * 4.0 + fx
        else:
            mx = states.x[:, :, 0].mean(1)
            my = states.x[:, :, 1].mean(1)
            key = tile_snake_key(mx, my, tile_size, origin)
        order = torch.argsort(key, stable=True)
        states = states.map(lambda leaf: leaf[order])
    return (states, order) if return_order else states


def make_autoreset_step(params: VehicleParams, map_data: MapData,
                        tables: ScanTables, cfg: SimConfig, timestep,
                        pose_sampler: Optional[Callable] = None,
                        reset_poses: Optional[torch.Tensor] = None,
                        reset_to_start: bool = False,
                        generator: Optional[torch.Generator] = None,
                        device=None):
    """``step(states, actions) -> (states', obs, reward, done, info)`` in
    which done envs are replaced by ``init_state`` at their reset poses:
    zero scans and no zero-action step (vector.py:331-351). The obs is
    the pre-reset (terminal) one.

    Exactly one of ``pose_sampler`` / ``reset_poses`` (E, A, 3, positional:
    do not combine with the locality sort) / ``reset_to_start`` (each env
    back to its own start grid, carried in the state). ``generator`` (one
    is made on ``device`` when omitted) draws the scan noise and the
    sampled poses.
    """
    n_modes = sum([pose_sampler is not None, reset_poses is not None,
                   bool(reset_to_start)])
    if n_modes != 1:
        raise ValueError(
            "pass exactly one of pose_sampler / reset_poses / reset_to_start")
    dev = resolve_device(device)
    _check_map_device(map_data, dev)
    if generator is None:
        generator = make_generator(dev)
    if reset_poses is not None:
        reset_poses = torch.as_tensor(reset_poses).to(dev)
    # on the card once, so that no step copies it there
    timestep = torch.as_tensor(timestep, dtype=cfg.torch_dtype, device=dev)

    def step(states: SimState, actions: torch.Tensor):
        with annotate("vector.step"):
            states, obs, reward, done, info = batch_step(
                states, actions, params, map_data, tables, cfg, timestep,
                generator)
            with annotate("vector.reset"):
                if reset_to_start:
                    poses = torch.stack([states.start_xs, states.start_ys,
                                         states.start_thetas], -1)
                elif pose_sampler is not None:
                    poses = pose_sampler(generator,
                                         (states.num_envs, cfg.num_agents))
                else:
                    poses = reset_poses
                fresh = init_state(poses, cfg)

                def select(new, cur):
                    d = done.view(done.shape + (1,) * (cur.dim() - 1))
                    return torch.where(d, new, cur)

                states = SimState(**{
                    k: select(getattr(fresh, k), getattr(states, k))
                    for k in states.__dataclass_fields__})
        return states, obs, reward, done, info

    step.generator = generator
    return step
