"""Batched envs: reset/step, pose sampling, locality sort, auto-reset.

Port of ``f1tenth_gym_tpu/parallel/vector.py`` (``batch_reset``,
``batch_step``, ``uniform_pose_sampler``, ``tile_snake_key``,
``sort_envs_for_locality``, ``make_autoreset_step``). The JAX package
vmaps one env; here the env axis is explicit, so the batch functions are
the env functions on a device the caller chose. Where the JAX package
jits the auto-reset step into one program, the port captures it on the
card as one CUDA graph and replays it (``StepGraph``), so the host
enqueues one graph a step in place of its ~950 small kernels.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from f1tenth_gym_tpu_torch.config import DEFAULT_SEED, SimConfig, resolve_device
from f1tenth_gym_tpu_torch.core.env import env_reset, env_step, init_state
from f1tenth_gym_tpu_torch.state import MapData, ScanTables, SimState, VehicleParams
from f1tenth_gym_tpu_torch.utils.profiling import annotate, profiling_enabled


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


# The leaves of SimState that the step never reads: it writes each anew
# (the scans, the collision flags and partners, the lap counts), so a replay
# does not copy the caller's into the graph's inputs (the scans are 141.6 MB
# at 16,384 x 2 x 1080).
UNREAD_LEAVES = ("scans", "collisions", "collision_idx", "lap_counts")
_ALIGN = 256   # bytes: where each output's memory starts in a replay's copy
# Bytes: memory this large is copied out by a copy of its own, the rest by
# one multi-tensor copy, which is slow on large tensors. At 16,384 x 2 x
# 1080 on an H100 the two 141.6 MB scans copied on their own and the 22
# other outputs' memories (at most 0.9 MB each) together take 0.212 ms; all
# in one multi-tensor copy, 0.348 ms.
_OWN_COPY = 1 << 24


def _tensors(states: SimState, actions: torch.Tensor):
    return [getattr(states, k) for k in states.__dataclass_fields__] + [
        actions]


def _signature(states: SimState, actions: torch.Tensor) -> tuple:
    """What a graph is captured for: each leaf's and the actions' shape,
    dtype and device (a replay copies the inputs in, whatever their
    layout)."""
    return tuple((t.shape, t.dtype, t.device)
                 for t in _tensors(states, actions))


def _graphable(states: SimState, actions: torch.Tensor) -> bool:
    """Whether a graph may run this call: every input on the card, none
    requiring grad."""
    return all(t.is_cuda and not t.requires_grad
               for t in _tensors(states, actions))


def _grouped_copy(dsts, srcs):
    """``dst.copy_(src)`` for each pair, as one multi-tensor copy a dtype
    (a few launches in place of one a pair)."""
    groups = {}
    for d, s in zip(dsts, srcs):
        group = groups.setdefault(d.dtype, ([], []))
        group[0].append(d)
        group[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


def _flatten(out):
    """The step's outputs (states, obs, reward, done, info) as torch's
    pytree (leaves, spec), the states taken as a dict of their leaves."""
    states, *rest = out
    return tree_flatten(({k: getattr(states, k)
                          for k in states.__dataclass_fields__}, rest))


def _unflatten(leaves, spec):
    states, rest = tree_unflatten(leaves, spec)
    return (SimState(**states), *rest)


class _View(NamedTuple):
    """Where an output tensor lies in a replay's copy."""
    dtype: torch.dtype
    shape: tuple
    stride: tuple
    offset: int


class OutputCopy:
    """Fresh copies of the step's outputs ``out``, made anew by each
    ``__call__``: the memory under its tensors is copied once into one new
    buffer (memory of ``_OWN_COPY`` bytes or more, the scans, by a copy of
    its own, the rest by one multi-tensor copy), and each tensor is rebuilt
    there as the same view (shape, strides, offset), so outputs that
    shared memory still share it and no later call writes over what an
    earlier one returned. Leaves that are not tensors are kept."""

    def __init__(self, out):
        leaves, self.spec = _flatten(out)
        bases, self.views, size = {}, [], 0
        for t in leaves:
            if not isinstance(t, torch.Tensor):
                self.views.append(t)
                continue
            self.device = t.device
            mem = t.untyped_storage()
            if mem.data_ptr() not in bases:
                src = torch.empty(0, dtype=torch.uint8,
                                  device=t.device).set_(mem)
                bases[mem.data_ptr()] = (size, src)
                size += -(-mem.nbytes() // _ALIGN) * _ALIGN
            start = bases[mem.data_ptr()][0]
            self.views.append(_View(
                t.dtype, tuple(t.shape), t.stride(),
                start // t.element_size() + t.storage_offset()))
        self.sources = list(bases.values())
        self.nbytes = size

    def __call__(self):
        flat = torch.empty(self.nbytes, dtype=torch.uint8, device=self.device)
        small = ([], [])
        for a, src in self.sources:
            dst = flat[a:a + src.numel()]
            if src.numel() >= _OWN_COPY:
                dst.copy_(src)
            else:
                small[0].append(dst)
                small[1].append(src)
        _grouped_copy(*small)
        typed, leaves = {}, []
        for v in self.views:
            if isinstance(v, _View):
                if v.dtype not in typed:
                    typed[v.dtype] = flat.view(v.dtype)
                v = typed[v.dtype].as_strided(v.shape, v.stride, v.offset)
            leaves.append(v)
        return _unflatten(leaves, self.spec)


def _capture(graph, fn: Callable):
    """``fn()`` captured into ``graph`` (on a side stream, as
    ``torch.cuda.graph`` captures); returns its outputs, the memory each
    replay writes."""
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        return fn()


class StepGraph:
    """``body(states, actions)`` captured once as a CUDA graph for the
    signature of ``states`` and ``actions``, and replayed.

    The inputs are copied into the graph's own (``UNREAD_LEAVES`` are not
    copied: the body never reads them), and the outputs out of it into
    fresh tensors (``OutputCopy``). ``generator`` is registered with the
    graph, so a replay draws what an eager call would draw from its state
    and advances it as an eager call would. A replay runs no Python of the
    body: the kernel wrappers' ``launches`` count what the host launched
    itself, and a replay's kernels are seen by their names in a trace of
    the card."""

    def __init__(self, body: Callable, states: SimState,
                 actions: torch.Tensor, generator: torch.Generator):
        self.inputs = states.map(torch.empty_like)
        self.actions = torch.empty_like(actions)
        self.copied = [k for k in states.__dataclass_fields__
                       if k not in UNREAD_LEAVES]
        self.targets = [getattr(self.inputs, k) for k in self.copied] + [
            self.actions]
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with torch.no_grad():
            out = _capture(self.graph,
                           lambda: body(self.inputs, self.actions))
        self.output = OutputCopy(out)

    def __call__(self, states: SimState, actions: torch.Tensor):
        _grouped_copy(self.targets,
                      [getattr(states, k) for k in self.copied] + [actions])
        self.graph.replay()
        return self.output()


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

    On the card the step runs as a CUDA graph (``StepGraph``): the first
    call of each signature (every leaf's and the actions' shape, dtype
    and device) runs eagerly, so that the kernels are built and loaded;
    the next one made while no profiler records captures a graph
    of the step for that signature, and every later one replays it: the
    same kernels in the same order on the same stream, the same bits, the
    generator drawn and advanced as an eager step does, and outputs that
    no later call overwrites. Calls on the CPU, with inputs that require
    grad, or with the march scan engine (which syncs the host to stop)
    run eagerly. Each signature's graph keeps its memory pool for the
    step's life. ``step.eager`` is the eager step, the function the graph
    captures; ``step.generator`` the generator. ``make_autoreset_step``'s
    ``calls``, ``replays`` and ``captures`` count over every step it made.
    A replay runs no Python of the step, so the kernel wrappers'
    ``launches`` do not move; a trace of the card names its kernels.
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

    def eager(states: SimState, actions: torch.Tensor):
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

    capturable = cfg.resolved_scan_engine(
        dev, map_data.seg_table is not None) != "march"
    graphs = {}   # signature -> its StepGraph; None after its eager call

    def step(states: SimState, actions: torch.Tensor):
        make_autoreset_step.calls += 1
        if not (capturable and _graphable(states, actions)):
            return eager(states, actions)
        key = _signature(states, actions)
        graph = graphs.get(key)
        if graph is None:
            if key not in graphs or profiling_enabled():
                graphs[key] = None
                return eager(states, actions)
            graph = graphs[key] = StepGraph(eager, states, actions,
                                            generator)
            make_autoreset_step.captures += 1
        with annotate("vector.step"):
            out = graph(states, actions)
        make_autoreset_step.replays += 1
        return out

    step.eager = eager
    step.generator = generator
    return step


make_autoreset_step.calls = 0
make_autoreset_step.replays = 0
make_autoreset_step.captures = 0
