"""Multi-process execution: process-group set-up and host-local batches.

Port of ``f1tenth_gym_tpu/parallel/multihost.py`` on ``torch.distributed``.
Every process runs the same program; ``initialize`` wires the processes
into one group, and the env batch splits over a global ('env', 'model')
mesh whose 'env' axis spans them. Stepping never communicates: each rank
steps its own shard. Only the learner's reductions cross ranks.

    from f1tenth_gym_tpu_torch.parallel import multihost
    multihost.initialize()                 # no-op in a lone process
    mesh = multihost.global_mesh()         # 'env' spans every rank
    states = multihost.host_local_states(make_local_batch, mesh,
                                         envs_per_host=4096)
    # ... PPO(..., mesh=mesh) exactly as in one process

Under ``torchrun --nproc_per_node N`` the cluster variables are set and
``initialize()`` joins the group; in a plain ``python`` process there are
none and it leaves the process local (world size 1).

The backend is NCCL when every rank of the host has a card of its own,
else gloo (two ranks on one card, or CPU ranks). NCCL across cards is
written for but not run here: a machine with several cards checks it
(``ROADMAP.md``).

``spawn`` runs a function in N fresh local processes with a rendezvous
port: the tests, ``bench.py``'s weak scaling and the chip check launch
their ranks with it.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from f1tenth_gym_tpu_torch.config import resolve_device
from f1tenth_gym_tpu_torch.parallel.sharding import (
    in_local_group,
    local_device,
    make_mesh,
    tree_map,
)

_CLUSTER_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def is_initialized() -> bool:
    """True when this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = 300.0,
               devices=None) -> None:
    """Join the process group (the JAX rule, multihost.py:51-77).

    With no arguments the cluster comes from ``torchrun``'s variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); without
    them the process stays local. An explicit call names the coordinator
    (``"host:port"``), the process count and this process's id. A failure
    of either kind raises; a call in a process that already has a group is
    a no-op. Call it before ``make_mesh``: when ``make_mesh`` has already
    started its one-rank group, a call that would join ranks raises (as
    JAX's must precede any other jax call).

    ``devices`` is the device the ranks run on, as ``make_mesh`` takes it
    (default: the card; ``"cpu"`` for CPU ranks). On the card each rank
    takes card ``LOCAL_RANK % cards`` (its rank when ``LOCAL_RANK`` is
    unset). ``backend`` defaults to NCCL when the ranks run on the card and
    every rank of the host has a card of its own, else gloo; it may be
    forced."""
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not all(v in os.environ for v in _CLUSTER_VARS):
        return
    if in_local_group():
        raise RuntimeError(
            "make_mesh() already started a one-rank process group; call "
            "multihost.initialize() before make_mesh()")
    if is_initialized():
        return
    world = (num_processes if num_processes is not None
             else int(os.environ["WORLD_SIZE"]))
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    on_card = torch.device("cuda" if devices is None else devices).type \
        == "cuda"
    cards = 0
    if on_card:
        resolve_device(devices)  # raises without a card
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % cards)
    if backend is None:
        backend = "nccl" if on_card and cards >= local_world else "gloo"
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   else "env://")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def global_mesh(num_model_shards: int = 1, devices=None):
    """('env', 'model') mesh over every rank of every process; ``devices``
    as ``make_mesh`` takes it (default: the card)."""
    return make_mesh(None, num_model_shards, devices)


def _shapes(tree) -> List[tuple]:
    out = []
    tree_map(lambda x: out.append(tuple(x.shape)), tree)
    return out


def host_local_states(make_local_batch: Callable[[int], object], mesh,
                      envs_per_host: int):
    """This rank's env batch, built by ``make_local_batch(envs_per_host)``,
    on its device.

    No rank ever holds the full batch: the global E is ``envs_per_host``
    times the 'env' size of the mesh (the world size when 'model' is 1),
    and rank ``r`` holds rows ``[r, r + 1) * envs_per_host`` of it. An
    ``all_gather`` of the leaf shapes checks that every rank built the same
    local shape. Ranks that share an 'env' index must build the same
    batch."""
    local = make_local_batch(envs_per_host)
    if dist.get_world_size() > 1:
        mine = _shapes(local)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        bad = [r for r, s in enumerate(every) if s != mine]
        if bad:
            raise ValueError(f"ranks {bad} built other local shapes than "
                             f"rank {dist.get_rank()}'s {mine}")
    dev = local_device(mesh)
    return tree_map(lambda x: x.to(dev), local)


def free_port() -> int:
    """A free TCP port on localhost, for a local rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, nprocs, port, args, env, results):
    os.environ.update(env)
    torch.set_num_threads(1)  # the ranks share the host's cores
    try:
        results.put((rank, True, fn(rank, nprocs, port, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence = (),
          timeout_s: float = 120.0,
          env: Optional[Dict[str, str]] = None) -> list:
    """``fn(rank, nprocs, port, *args)`` in ``nprocs`` fresh processes
    (start method "spawn"; ``fn`` must be importable), each with one CPU
    thread and the variables ``env`` set; ``port`` is a free localhost
    port for the rendezvous. Returns the results in rank order: return
    numpy arrays, not tensors, since a tensor crosses the result queue as
    a handle to the rank's shared memory, which dies with the rank. A
    rank that raises, dies or outlives ``timeout_s`` fails the call: every
    rank is then killed and a RuntimeError carries what they reported."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, nprocs, port, tuple(args),
                               dict(env or {}), results), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) + len(errors) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                errors.append(f"timed out after {timeout_s} s")
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in got]
                if dead and results.empty():
                    errors.append(f"ranks {dead} died (exit codes "
                                  f"{[procs[r].exitcode for r in dead]})")
                    break
                continue
            if ok:
                got[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=0 if errors else 30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("spawned ranks failed: " + "\n".join(errors))
    return [got[r] for r in range(nprocs)]
