"""Meshes across processes (the port's counterpart of
cudasw4_tpu/parallel/multihost.py), on ``torch.distributed``.

Each process initialises one process group, contributes its devices to one
global mesh (``global_mesh``), and the sharded scans of parallel/sharding.py
run unchanged: each process scores its own shards and only the k candidates
a shard and query cross processes (NCCL between cards, gloo on the host).
Every process loads and packs the same database and calls scans in the same
order; the results are the same on every process, and the primary prints.

Usage (one process per host, or per card):
    from cudasw4_tpu_torch.parallel.multihost import global_mesh, initialize, is_primary
    initialize(coordinator="host0:29500", num_processes=N, process_id=i)
    engine = SearchEngine(mesh=global_mesh(), ...)

NCCL refuses two ranks on one card: processes that share a card gather
over gloo (``backend="gloo"``), their candidates copied to the host first.
"""

from __future__ import annotations

import torch

from .sharding import Mesh, make_mesh


def default_backend() -> str:
    """NCCL where there is a card, gloo on the CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> None:
    """Join the process group at ``coordinator``: "host:port" (the rank 0
    process listens there) or "file:///path" (a file store on a shared file
    system, made by the first process to arrive).  A no-op for one process
    unless ``backend`` is named (one process can still form a group, to run
    a backend alone), and when a group exists already."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if (num_processes is None or num_processes <= 1) and backend is None:
        return
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend or default_backend(), init_method=init,
                            world_size=num_processes or 1, rank=process_id or 0)


def global_mesh(devices=None) -> Mesh:
    """One mesh over every process's ``devices`` (default: each process's
    visible CUDA devices), in rank order; without a process group, the
    local mesh.  Every process must bring as many devices."""
    import torch.distributed as dist

    local = make_mesh(devices)
    if not dist.is_initialized():
        return local
    if dist.get_backend() == "nccl":
        torch.cuda.set_device(local.devices[0])
    names: list = [None] * dist.get_world_size()
    dist.all_gather_object(names, [str(d) for d in local.devices])
    if len({len(n) for n in names}) != 1:
        raise ValueError(f"processes bring unequal device counts: {[len(n) for n in names]}")
    n = len(local.devices)
    rank = dist.get_rank()
    return Mesh([d for per in names for d in per], local=range(rank * n, (rank + 1) * n),
                group=dist.group.WORLD)


def is_primary() -> bool:
    """Whether this process prints: rank 0, or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group, if there is one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
