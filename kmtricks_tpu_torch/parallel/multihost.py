"""Several processes: the global mesh over ``torch.distributed``.

Counterpart of ``kmtricks_tpu/parallel/multihost.py``. Every process
calls :func:`initialize` with the same ``init_method`` and world size and
its own rank, then :func:`global_mesh` with its local devices (the same
number on every rank). The processes together form one mesh of ``world x
local`` shards, global shard ``g = rank * local + d`` (the JAX package's
process-major device order), each owning the partitions
``parallel/pipeline.py::partition_to_device`` gives it over all shards.

The runs that shards route to shards of other processes travel by
``parallel/pipeline.py::_exchange`` over the default group, whose
backend is the caller's. The small agreements (the lengths of the runs
exchanged, :func:`any_rank` for has-data flags, :func:`sum_over_ranks`
for histogram planes) and :func:`barrier` run on a gloo group, even
under NCCL. Every
collective is issued on the thread that drives the run, in the same
order on every rank.

JAX's ``make_global_batch`` and ``replicated`` have no counterpart: a
process's local rows are its shards' rows, and a replicated value is the
same tensor on every rank.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks before it raises
TIMEOUT_S = 600.0


class ProcessMesh(tuple):
    """This process's shards in a mesh that spans ``world`` processes: a
    tuple of torch devices, one per local shard, as
    ``parallel/pipeline.py::make_mesh`` gives (so code that runs per local
    shard takes it as it takes a one-process mesh), with ``rank``,
    ``world``, the ``backend`` of the default group, the gloo group for
    the host's agreements and the totals of the run exchanges
    (``exchanged``: bytes sent and received, seconds, calls)."""

    def __new__(cls, devices, *, rank: int, world: int, backend: str,
                host_group):
        mesh = super().__new__(cls, devices)
        mesh.rank, mesh.world, mesh.backend = rank, world, backend
        mesh.host_group = host_group
        mesh.exchanged = {"bytes_sent": 0, "bytes_received": 0,
                          "seconds": 0.0, "calls": 0}
        return mesh


def initialize(init_method: str, world_size: int, rank: int,
               backend: str = "gloo", timeout_s: float = TIMEOUT_S) -> None:
    """Start ``torch.distributed`` for this rank (counterpart of
    ``initialize``): ``init_method`` as ``tcp://localhost:<port>``;
    ``backend`` is ``"gloo"`` or ``"nccl"``, as given (nothing replaces
    one with the other). NCCL takes one card of its own per rank, rank r
    on ``cuda:r`` of this host: it raises where two ranks would share a
    card, before any group starts. Collectives raise after
    ``timeout_s``."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("nccl needs CUDA, which is not available")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"nccl needs a card of its own per rank: {world_size} ranks "
                f"would share {cards} card(s) (gloo runs ranks that share "
                f"one)")
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def global_mesh(local_devices) -> ProcessMesh:
    """The global mesh (counterpart of ``global_mesh``) from this
    process's devices, one per local shard (a device may repeat, as in
    ``make_mesh``). A collective: every rank calls it, with as many local
    shards as every other rank. Under NCCL every local shard must be on
    the rank's own card."""
    # imported here: parallel.pipeline imports this module
    from kmtricks_tpu_torch.parallel.pipeline import make_mesh

    if not dist.is_initialized():
        raise RuntimeError("global_mesh: call initialize first")
    devices = make_mesh(local_devices)
    backend = dist.get_backend()
    if backend == "nccl":
        own = torch.device("cuda", torch.cuda.current_device())
        if any(d != own for d in devices):
            raise ValueError(f"nccl: every local shard must be on {own}, "
                             f"not {[str(d) for d in devices]}")
        host_group = dist.new_group(backend="gloo")
    else:
        host_group = dist.group.WORLD
    world = dist.get_world_size()
    n = torch.tensor([len(devices)], dtype=torch.int64)
    seen = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(seen, n, group=host_group)
    if any(int(s) != len(devices) for s in seen):
        raise ValueError(f"every rank needs as many local shards: "
                         f"{[int(s) for s in seen]}")
    return ProcessMesh(devices, rank=dist.get_rank(), world=world,
                       backend=backend, host_group=host_group)


def host_shard_bounds(total_rows: int, mesh: ProcessMesh) -> tuple[int, int]:
    """The rows [lo, hi) of a global batch that this process feeds
    (counterpart of ``host_shard_bounds``): contiguous blocks of
    ``total_rows // world``, the last rank taking the rest."""
    per = total_rows // mesh.world
    lo = mesh.rank * per
    return lo, (lo + per if mesh.rank + 1 < mesh.world else total_rows)


def barrier(mesh: ProcessMesh) -> None:
    """Wait for every rank (``sync_global_devices``), on the gloo group."""
    dist.barrier(group=mesh.host_group)


def any_rank(mesh: ProcessMesh, flag: bool) -> bool:
    """Whether ``flag`` holds on some rank (one all-reduce on the gloo
    group)."""
    t = torch.tensor([int(flag)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


def sum_over_ranks(mesh: ProcessMesh, arr: np.ndarray) -> np.ndarray:
    """The elementwise sum of a 64-bit integer array over the ranks (one
    all-reduce on the gloo group; uint64 wraps as it would on one
    host)."""
    t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int64).copy())
    dist.all_reduce(t, group=mesh.host_group)
    return t.numpy().view(arr.dtype)
