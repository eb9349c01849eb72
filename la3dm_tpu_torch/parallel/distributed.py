"""Several processes over one sharded block pool: ``torch.distributed``.

The port of ``la3dm_tpu/parallel/distributed.py``.  Call :func:`initialize`
once in every process (or start the processes with ``torchrun``, whose
environment it reads), then build a sharded map on :func:`global_mesh`.

Scan ingest is replicated: every process parses every scan and builds the
same tables, and every process's host state of the pool (key → slot,
coordinates, loads) is the same, so placement needs no communication.  Rows
cross processes only where the pool is re-laid out (growth, ``rebalance``)
and where the whole map is read (``search``, ``leaves``, ``save``, the
raycast snapshot); :class:`Collectives` holds those collectives.

Backends: ``nccl`` for CUDA devices, one card a process (NCCL refuses two
ranks on one card); ``gloo`` for the CPU, and for several ranks that share
one card, where :class:`Collectives` stages the CUDA tensors through host
memory.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from la3dm_tpu_torch.models.base import resolve_device
from la3dm_tpu_torch.parallel.mesh import ShardMesh

#: how long a collective waits for the other ranks before it fails the run
#: (under the 300 s that the tests and the smoke give a rank's process)
TIMEOUT_S = 120


def _local_device(device) -> torch.device:
    """``device``, or ``cuda:LOCAL_RANK`` (``torchrun``'s variable)."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return resolve_device(device)


def initialize(backend: str | None = None, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               device=None) -> None:
    """``torch.distributed.init_process_group`` with ``torchrun``'s
    environment as the fall-back (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``).  ``backend`` defaults to ``nccl`` for a
    CUDA ``device`` (by default ``cuda:LOCAL_RANK``) and ``gloo`` for the
    CPU; a CUDA device becomes the process's current device.  A collective
    that waits longer than :data:`TIMEOUT_S` for another rank fails."""
    dev = _local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    kwargs = {"timeout": datetime.timedelta(seconds=TIMEOUT_S)}
    if rank is not None:
        kwargs["rank"] = rank
    if world_size is not None:
        kwargs["world_size"] = world_size
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            **kwargs)


def global_mesh(shards_per_rank: int = 1, device=None) -> ShardMesh:
    """The shard mesh over every process of the initialised group:
    ``shards_per_rank`` shards on this process's ``device`` (by default
    ``cuda:LOCAL_RANK``)."""
    if not dist.is_initialized():
        raise RuntimeError("call distributed.initialize() first")
    return ShardMesh(device=_local_device(device), shards_per_rank=int(shards_per_rank),
                     rank=dist.get_rank(), world=dist.get_world_size(),
                     group=dist.group.WORLD)


class Collectives:
    """The collectives of a distributed mesh, in one place: the row
    all-gather, which also gathers the per-slot loads (a row each)."""

    def __init__(self, mesh: ShardMesh):
        self.mesh = mesh
        # gloo takes host tensors: CUDA tensors go through host memory on the
        # way in and out (the kernels still run on the card)
        self.staged = (dist.get_backend(mesh.group) == "gloo"
                       and mesh.device.type == "cuda")

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each) stacked along the
        first axis in rank order, on every rank and on ``t``'s device."""
        x = t.contiguous()
        if x.dtype == torch.bool:
            x = x.view(torch.uint8)
        if self.staged:
            x = x.cpu()
        out = [torch.empty_like(x) for _ in range(self.mesh.world)]
        dist.all_gather(out, x, group=self.mesh.group)
        whole = torch.cat(out).to(t.device)
        return whole.view(torch.bool) if t.dtype == torch.bool else whole
