"""The shard layout of a block pool: which shards a process owns, on which
device.

The port of ``la3dm_tpu/parallel/mesh.py``.  The JAX package is single
controller: one process drives a 1-D ``Mesh`` of devices and GSPMD splits
every engine step over the pool's slot axis.  The port takes PyTorch's
idiom instead: each process drives one device, the shards a process owns are
contiguous row ranges of that device's pool, and several processes form a
``torch.distributed`` group (parallel/distributed.py).  One process may hold
several shards on its device, which stands in for the JAX package's virtual
devices on a machine with one card (and in the CPU tests).

One card a process: the ctypes-bound kernels launch on the CUDA runtime's
current device and some keep per-process state (``csrc/ingest_sort.cu``),
so a process never drives two cards.

The JAX helpers ``pool_sharding``, ``batch_sharding`` and ``replicated``
(``NamedSharding`` specs for GSPMD) have no counterpart: a shard's rows are a
slice of its process's tensors, the engine runs once per shard on that
slice, and the host tables every process builds are the same.
"""

from __future__ import annotations

import dataclasses

import torch

from la3dm_tpu_torch.models.base import resolve_device


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``shards_per_rank`` shards on each of ``world`` processes; this
    process is ``rank`` and holds its shards on ``device``.  ``group`` is the
    process group of a distributed mesh (its collectives carry the rows that
    change process), None for one process on its own."""

    device: torch.device
    shards_per_rank: int = 1
    rank: int = 0
    world: int = 1
    group: object = None

    def __post_init__(self):
        if self.shards_per_rank < 1 or self.world < 1 or not 0 <= self.rank < self.world:
            raise ValueError(f"bad shard mesh: {self.shards_per_rank} shards a rank, "
                             f"rank {self.rank} of {self.world}")

    @property
    def n_shards(self) -> int:
        return self.world * self.shards_per_rank

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans a process group (whose collectives then
        move rows, even for a group of one)."""
        return self.group is not None

    def local_shards(self) -> range:
        """The shards this process owns, in order."""
        return range(self.rank * self.shards_per_rank,
                     (self.rank + 1) * self.shards_per_rank)


def block_mesh(n_shards: int = 1, device=None) -> ShardMesh:
    """One process, ``n_shards`` shards on one device: CUDA unless the
    caller names another (no fall-back to the CPU)."""
    return ShardMesh(device=resolve_device(device), shards_per_rank=int(n_shards))
