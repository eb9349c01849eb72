"""la3dm_tpu_torch — Bayesian continuous-occupancy mapping on PyTorch and
hand-written CUDA kernels for Hopper (H100, sm_90a).

The port of ``la3dm_tpu`` (JAX), which stays beside it as the reference.
This package imports neither JAX nor ``la3dm_tpu``: it keeps its own copies
of the framework-free modules it needs.  Ported so far: the BGK family on
the host-ingest path (``BGKOctoMap``, ``pipeline.run_static``), with the
heavy pass (K1) and the light pass with the prune (K2) as CUDA kernels, and
the BGKLV family (``BGKLVOctoMap``), with the tile row engine (K3) and the
tile-major prune (K8) as CUDA kernels, and the GP family (``GPOctoMap``),
with the GP heavy pass (K4) and the BCM light pass with the prune (K5) as
CUDA kernels, and the BGKL family (``BGKLOctoMap``), BGK's engine on
free-ray segments through the segment branches of K1 and K1′.  BGK, BGKL and
GP maps on a CUDA device ingest their scans on the card (``device_ingest:
auto``): the ingest pipeline (K7a/b/c, and BGKL's per-ray block dedup K7d)
and, for BGK and BGKL, the aligned heavy pass (K1′) are CUDA kernels too.
Raycast (``models/raycast.py``: the host stepper ``raycast`` and the device
DDA ``raycast_device`` / ``raycast_snapshot``, K6) runs over any map.  The
sharded maps (``parallel/``: ``sharded_map.Sharded*OctoMap`` on a
``mesh.block_mesh`` or a ``torch.distributed`` group's
``distributed.global_mesh``) split the pool into shards and run each
family's kernels once per shard.

Maps run on the GPU unless the caller passes ``device="cpu"``; there is no
silent fall-back to the CPU.  The command line is ``python -m
la3dm_tpu_torch.cli`` (the JAX CLI's seven commands, plus ``--device``).
"""

__version__ = "0.1.0"

from la3dm_tpu_torch.utils.config import (DatasetConfig, MapConfig,
                                          load_dataset_config, load_method_config)
from la3dm_tpu_torch.models.base import State
from la3dm_tpu_torch.models.bgk import BGKOctoMap
from la3dm_tpu_torch.models.bgkl import BGKLOctoMap
from la3dm_tpu_torch.models.bgklv import BGKLVOctoMap
from la3dm_tpu_torch.models.gp import GPOctoMap

__all__ = [
    "BGKOctoMap",
    "BGKLOctoMap",
    "BGKLVOctoMap",
    "GPOctoMap",
    "State",
    "MapConfig",
    "DatasetConfig",
    "load_method_config",
    "load_dataset_config",
]
