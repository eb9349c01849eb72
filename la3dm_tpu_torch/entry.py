"""Entry points: the production BGK step with a real insert's arguments,
and the sharded dry run.

The port of ``__graft_entry__.py``.  ``entry()`` returns the BGK sequence
step (``models/bgk.py::_bgk_seq_step`` — the heavy pass K1, then the gated
Beta update and prune K2 a scan) with the argument tuple that a real
``insert_pointcloud`` of ``device_ingest: "off"`` passes, captured from the
insert of a tiny seeded scan.  ``dryrun_multichip(n)`` runs real inserts of
every family on a pool of ``n`` shards (parallel/).
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.models import bgk as B
from la3dm_tpu_torch.utils.config import load_method_config


def tiny_scan(n=60, seed=0):
    """``n`` seeded points in the 2.4 m cube round the origin, seen from the
    origin (``__graft_entry__.py::_tiny_scan``)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    return pts, np.zeros(3, np.float32)


def entry(device=None):
    """(step, example_args) of the production BGK step on ``device`` (CUDA
    unless named).  ``step(*args)`` runs K1 and K2 on copies of the pool
    tensors it is given and returns them updated, ``(A, B, touched, eff)``:
    on ``args`` that is the pool the captured insert produced."""
    # device_ingest=off: the capture hook snapshots the host-built argument
    # tuple of the engine step (the device-ingest path feeds K1′ instead)
    m = B.BGKOctoMap(load_method_config("bgk", max_range=8.0, device_ingest="off"),
                     device=device)
    m._capture_step_args = True
    cloud, origin = tiny_scan(400)
    m.insert_pointcloud(cloud, origin)
    args, statics = m._last_step_call

    def step(*arrays):
        """The production BGK sequence step with this insert's statics."""
        pool = tuple(a.clone() for a in arrays[:4])
        B._bgk_seq_step(*pool, *arrays[4:], **statics)
        return pool

    return step, args


def dryrun_multichip(n_shards: int, device=None) -> dict:
    """One tiny insert of each family on a mesh of ``n_shards`` shards on
    ``device`` (CUDA unless named), a short sweep from three more origins,
    then ``rebalance()``; checks that the map holds blocks and a finite
    field, and prints each class's placement skew (the touched voxels of
    each shard, max over mean).  Returns {class name: the shards' touched
    voxels}."""
    from la3dm_tpu_torch.parallel import mesh as pm, sharded_map as sm

    mesh = pm.block_mesh(n_shards, device)
    cloud, origin = tiny_scan(80, seed=1)
    out = {}
    for cls, method in ((sm.ShardedBGKOctoMap, "bgk"), (sm.ShardedBGKLOctoMap, "bgkl"),
                        (sm.ShardedBGKLVOctoMap, "bgklv"), (sm.ShardedGPOctoMap, "gp")):
        name = cls.__name__
        m = cls(load_method_config(method, max_range=8.0), mesh=mesh,
                capacity=max(n_shards * 64, 512))
        m.insert_pointcloud(cloud, origin)
        total = float(next(iter(m.pool.fields.values())).sum())
        if not np.isfinite(total) or m.pool.n_blocks == 0:
            raise RuntimeError(f"{name}: field sum {total}, {m.pool.n_blocks} blocks")
        # single-scan balance is bound by granularity (one scan's work can
        # sit in one block): the skew is read after a short sweep
        for s in range(2, 5):
            c2, o2 = tiny_scan(80, seed=s)
            off = np.float32(2.5) * np.array([s - 2.5, (s % 2) - 0.5, 0.0], np.float32)
            m.insert_pointcloud(c2 + off, o2 + off)
        m.rebalance()
        load = m.pool.touched.reshape(n_shards, -1).sum(dim=1, dtype=torch.float64)
        load = load.cpu().numpy()
        print(f"placement skew {name}: max/mean = {load.max() / max(load.mean(), 1e-9):.2f} "
              f"(per-shard touched voxels {load.astype(int).tolist()})")
        out[name] = load.astype(int).tolist()
    return out
