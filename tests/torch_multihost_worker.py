"""Worker of the two-process test of the port's sharded maps
(tests/test_torch_multihost.py).

Each process holds 2 shards of a 4-shard pool on the CPU and joins a
``gloo`` group.  Scan ingest is replicated: every process inserts the same
scans, and the rows that change process on growth and ``rebalance`` move
through the group's all-gather.  For each case the map starts from
``capacity=16`` (so the pool grows inside the batched insert), takes two
scans in one batched insert, rebalances, takes a third scan, and then:
``save`` (process 0 writes ``<case>_map.npz``), ``search`` and ``leaves``
(process 0 writes ``<case>_reads.npz``), and a fresh sharded map ``load``s
the checkpoint and saves it again (``<case>_reload.npz``).  Imports no JAX.

Usage: python torch_multihost_worker.py <init_method> <world> <rank> <out_dir>
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from la3dm_tpu_torch.parallel import distributed, sharded_map as sm  # noqa: E402
from la3dm_tpu_torch.utils.config import MapConfig  # noqa: E402

BGK_CFG = MapConfig(method="bgk", resolution=0.1, block_depth=3, sf2=1.0,
                    ell=0.2, free_resolution=0.5, ds_resolution=0.1,
                    free_thresh=0.3, occupied_thresh=0.7, var_thresh=100.0,
                    prior_A=0.001, prior_B=0.001, max_range=8.0)
BGKL_CFG = MapConfig(method="bgkl", resolution=0.1, block_depth=3, sf2=0.1,
                     ell=0.2, free_resolution=0.3, ds_resolution=0.1,
                     free_thresh=0.3, occupied_thresh=0.7, var_thresh=0.15,
                     prior_A=0.001, prior_B=0.001, max_range=8.0)
LV_CFG = MapConfig(method="bgklv", resolution=0.1, block_depth=3, sf2=0.1,
                   ell=0.2, free_resolution=0.1, ds_resolution=0.1,
                   free_thresh=0.3, occupied_thresh=0.7, var_thresh=0.2,
                   prior_A=0.001, prior_B=0.001, min_W=0.001, max_range=8.0)
GP_CFG = MapConfig(method="gp", resolution=0.1, block_depth=3, sf2=1.0,
                   ell=1.0, free_resolution=0.5, ds_resolution=0.1,
                   free_thresh=0.3, occupied_thresh=0.7, noise=0.01, l=100.0,
                   min_var=0.001, max_var=1000.0, max_known_var=0.02,
                   max_range=8.0)

#: case → (sharded class, config): the four families on the host path, and
#: BGK, BGKL and GP on device ingest
CASES = {
    "bgk": (sm.ShardedBGKOctoMap, BGK_CFG),
    "bgkl": (sm.ShardedBGKLOctoMap, BGKL_CFG),
    "bgklv": (sm.ShardedBGKLVOctoMap, LV_CFG),
    "gp": (sm.ShardedGPOctoMap, GP_CFG),
    "bgk_ingest": (sm.ShardedBGKOctoMap, dataclasses.replace(BGK_CFG, device_ingest="on")),
    "bgkl_ingest": (sm.ShardedBGKLOctoMap, dataclasses.replace(BGKL_CFG,
                                                               device_ingest="on")),
    "gp_ingest": (sm.ShardedGPOctoMap, dataclasses.replace(GP_CFG, device_ingest="on")),
}
SHARDS_PER_RANK = 2


def scan_stream():
    """Deterministic 3-scan stream (the same in every process): walls of 80
    hits seen from origins 0.3 m apart."""
    rng = np.random.default_rng(123)
    out = []
    for i in range(3):
        n = 80
        y = rng.uniform(-1.5, 1.5, n)
        z = rng.uniform(0.0, 1.5, n)
        x = 2.0 + 0.05 * rng.standard_normal(n)
        cloud = np.stack([x, y, z], -1).astype(np.float32)
        out.append((cloud, np.array([0.1, -0.2 + 0.3 * i, 0.3], np.float32)))
    return out


def search_points():
    """Query points: on the first wall, beside it, and one far outside."""
    cloud = scan_stream()[0][0]
    return np.concatenate([cloud[:40], cloud[:20] - 0.3,
                           np.array([[40.0, 40.0, 40.0]], np.float32)])


def insert(m) -> None:
    """The worker's insert pattern, on a sharded or an unsharded map."""
    scans = scan_stream()
    m.insert_pointclouds([c for c, _ in scans[:2]], [o for _, o in scans[:2]])
    if hasattr(m, "rebalance"):
        m.rebalance()
    m.insert_pointcloud(*scans[2])


def main():
    init, world, rank, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    distributed.initialize(backend="gloo", init_method=init, rank=rank, world_size=world,
                           device="cpu")
    mesh = distributed.global_mesh(shards_per_rank=SHARDS_PER_RANK, device="cpu")
    assert mesh.n_shards == world * SHARDS_PER_RANK and mesh.distributed
    for name, (cls, cfg) in CASES.items():
        m = cls(cfg, mesh=mesh, capacity=16)
        insert(m)
        assert m.pool.capacity > 16 and m.pool.generation >= 2
        assert m.pool.fields[next(iter(m.pool.fields))].shape[0] == \
            SHARDS_PER_RANK * m.pool.chunk
        path = os.path.join(out_dir, f"{name}_map.npz")
        m.save(path)
        found = m.search(search_points())
        leaves = m.leaves()
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{name}_reads.npz"),
                     **{f"search_{k}": v for k, v in found.items()},
                     **{f"leaves_{k}": v for k, v in leaves.items()})
        torch.distributed.barrier()          # the checkpoint is written
        back = cls(cfg, mesh=mesh, capacity=16)
        back.load(path)
        back.save(os.path.join(out_dir, f"{name}_reload.npz"))
    torch.distributed.barrier()
    if rank == 0:
        print("SAVED", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
