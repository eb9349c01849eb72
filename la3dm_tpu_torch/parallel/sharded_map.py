"""Block-sharded occupancy maps: the pool's slot axis split into shards.

The port of ``la3dm_tpu/parallel/sharded_map.py``.  The pool's ``capacity``
slots are cut into ``n_shards`` equal chunks: slot ``s`` belongs to shard
``s // chunk``, and shard ``d`` to process ``d // shards_per_rank``
(parallel/mesh.py).  A process holds the rows of its shards,
``[shards_per_rank·chunk, V]`` tensors on its device, shard ``d``'s chunk a
contiguous row slice of them.  Placement is the JAX package's, decision for
decision (:class:`ShardedBlockPool`): new blocks go to the shard with the
least accumulated work, growth keeps each block's shard and offset, and
``rebalance`` re-places every block by its measured load.

The engines run each dispatch once per shard, on the shard's row slice: a
shard's dispatch is the whole dispatch restricted to the test blocks it owns,
their slots made local and each scan's start and count recomputed in scan
order; the entry and point tables go to it whole.  So every hand kernel of a
family runs once per shard (K1 or K1′ and K2 a scan for BGK and BGKL, K4 a
size tier and K5 a scan for GP, K3 and K8 for BGKLV), and a shard with no
block in a scan launches nothing for it.  Where the JAX package lets GSPMD
partition one step over the mesh, the port launches the step once per shard;
the glue around the kernels (the relayout gather, the table restriction, the
collectives) is plain PyTorch and ``torch.distributed``, as the JAX package's
is plain XLA.

Every process holds the whole host state (key → slot, coordinates,
``dev_load``) and builds the same tables from the same scans, so placement
needs no communication; rows cross processes only in the relayout and in
reads of the whole map, through :class:`distributed.Collectives`.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from la3dm_tpu_torch.geometry import blocks as geo
from la3dm_tpu_torch.models import base
from la3dm_tpu_torch.models.bgk import BGKOctoMap
from la3dm_tpu_torch.models.bgkl import BGKLOctoMap
from la3dm_tpu_torch.models.bgklv import BGKLVOctoMap
from la3dm_tpu_torch.models.gp import GPOctoMap
from la3dm_tpu_torch.parallel import distributed
from la3dm_tpu_torch.parallel.mesh import ShardMesh, block_mesh
from la3dm_tpu_torch.utils import profiling
from la3dm_tpu_torch.utils.config import MapConfig


class _LPT:
    """The longest-processing-time greedy's shard choice: the least load
    among shards with space, then the fewer resident blocks, then the lowest
    index (``la3dm_tpu/parallel/sharded_map.py:117-121``).  Updates ``load``
    and ``count`` in place."""

    def __init__(self, load: np.ndarray, count: np.ndarray, chunk: int):
        self.load, self.count, self.chunk = load, count, chunk
        self.heap = [(float(load[d]), int(count[d]), d)
                     for d in range(len(load)) if count[d] < chunk]
        heapq.heapify(self.heap)

    def place(self, weight: float) -> int:
        """The slot of one block of ``weight`` on the chosen shard."""
        _, _, d = heapq.heappop(self.heap)
        s = d * self.chunk + int(self.count[d])
        self.count[d] += 1
        self.load[d] += weight
        if self.count[d] < self.chunk:
            heapq.heappush(self.heap, (float(self.load[d]), int(self.count[d]), d))
        return s


class ShardedBlockPool(base.BlockPool):
    """Load-aware shard placement; grows by re-laying out every shard.

    New blocks go to the shard with the least accumulated work
    (``dev_load``), heaviest first: sensor sweeps concentrate work in few
    blocks, so balancing the block count alone leaves skews of several times
    on the LV family.  ``dev_load`` mixes units as the JAX pool's does: each
    ``ensure`` with ``weights`` adds them (BGK and BGKL: a test block's
    training entries; GP: the training points of the G models a test block
    reads; BGKLV: a worked block's hits and rays), for new blocks and for
    repeats alike, and an ``ensure`` without weights adds 1 for each new
    block (device ingest, BGKLV's sweep, ``load``).

    Growth doubles the capacity; slot (d, o) keeps its shard d and offset o
    under the new chunk, so ``generation`` moves and engines re-resolve the
    slot ids they hold.  ``rebalance`` re-places every block by measured
    load.  Both move the rows with one gather (an all-gather where rows
    change process).
    """

    def __init__(self, voxels_per_block: int, fields: dict[str, float], capacity: int,
                 mesh: ShardMesh):
        n = mesh.n_shards
        capacity = -(-int(capacity) // n) * n
        self.mesh = mesh
        self.n_shards = n
        self.chunk = capacity // n
        super().__init__(voxels_per_block, fields, mesh.device,
                         capacity=mesh.shards_per_rank * self.chunk)
        self.capacity = capacity
        self.coords = np.zeros((capacity, 3), np.int64)
        self._coll = distributed.Collectives(mesh) if mesh.distributed else None
        self.generation = 0
        #: per-shard accumulated ensure weight and resident block count
        self.dev_load = np.zeros(n, np.float64)
        self._dev_count = np.zeros(n, np.int64)
        #: the keys in placement order (the JAX pool's dict order)
        self._order: list[int] = []

    @property
    def shard_rows(self) -> int:
        return self.chunk

    def whole_rows(self, arr: torch.Tensor) -> torch.Tensor:
        """The pool tensor ``arr`` [rows of this process, ...] as the whole
        pool's rows: all-gathered where the mesh spans processes."""
        return self._coll.all_gather_rows(arr) if self._coll else arr

    def rows_of(self, d: int) -> slice:
        """Shard ``d``'s rows in this process's pool tensors."""
        lo = (d - self.mesh.rank * self.mesh.shards_per_rank) * self.chunk
        return slice(lo, lo + self.chunk)

    @profiling.traced("la3dm.pool.ensure")
    def ensure(self, coords: np.ndarray, weights: np.ndarray | None = None) -> np.ndarray:
        """Slots for coords [N,3], placing new blocks by the LPT greedy.
        ``weights`` [N] (work units of this call) feed the load of existing
        and new blocks; None counts 1 for each new block."""
        coords = np.asarray(coords)
        keys = geo.pack_key(coords)
        w = None if weights is None else np.asarray(weights, np.float64)
        slots = self._find(keys).astype(np.int64)
        absent = np.flatnonzero(slots < 0)
        missing = absent[np.sort(np.unique(keys[absent], return_index=True)[1])]
        if len(missing):
            if self.n_blocks + len(missing) > self.capacity:
                self._grow(self.n_blocks + len(missing))
            # heaviest first, each on the least-loaded shard with space
            order = missing if w is None else missing[np.argsort(-w[missing], kind="stable")]
            lpt = _LPT(self.dev_load, self._dev_count, self.chunk)
            new_slots = np.array([lpt.place(1.0 if w is None else w[i]) for i in order],
                                 np.int64)
            self.coords[new_slots] = coords[order]
            keys_all = np.concatenate([self._keys, keys[order]])
            slots_all = np.concatenate([self._key_slots, new_slots.astype(np.int32)])
            srt = np.argsort(keys_all, kind="stable")
            self._keys, self._key_slots = keys_all[srt], slots_all[srt]
            self._order.extend(keys[order].tolist())
            self.n_blocks += len(order)
            slots = self._find(keys).astype(np.int64)
        if w is not None:
            # repeat work (existing blocks and a new key's later copies) adds
            # to the owning shard's load, in call order
            repeat = np.ones(len(keys), bool)
            repeat[missing] = False
            np.add.at(self.dev_load, slots[repeat] // self.chunk, w[repeat])
        return slots.astype(np.int32)

    def _grow(self, min_capacity: int) -> None:
        self.generation += 1  # invalidates the slot ids handed out
        new_cap = self.capacity
        while new_cap < min_capacity:
            new_cap *= 2
        new_chunk = new_cap // self.n_shards
        keys = np.asarray(self._order, np.int64)
        old_slots = self._find(keys).astype(np.int64)
        new_slots = (old_slots // self.chunk) * new_chunk + old_slots % self.chunk
        self._relayout(new_slots, old_slots, new_cap)

    def _relayout(self, new_slots: np.ndarray, old_slots: np.ndarray, new_cap: int) -> None:
        """Move every block from its old slot to its new one: one gather of
        each pool tensor's rows (after an all-gather of the old rows where
        the mesh spans processes)."""
        new_chunk = new_cap // self.n_shards
        src = np.full(new_cap, self.capacity, np.int64)   # the fill row
        src[new_slots] = old_slots
        rows = self.mesh.shards_per_rank * new_chunk
        r0 = self.mesh.rank * rows
        take = torch.as_tensor(src[r0:r0 + rows], device=self.device)

        def regather(arr, fill):
            pad = torch.full((1, self.V), fill, dtype=arr.dtype, device=self.device)
            return torch.cat([self.whole_rows(arr), pad])[take]

        for name, arr in self.fields.items():
            self.fields[name] = regather(arr, self._fills[name])
        self.touched = regather(self.touched, False)
        self.eff_level = regather(self.eff_level, 0)
        new_coords = np.zeros((new_cap, 3), np.int64)
        new_coords[new_slots] = self.coords[old_slots]
        new_of_old = np.full(self.capacity, -1, np.int64)
        new_of_old[old_slots] = new_slots
        self._key_slots = new_of_old[self._key_slots].astype(np.int32)
        self.coords = new_coords
        self.capacity = new_cap
        self.chunk = new_chunk

    def rebalance(self, block_load: np.ndarray) -> None:
        """Re-place every block by its measured load ``block_load``
        [capacity] (LPT, heaviest first), then move the rows.  Weight-predicted
        placement is first-touch; this corrects it between scans.  Slot ids
        change (``generation`` moves)."""
        if self.n_blocks == 0:
            return
        self.generation += 1
        keys = np.asarray(self._order, np.int64)
        old_slots = self._find(keys).astype(np.int64)
        loads = np.asarray(block_load, np.float64)[old_slots]
        dev_load = np.zeros(self.n_shards)
        dev_count = np.zeros(self.n_shards, np.int64)
        lpt = _LPT(dev_load, dev_count, self.chunk)
        new_slots = np.empty(len(old_slots), np.int64)
        for j in np.argsort(-loads, kind="stable"):
            new_slots[j] = lpt.place(loads[j])
        self._relayout(new_slots, old_slots, self.capacity)
        self.dev_load = dev_load
        self._dev_count = dev_count

    def active_slots(self) -> np.ndarray:
        """The blocks' slots in placement order."""
        return self._find(np.asarray(self._order, np.int64))


def _scan_segments(own: np.ndarray, scan_start, scan_count) -> tuple[list, list]:
    """Each scan's segment of the blocks ``own`` selects, in scan order;
    scans without one are left out."""
    starts, counts = [], []
    off = 0
    for s, c in zip(scan_start, scan_count):
        k = int(own[s:s + c].sum())
        if k:
            starts.append(off)
            counts.append(k)
        off += k
    return starts, counts


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


class _ShardedMixin:
    """A map family over a :class:`ShardedBlockPool` (module docstring).
    ``mesh`` defaults to one shard on ``device`` (CUDA unless named)."""

    #: device ingest hands the engine host slots (``models/ingest.py``):
    #: :meth:`_shards` cuts each dispatch on the host
    SLOTS_ON_HOST = True

    @profiling.traced("la3dm.map.build")
    def __init__(self, cfg: MapConfig, mesh: ShardMesh | None = None,
                 capacity: int = 8192, device=None):
        if mesh is None:
            mesh = block_mesh(1, device)
        elif device is not None and not _same_device(base.resolve_device(device),
                                                     mesh.device):
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        self.mesh = mesh
        self._capacity = capacity
        super().__init__(cfg, device=mesh.device)

    def _make_pool(self):
        return ShardedBlockPool(self.V, self.FIELD_FILLS, self._capacity, self.mesh)

    def _shards(self, slots: np.ndarray):
        """For each of this process's shards that owns one of the blocks
        ``slots``: (the shard, its pool rows, the mask of its blocks, their
        slots in those rows)."""
        slots = np.asarray(slots, np.int64)
        chunk = self.pool.chunk
        shard = slots // chunk
        for d in self.mesh.local_shards():
            own = shard == d
            if own.any():
                yield d, self.pool.rows_of(d), own, (slots[own] - d * chunk).astype(np.int32)

    def rebalance(self) -> None:
        """Re-place blocks across shards by their measured touched-voxel
        load (gathered across processes), between scans."""
        load = self.pool.touched.sum(dim=1, dtype=torch.float64)
        self.pool.rebalance(self.pool.whole_rows(load).cpu().numpy())

    def save(self, path: str) -> None:
        """As the base class's; every process takes part in the reads, and
        process 0 writes the file."""
        data = self._checkpoint()
        if self.mesh.rank == 0:
            np.savez_compressed(path, **data)

    def load_state(self, coords, fields, touched, eff_level) -> None:
        """As the base class's; each process writes the rows of its shards."""
        if self.pool.n_blocks != 0:
            raise ValueError("load into an empty map")
        slots = self.pool.ensure(np.asarray(coords)).astype(np.int64)
        rows = self.mesh.shards_per_rank * self.pool.chunk
        local = slots - self.mesh.rank * rows
        mine = (local >= 0) & (local < rows)
        idx = torch.as_tensor(local[mine], device=self.device)

        def stored(vals, dtype):
            return torch.tensor(self._raster_to_stored(np.asarray(vals, dtype)[mine]),
                                device=self.device)

        for k in self.pool.fields:
            self.pool.fields[k][idx] = stored(fields[k], np.float32)
        self.pool.touched[idx] = stored(touched, bool)
        self.pool.eff_level[idx] = stored(eff_level, np.int8)


class _ShardedBGKMixin(_ShardedMixin):
    """BGK and BGKL: K1 or K1′, then K2 a scan, once per shard."""

    @profiling.traced("la3dm.heavy.launch")
    def _host_step(self, cat, scan_start, scan_count, rows=slice(None)):
        # the entry tables go to every shard whole, copied once
        whole = {k: self._to_device(cat[k]) for k in ("ent", "lab", "ids", "gs")}
        for _, rows, own, local in self._shards(cat["slots"]):
            remap = np.cumsum(own) - 1
            keep = own[cat["rb"]]
            sub = dict(whole, rb=remap[cat["rb"][keep]].astype(np.int32),
                       rs=cat["rs"][keep], rn=cat["rn"][keep], slots=local,
                       ctr=cat["ctr"][own])
            super()._host_step(sub, *_scan_segments(own, scan_start, scan_count),
                               rows=rows)

    @profiling.traced("la3dm.heavy.launch")
    def _ingest_step(self, tabs, slots, scan_start, scan_count, rows=slice(None)):
        for _, rows, own, local in self._shards(slots):
            sel = self._to_device(np.flatnonzero(own))
            super()._ingest_step(dict(tabs, tb_u=tabs["tb_u"][sel]), local,
                                 *_scan_segments(own, scan_start, scan_count), rows=rows)


class ShardedBGKOctoMap(_ShardedBGKMixin, BGKOctoMap):
    """BGK map with the block pool split into shards."""


class ShardedBGKLOctoMap(_ShardedBGKMixin, BGKLOctoMap):
    """BGKL map with the block pool split into shards."""


class ShardedGPOctoMap(_ShardedMixin, GPOctoMap):
    """GP map: a shard's dispatch holds the models that serve at least one
    of its test blocks, their other shards' blocks dropped.  A model that
    serves several shards is factorised on each, and its failure counted on
    the lowest of them (``failed_models`` of a process counts the models
    whose lowest shard it owns)."""

    @profiling.traced("la3dm.heavy.launch")
    def _gp_step(self, pts, lab, starts, counts, nb, host_counts, slots, centers,
                 scan_start, scan_count, rows=slice(None), counted=None):
        slots = np.asarray(slots, np.int64)
        T = len(slots)
        nb_h = (self._fetch_small(nb)[0] if torch.is_tensor(nb) else np.asarray(nb))
        nb_h = np.minimum(nb_h.astype(np.int64), T)          # T: serves no block
        served = np.append(slots // self.pool.chunk, self.pool.n_shards)[nb_h]  # [M, G]
        home = served.min(axis=1)
        for d, rows, own, local in self._shards(slots):
            sel = np.flatnonzero((served == d).any(axis=1))
            k = int(own.sum())
            remap = np.full(T + 1, k, np.int64)              # k: none in the shard
            remap[np.flatnonzero(own)] = np.arange(k)
            nb_sub = remap[nb_h[sel]]
            if torch.is_tensor(starts):
                seld = self._to_device(sel)
                st, ct, nbs = starts[seld], counts[seld], self._to_device(nb_sub)
            else:
                st, ct, nbs = starts[sel], counts[sel], nb_sub
            ctr = (centers[self._to_device(np.flatnonzero(own))] if torch.is_tensor(centers)
                   else np.asarray(centers)[own])
            super()._gp_step(pts, lab, st, ct, nbs, host_counts[sel], local, ctr,
                             *_scan_segments(own, scan_start, scan_count), rows=rows,
                             counted=home[sel] == d)


class ShardedBGKLVOctoMap(_ShardedMixin, BGKLVOctoMap):
    """LV map: a shard's dispatch holds the (scan, tile) rows of its blocks;
    K3, then (with original_size) K8 over its blocks.  The int32 flat
    addressing bounds a shard's rows, not the whole pool's."""

    def _lv_step(self, entries, labels, ids, tiles, rows=slice(None)):
        for _, rows, own, local in self._shards(tiles["slots"]):
            sub = {k: v[own] for k, v in tiles.items()}
            sub["slots"] = local
            super()._lv_step(entries, labels, ids, sub, rows=rows)
