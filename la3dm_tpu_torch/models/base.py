"""Block pool and shared map machinery, on torch tensors.

The port of ``la3dm_tpu/models/base.py``.  The map is a dense block pool:
``[capacity, n³]`` tensors of posterior state on the map's device plus a
host-side sorted key table for key → slot lookups.  New blocks are
allocated host-side between scans, in first-seen order; slot ids are
stable (growth appends).  Checkpoints use the JAX package's NPZ format, so
a map saved by either package loads in the other.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from la3dm_tpu_torch.geometry import blocks as geo
from la3dm_tpu_torch.utils import profiling
from la3dm_tpu_torch.utils.config import MapConfig


class State(enum.IntEnum):
    """Mirrors the reference State enum (+UNCERTAIN from the LV family)."""

    FREE = 0
    OCCUPIED = 1
    UNKNOWN = 2
    UNCERTAIN = 3


def resolve_device(device) -> torch.device:
    """The map's device: CUDA unless the caller names another.  There is no
    fall-back to the CPU: a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the map on the CPU")
    return dev


class BlockPool:
    """Growable pool of per-block dense voxel tensors.

    ``fields`` maps name → fill value; every field is a float32 [cap, V]
    tensor, plus ``touched`` (bool) and ``eff_level`` (int8).
    """

    #: growth generation.  This pool's growth appends (slot ids are stable),
    #: so it never moves; the sharded pool (parallel/sharded_map.py) bumps it
    #: whenever it re-lays out its slots.  Engines that hold slot ids across
    #: ``ensure`` calls compare generations and re-resolve with ``lookup``.
    generation = 0

    def __init__(self, voxels_per_block: int, fields: dict[str, float],
                 device: torch.device, capacity: int | None = None):
        self.V = voxels_per_block
        self.device = device
        if capacity is None:
            # initial allocation ≤ ~32 MiB per field; growth doubles on demand
            capacity = max(256, min(8192, (1 << 23) // max(voxels_per_block, 1)))
        self.capacity = capacity
        self.n_blocks = 0
        self.coords = np.zeros((capacity, 3), dtype=np.int64)  # host mirror
        self._keys = np.zeros(0, np.int64)      # sorted packed keys
        self._key_slots = np.zeros(0, np.int32)  # slot of each sorted key
        self._fills = dict(fields)
        self.fields = {name: torch.full((capacity, self.V), fill,
                                        dtype=torch.float32, device=device)
                       for name, fill in fields.items()}
        self.touched = torch.zeros((capacity, self.V), dtype=torch.bool, device=device)
        self.eff_level = torch.zeros((capacity, self.V), dtype=torch.int8, device=device)

    def __len__(self) -> int:
        return self.n_blocks

    def _grow(self, min_capacity: int) -> None:
        new_cap = self.capacity
        while new_cap < min_capacity:
            new_cap *= 2
        pad = new_cap - self.capacity
        dev = self.device
        self.coords = np.concatenate([self.coords, np.zeros((pad, 3), np.int64)])
        for name, arr in self.fields.items():
            filler = torch.full((pad, self.V), self._fills[name],
                                dtype=arr.dtype, device=dev)
            self.fields[name] = torch.cat([arr, filler])
        self.touched = torch.cat(
            [self.touched, torch.zeros((pad, self.V), dtype=torch.bool, device=dev)])
        self.eff_level = torch.cat(
            [self.eff_level, torch.zeros((pad, self.V), dtype=torch.int8, device=dev)])
        self.capacity = new_cap

    def _find(self, keys: np.ndarray) -> np.ndarray:
        """Slots of packed keys; −1 where absent (sorted-key join)."""
        out = np.full(len(keys), -1, np.int32)
        if len(self._keys) and len(keys):
            pos = np.minimum(np.searchsorted(self._keys, keys), len(self._keys) - 1)
            hit = self._keys[pos] == keys
            out[hit] = self._key_slots[pos[hit]]
        return out

    @property
    def shard_rows(self) -> int:
        """Rows of the pool tensors one engine call addresses: the whole
        pool here, a shard's slice in the sharded pool."""
        return self.capacity

    def whole_rows(self, arr: torch.Tensor) -> torch.Tensor:
        """The pool tensor ``arr`` as rows addressed by slot: the tensor
        itself (a pool sharded over several processes gathers its rows)."""
        return arr

    @profiling.traced("la3dm.pool.ensure")
    def ensure(self, coords: np.ndarray,
               weights: np.ndarray | None = None) -> np.ndarray:
        """Slots for integer block coords [N,3], allocating missing blocks in
        first-seen order.  ``weights`` [N], the work each block brings, is
        for the sharded pool's placement; this pool ignores it."""
        keys = geo.pack_key(np.asarray(coords))
        slots = self._find(keys)
        miss = np.nonzero(slots < 0)[0]
        if len(miss):
            ukeys, first, inv = np.unique(keys[miss], return_index=True,
                                          return_inverse=True)
            rank = np.empty(len(ukeys), np.int64)
            rank[np.argsort(first, kind="stable")] = np.arange(len(ukeys))
            new_slots = (self.n_blocks + rank).astype(np.int32)   # per ukey
            need = self.n_blocks + len(ukeys)
            if need > self.capacity:
                self._grow(need)
            self.coords[new_slots] = np.asarray(coords)[miss[first]]
            slots[miss] = new_slots[inv.reshape(-1)]
            keys_all = np.concatenate([self._keys, ukeys])
            slots_all = np.concatenate([self._key_slots, new_slots])
            order = np.argsort(keys_all, kind="stable")
            self._keys, self._key_slots = keys_all[order], slots_all[order]
            self.n_blocks = need
        return slots

    def lookup(self, coords: np.ndarray) -> np.ndarray:
        """Slots for coords [N,3]; −1 where the block does not exist."""
        return self._find(geo.pack_key(np.asarray(coords)))

    def active_slots(self) -> np.ndarray:
        return np.arange(self.n_blocks, dtype=np.int32)


class OccupancyMapBase:
    """Shared behavior of the map families."""

    #: pool field names → fill values, set by subclasses (e.g. A, B)
    FIELD_FILLS: dict[str, float] = {}
    #: whether the online server voxel-downsamples a cloud before
    #: ``insert_pointcloud`` (pipeline.OnlineIntegrator)
    SERVER_DOWNSAMPLE = True

    def __init__(self, cfg: MapConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n = cfg.cells_per_edge
        self.V = cfg.voxels_per_block
        self.block_size = cfg.block_size
        self.FIELD_FILLS = self._field_fills()
        self.pool = self._make_pool()
        # voxel-center offset tables per octree level, [L, V, 3]
        self._level_offsets = np.stack(
            [geo.level_offsets(cfg.resolution, cfg.block_depth, L)
             for L in range(cfg.block_depth)]).astype(np.float32)
        self._neighbor_offsets = (
            geo.full_neighbor_offsets() if cfg.predict else geo.FACE_NEIGHBOR_OFFSETS
        )
        self.num_slots = len(self._neighbor_offsets)
        self._state_fn = self._make_state_fn()
        #: counters: kernel_evals = training-entry × node pairs evaluated;
        #: host_s = main-thread host work before each dispatch
        self.stats = {"kernel_evals": 0, "scans": 0, "host_s": 0.0}

    def _make_pool(self) -> BlockPool:
        return BlockPool(self.V, self.FIELD_FILLS, self.device)

    def _make_state_fn(self):
        raise NotImplementedError

    def _field_fills(self) -> dict[str, float]:
        raise NotImplementedError

    def _posterior(self, fields: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def _to_device(self, x) -> torch.Tensor:
        """Host array → tensor on the map's device (a tensor passes as it
        is).  To a GPU the copy goes from pinned memory without blocking the
        host, so building the next chunk's tables overlaps the device work."""
        if torch.is_tensor(x):
            return x
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def synchronize(self) -> None:
        """Wait for the map's queued device work."""
        if self.device.type == "cuda":
            with profiling.span("la3dm.sync.synchronize"):
                torch.cuda.synchronize(self.device)
            profiling.count("host_syncs")

    # -- geometry helpers -------------------------------------------------

    def block_centers(self, coords: np.ndarray) -> np.ndarray:
        return geo.block_center(coords, self.block_size)

    # -- voxel-storage order ----------------------------------------------
    # The pool stores each block's V voxels in the engine's order: raster
    # for BGK, tile-major for BGKLV (models/bgklv.py).  Queries, exports and
    # checkpoints convert through these hooks; the defaults are identity.

    def _stored_vidx(self, vidx: np.ndarray) -> np.ndarray:
        """Raster voxel index → stored column index."""
        return vidx

    def _stored_to_raster(self, rows: np.ndarray) -> np.ndarray:
        """[N, V] stored-order columns → raster order (host numpy)."""
        return rows

    def _raster_to_stored(self, rows: np.ndarray) -> np.ndarray:
        """[N, V] raster-order columns → stored order (host numpy)."""
        return rows

    def _stored_to_raster_dev(self, arr: torch.Tensor) -> torch.Tensor:
        """[N, V] stored-order tensor → raster order, on its device (the
        raycast snapshot reads the state in raster order)."""
        return arr

    # -- queries ----------------------------------------------------------

    def _gather_rows(self, arr: torch.Tensor, slots: np.ndarray) -> np.ndarray:
        """``arr[slots]`` as host numpy, raster voxel order; the gather runs
        on the device and only len(slots)·V elements cross to the host."""
        arr = self.pool.whole_rows(arr)
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=arr.device)
        return self._stored_to_raster(arr[idx].cpu().numpy())

    def search(self, points: np.ndarray) -> dict[str, np.ndarray]:
        """Vectorized ``search(point3f)`` (bgkoctomap.cpp:563-574): per-point
        posterior fields + ``prob``, ``var``, ``state``; points in
        non-existent blocks report the prior and UNKNOWN."""
        points = np.atleast_2d(np.asarray(points, dtype=np.float32))
        coords = geo.point_to_block_coord(points, self.block_size)
        slots = self.pool.lookup(coords)
        exists = slots >= 0
        centers = self.block_centers(coords)
        vidx = geo.point_to_voxel_index(points, centers, self.cfg.resolution, self.n)
        sl = torch.as_tensor(np.where(exists, slots, 0).astype(np.int64),
                             device=self.device)
        vi = torch.as_tensor(self._stored_vidx(vidx).astype(np.int64),
                             device=self.device)
        out = {}
        for name, arr in self.pool.fields.items():
            vals = self.pool.whole_rows(arr)[sl, vi].cpu().numpy()
            out[name] = np.where(exists, vals, np.float32(self.FIELD_FILLS[name]))
        tch = self.pool.whole_rows(self.pool.touched)[sl, vi].cpu().numpy()
        out["touched"] = np.where(exists, tch, False)
        post = self._posterior(out)
        post["touched"] = out["touched"]
        return post

    def get_bbox(self) -> tuple[np.ndarray, np.ndarray]:
        """Map bounding box over existing blocks (bgkoctomap.cpp:368-381)."""
        if self.pool.n_blocks == 0:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        centers = self.block_centers(self.pool.coords[self.pool.active_slots()])
        half = np.float32(self.block_size / 2.0)
        return centers.min(0) - half, centers.max(0) + half

    # -- export (LeafIterator equivalent) ---------------------------------

    def leaves(self, expand_pruned: bool = True) -> dict[str, np.ndarray]:
        """All map leaves as flat arrays (centers, size, posterior, state).

        ``expand_pruned=True`` mirrors ``get_pruned_locs`` (bgkoctomap.h:
        269-287): collapsed leaves are reported as their base-resolution
        voxels.  With False, each collapsed leaf is reported once at its own
        size.
        """
        nb = self.pool.n_blocks
        if nb == 0:
            empty = {k: np.zeros((0,)) for k in ("x", "y", "z", "size", "prob", "var")}
            empty["state"] = np.zeros((0,), np.int8)
            return empty
        slots = self.pool.active_slots()
        eff = self._gather_rows(self.pool.eff_level, slots).astype(np.int64)
        fields = {k: self._gather_rows(v, slots) for k, v in self.pool.fields.items()}
        fields["touched"] = self._gather_rows(self.pool.touched, slots)
        post = self._posterior(fields)

        centers = self.block_centers(self.pool.coords[slots])  # [B,3]
        res = self.cfg.resolution
        level_tab = self._level_offsets                        # [L,V,3]

        if expand_pruned:
            offs = level_tab[0][None]
            mask = np.ones_like(eff, dtype=bool)
            size = np.full(eff.shape, res, dtype=np.float32)
        else:
            # one representative voxel per leaf: the minimum-corner base voxel
            n = self.n
            ix = np.arange(n)
            zz, yy, xx = np.meshgrid(ix, ix, ix, indexing="ij")
            flat = np.stack([xx, yy, zz], -1).reshape(-1, 3)
            m = 1 << eff
            mask = ((flat[None, :, 0] % m == 0) & (flat[None, :, 1] % m == 0)
                    & (flat[None, :, 2] % m == 0))
            offs = np.take_along_axis(level_tab[None], eff[:, None, :, None], axis=1)[:, 0]
            size = (res * m).astype(np.float32)

        pos = centers[:, None, :] + offs
        flat_mask = mask.reshape(-1)
        out = {
            "x": pos[..., 0].reshape(-1)[flat_mask],
            "y": pos[..., 1].reshape(-1)[flat_mask],
            "z": pos[..., 2].reshape(-1)[flat_mask],
            "size": size.reshape(-1)[flat_mask],
        }
        for k, v in post.items():
            out[k] = v.reshape(-1)[flat_mask]
        return out

    # -- checkpoint/resume ------------------------------------------------

    def save(self, path: str) -> None:
        """Serialize the full map state (the JAX package's NPZ format)."""
        np.savez_compressed(path, **self._checkpoint())

    def _checkpoint(self) -> dict[str, np.ndarray]:
        """The arrays :meth:`save` writes."""
        slots = self.pool.active_slots()
        data = {
            "coords": self.pool.coords[slots],
            "touched": self._gather_rows(self.pool.touched, slots),
            "eff_level": self._gather_rows(self.pool.eff_level, slots),
            "config": np.frombuffer(repr(self.cfg).encode(), dtype=np.uint8),
        }
        for k, v in self.pool.fields.items():
            data[f"field_{k}"] = self._gather_rows(v, slots)
        return data

    def load(self, path: str) -> None:
        """Load a checkpoint written by :meth:`save` of either package."""
        with np.load(path) as data:
            self.load_state(data["coords"],
                            {k: data[f"field_{k}"] for k in self.pool.fields},
                            data["touched"], data["eff_level"])

    def load_state(self, coords: np.ndarray, fields: dict[str, np.ndarray],
                   touched: np.ndarray, eff_level: np.ndarray) -> None:
        """Set the pool from host arrays — e.g. a JAX map's pool rows
        (``coords`` [N,3], per-field [N,V] f32, ``touched`` [N,V] bool,
        ``eff_level`` [N,V] int8, raster voxel order).  The map must be
        empty."""
        if self.pool.n_blocks != 0:
            raise ValueError("load into an empty map")
        slots = torch.as_tensor(self.pool.ensure(np.asarray(coords)).astype(np.int64),
                                device=self.device)

        def stored(rows, dtype):
            return torch.tensor(self._raster_to_stored(np.asarray(rows, dtype)),
                                device=self.device)

        for k in self.pool.fields:
            self.pool.fields[k][slots] = stored(fields[k], np.float32)
        self.pool.touched[slots] = stored(touched, bool)
        self.pool.eff_level[slots] = stored(eff_level, np.int8)
