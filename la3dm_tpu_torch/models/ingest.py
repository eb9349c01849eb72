"""Device-side scan ingest for the map families (BGK, BGKL and GP).

The port of ``la3dm_tpu/models/ingest.py``: :class:`DeviceIngestMixin`
drives :mod:`la3dm_tpu_torch.geometry.device_ingest` over a scan sequence,
≤ SCAN_BATCH scans a dispatch: the host concatenates the raw clouds and
copies them to the device, the device builds the block tables (K7) and
resolves the test blocks' pool slots, and the family's
``_dispatch_ingest_chunk`` hands the device tables, slots and (GP) centres
to its engine.

Slot resolution (``_resolve_slots``): the dispatch's T test-block keys are
scan-local, so a block seen by 16 scans comes 16 times.  On the device K7w
(``kernels/ingest_slots.py``) turns them into world keys in
``geometry/blocks.py::pack_key``'s order and counts each scan's test
blocks, and one K7s sort gives the D distinct blocks (about a tenth of T)
and each test block's run.  What crosses to the host is one copy: the
sort's status, its run-key row (allocated for T keys; the host reads its
first D, the distinct blocks), the K per-scan counts and the entry blocks'
``ucount``.  The host runs ``BlockPool.ensure`` on the D blocks (the order
``np.unique`` gave, so slots are allocated as before), uploads their D
slots, and K7w's gather writes each test block's slot (and GP's centre) on
the device.  A sharded map, which cuts each dispatch per shard on the host,
takes the sort index and the runs in the same copy and builds its T slots
there (``SLOTS_ON_HOST``).  A dispatch whose block anchors spread past the
widest world window, or whose sort flags a key, is resolved on the host as
the JAX mixin does (every test-block key copied back, ``np.unique``,
``ensure``, centres), counted in ``slot_dispatches_host``.

Differences from the JAX mixin: every table takes its exact size, so there
is no pad ladder, no overflow retry and no host fall-back for a chunk's
size; the slots are resolved on the device; ``device_ingest: auto`` means on
for a map on a CUDA device and off for a CPU map (the JAX rule, "on the
accelerator", with the card as the accelerator).  Configs the bounds of
``device_ingest.beam_slots`` reject take the host path, counted in
``stats["ingest_host_chunks"]``.

Host syncs per dispatch: the four of ``device_ingest.ingest_batch`` (or of
``ingest_batch_bgkl`` for a family with ``SEGMENTS``) and the one copy of
the slot resolution (every host→device copy is pinned and does not wait;
the neighbour offsets' mirror slots, which K7t reads, are worked out here on
the host).  The next dispatch's host work (concatenation, pinned copies)
overlaps the current dispatch's engine launches, which the host does not
wait for.

Each wait is a span and counts one ``host_syncs`` (``utils/profiling.py``):
``la3dm.sync.sort_runs``, the status read of each K7s sort
(``kernels/ingest_sort.py``: the point family's four, BGKL's three);
``la3dm.sync.ray_pairs``, the size of BGKL's ray-block pair list
(``kernels/ingest_rays.py``); ``la3dm.sync.fetch_small``, the slot
resolution's copy here; and ``la3dm.sync.synchronize``, the map's
``OccupancyMapBase.synchronize``.  So a dispatch counts five, and a pass of
n dispatches ending in ``synchronize`` 5·n + 1.  The host work between them
is ``la3dm.ingest.prepare`` (concatenation, anchors, pinned copies),
``la3dm.ingest.tables`` (K7's host side) and ``la3dm.ingest.slots`` (twice:
K7w's and the sort's launches before the copy; after it the D keys'
unpack, ``BlockPool.ensure``, the slots' upload and the gather's launch).
Counters: ``slot_dispatches_card`` (dispatches resolved on the device),
``slot_blocks`` (the distinct blocks they fetched), ``slot_tests`` (the
test blocks those stand for) and ``slot_dispatches_host``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from la3dm_tpu_torch.geometry import blocks as geo, device_ingest
from la3dm_tpu_torch.kernels import ingest_bucket, ingest_keys, ingest_slots, ingest_sort
from la3dm_tpu_torch.utils import profiling


class DeviceIngestMixin:
    """Chunked scan-sequence ingest on the map's device (module docstring)."""

    #: max scans per dispatch (set by the family)
    SCAN_BATCH = 16
    #: label of free-space entries (0 for BGK, −1 for GP, gpoctomap.cpp:399)
    FREE_LABEL = 0.0
    #: segment entries (BGKL): the ray pipeline ``ingest_batch_bgkl``
    SEGMENTS = False
    #: the engine reads the test blocks' centres (GP)
    TEST_CENTERS = False
    #: the engine takes the test blocks' slots as a host array (the sharded
    #: maps cut a dispatch per shard on the host)
    SLOTS_ON_HOST = False

    def _ingest_enabled(self) -> bool:
        if getattr(self, "_capture_step_args", False):
            return False  # the capture keeps the host path's engine call
        mode = self.cfg.device_ingest
        if mode in ("on", "off"):
            return mode == "on"
        return self.device.type == "cuda"

    def _insert_device(self, clouds, origins, ds_resolution, free_resolution,
                       max_range) -> bool:
        """Integrate the sequence through device ingest; False (nothing
        integrated) where it is off or the config is unbounded."""
        if not self._ingest_enabled():
            return False
        cfg = self.cfg
        ds = cfg.ds_resolution if ds_resolution is None else ds_resolution
        fr = cfg.free_resolution if free_resolution is None else free_resolution
        mr = cfg.max_range if max_range is None else max_range
        kf = device_ingest.beam_slots(ds, fr, mr, self.block_size)
        K = self.SCAN_BATCH
        if kf is None:
            self.stats["ingest_host_chunks"] += -(-len(clouds) // K)
            return False
        for i in range(0, len(clouds), K):
            self._ingest_chunk(clouds[i:i + K], origins[i:i + K], ds, fr, mr, kf)
        return True

    def _ingest_chunk(self, clouds, origins, ds, fr, mr, kf: int) -> None:
        t0 = time.perf_counter()
        n = len(clouds)
        with profiling.span("la3dm.ingest.prepare"):
            origins = np.stack([np.asarray(o, np.float32).reshape(3) for o in origins])
            pts = np.concatenate([np.asarray(c, np.float32).reshape(-1, 3) for c in clouds])
            scan = np.repeat(np.arange(n, dtype=np.int32), [len(c) for c in clouds])
            banchor = device_ingest.anchors(origins, self.block_size)
            dev = self._to_device
            off = ingest_keys.pack_offsets(self._neighbor_offsets)
            args = (dev(pts), dev(scan), dev(origins), dev(device_ingest.anchors(origins, ds)),
                    dev(banchor), dev(off))
            mirror = dev(ingest_bucket.mirror_slots(off))
        self.stats["host_s"] += time.perf_counter() - t0

        with profiling.span("la3dm.ingest.tables"):
            if self.SEGMENTS:
                tabs = device_ingest.ingest_batch_bgkl(*args, ds=ds, fr=fr, mr=mr, kf=kf,
                                                       block_size=self.block_size,
                                                       mirror=mirror)
            else:
                tabs = device_ingest.ingest_batch(
                    *args, ds=ds, fr=fr, mr=mr, kf=kf, block_size=self.block_size,
                    free_label=self.FREE_LABEL, mirror=mirror)
        self.stats["scans"] += n
        profiling.count("scans", n)
        profiling.count("dispatches")
        if tabs is None:
            return
        radius = ingest_sort.block_window(mr, ds, self.block_size, n).wider(1).radius
        slots, centers, scan_count, ucount = self._resolve_slots(tabs, banchor, args[4], radius)
        scan_start = np.concatenate([[0], np.cumsum(scan_count)[:-1]])
        self._dispatch_ingest_chunk(tabs, ucount, slots, centers, scan_start.tolist(),
                                    scan_count.tolist())

    def _resolve_slots(self, tabs: dict, banchor: np.ndarray, banchor_dev: torch.Tensor,
                       radius: int) -> tuple:
        """The test blocks' pool slots [T] int32 and, where ``TEST_CENTERS``,
        centres [T,3] f32 (device tensors; the slots a host array where
        ``SLOTS_ON_HOST``), each scan's count of test blocks [K] and
        ``ucount`` (host): K7w's world keys, one K7s sort of them, one copy
        back of the sort's run keys (the first D read), the per-scan counts
        and ``ucount``, ``ensure`` of the D blocks, one upload of their slots
        and K7w's gather.  ``radius``: the candidate test blocks' window;
        where the world window cannot hold the dispatch, or the sort flags a
        key, :meth:`_host_slots` resolves it instead."""
        tkey = tabs["tkey"]
        T = tkey.shape[0]
        t0 = time.perf_counter()
        with profiling.span("la3dm.ingest.slots"):
            world = ingest_slots.world_window(radius, banchor)
            if world is not None:
                window, base = world
                wkey, scount = ingest_slots.world_keys(tkey, banchor_dev, base, len(banchor))
                perm, ukey, rid, status = ingest_slots.sort_world(wkey, window)
        self.stats["host_s"] += time.perf_counter() - t0
        if world is None:
            return self._host_slots(tabs, banchor)
        order = (perm[:T], rid[:T]) if self.SLOTS_ON_HOST else ()
        status, ukey_h, scount, ucount, *order_h = self._fetch_small(
            status, ukey, scount, tabs["ucount"], *order)
        V, D, flag, _ = status.tolist()
        if flag or V != T:
            return self._host_slots(tabs, banchor, ucount)

        t0 = time.perf_counter()
        with profiling.span("la3dm.ingest.slots"):
            uslots = self.pool.ensure(ingest_slots.unpack_world_np(ukey_h[:D], base))
            slots = centers = None
            if not order_h or self.TEST_CENTERS:
                slots, centers = ingest_slots.gather(
                    perm[:T], rid[:T], self._to_device(uslots), ukey, base,
                    block_size=self.block_size if self.TEST_CENTERS else None)
            if order_h:  # the slots on the host, from the same copy
                perm_h, rid_h = order_h
                slots = np.empty(T, np.int32)
                slots[perm_h] = uslots[rid_h]
        self.stats["host_s"] += time.perf_counter() - t0
        profiling.count("slot_dispatches_card")
        profiling.count("slot_blocks", D)
        profiling.count("slot_tests", T)
        return slots, centers, scount.astype(np.int64), ucount

    def _host_slots(self, tabs: dict, banchor: np.ndarray, ucount=None) -> tuple:
        """:meth:`_resolve_slots` on the host, a test block at a time (the
        copy of every test-block key, ``np.unique``, ``ensure``, centres),
        counted in ``slot_dispatches_host``; ``ucount`` where it was copied
        already."""
        if ucount is None:
            tkey, ucount = self._fetch_small(tabs["tkey"], tabs["ucount"])
        else:
            (tkey,) = self._fetch_small(tabs["tkey"])
        t0 = time.perf_counter()
        with profiling.span("la3dm.ingest.slots"):
            tscan, coords = ingest_keys.unpack_np(tkey, banchor)
            uniq, inv = np.unique(geo.pack_key(coords), return_inverse=True)
            slots = self.pool.ensure(geo.unpack_key(uniq))[inv.reshape(-1)].astype(np.int32)
            centers = geo.block_center(coords, self.block_size) if self.TEST_CENTERS else None
            scan_count = np.bincount(tscan, minlength=len(banchor))
        self.stats["host_s"] += time.perf_counter() - t0
        profiling.count("slot_dispatches_host")
        return slots, centers, scan_count, ucount

    def _fetch_small(self, *tensors) -> list:
        """Host copies of small device tensors, through pinned memory and one
        wait on the stream."""
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        with profiling.span("la3dm.sync.fetch_small"):
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(host, tensors):
                h.copy_(t, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        profiling.count("host_syncs")
        return [h.numpy() for h in host]

    def _dispatch_ingest_chunk(self, tabs: dict, ucount: np.ndarray, slots,
                               centers, scan_start: list, scan_count: list) -> None:
        """Feed the device tables to the family's engine (hook): ``slots``
        [T] and ``centers`` [T,3] (None unless ``TEST_CENTERS``) are device
        tensors, or host arrays where :meth:`_host_slots` resolved them (the
        slots also where ``SLOTS_ON_HOST``)."""
        raise NotImplementedError
