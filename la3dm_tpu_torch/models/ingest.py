"""Device-side scan ingest for the map families (BGK, BGKL and GP).

The port of ``la3dm_tpu/models/ingest.py``: :class:`DeviceIngestMixin`
drives :mod:`la3dm_tpu_torch.geometry.device_ingest` over a scan sequence,
≤ SCAN_BATCH scans a dispatch: the host concatenates the raw clouds and
copies them to the device, the device builds the block tables (K7), the host
copies back only the test-block keys and the entry-block counts to allocate
pool slots (``BlockPool.ensure``), and the family's
``_dispatch_ingest_chunk`` hands the device tables to its engine.

Differences from the JAX mixin: every table takes its exact size, so there
is no pad ladder, no overflow retry and no host fall-back for a chunk's
size; ``device_ingest: auto`` means on for a map on a CUDA device and off
for a CPU map (the JAX rule, "on the accelerator", with the card as the
accelerator).  Configs the bounds of ``device_ingest.beam_slots`` reject take
the host path, counted in ``stats["ingest_host_chunks"]``.

Host syncs per dispatch: the four of ``device_ingest.ingest_batch`` (or of
``ingest_batch_bgkl`` for a family with ``SEGMENTS``) and one for the key
and count copy (every host→device copy is pinned and does not wait; the
neighbour offsets' mirror slots, which K7t reads, are worked out here on
the host).  The next dispatch's host work (concatenation, pinned copies)
overlaps the current dispatch's engine launches, which the host does not
wait for.

Each wait is a span and counts one ``host_syncs`` (``utils/profiling.py``):
``la3dm.sync.sort_runs``, the status read of each K7s sort
(``kernels/ingest_sort.py``: the point family's four, BGKL's three);
``la3dm.sync.ray_pairs``, the size of BGKL's ray-block pair list
(``kernels/ingest_rays.py``); ``la3dm.sync.fetch_small``, the key and count
copy here; and ``la3dm.sync.synchronize``, the map's
``OccupancyMapBase.synchronize``.  So a dispatch counts five, and a pass of
D dispatches ending in ``synchronize`` 5·D + 1.  The host work between them
is ``la3dm.ingest.prepare`` (concatenation, anchors, pinned copies),
``la3dm.ingest.tables`` (K7's host side) and ``la3dm.ingest.slots`` (key
unpack, ``np.unique``, ``BlockPool.ensure``, centres and scan runs).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from la3dm_tpu_torch.geometry import blocks as geo, device_ingest
from la3dm_tpu_torch.kernels import ingest_bucket, ingest_keys
from la3dm_tpu_torch.utils import profiling


class DeviceIngestMixin:
    """Chunked scan-sequence ingest on the map's device (module docstring)."""

    #: max scans per dispatch (set by the family)
    SCAN_BATCH = 16
    #: label of free-space entries (0 for BGK, −1 for GP, gpoctomap.cpp:399)
    FREE_LABEL = 0.0
    #: segment entries (BGKL): the ray pipeline ``ingest_batch_bgkl``
    SEGMENTS = False

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
        tkey, ucount = self._fetch_small(tabs["tkey"], tabs["ucount"])

        t0 = time.perf_counter()
        with profiling.span("la3dm.ingest.slots"):
            tscan, coords = ingest_keys.unpack_np(tkey, banchor)
            uniq, inv = np.unique(geo.pack_key(coords), return_inverse=True)
            slots = self.pool.ensure(geo.unpack_key(uniq))[inv.reshape(-1)]
            centers = geo.block_center(coords, self.block_size)
            scan_count = np.bincount(tscan, minlength=n)
            scan_start = np.concatenate([[0], np.cumsum(scan_count)[:-1]])
        self.stats["host_s"] += time.perf_counter() - t0
        self._dispatch_ingest_chunk(tabs, ucount, slots.astype(np.int32), centers,
                                    scan_start.tolist(), scan_count.tolist())

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

    def _dispatch_ingest_chunk(self, tabs: dict, ucount: np.ndarray, slots: np.ndarray,
                               centers: np.ndarray, scan_start: list,
                               scan_count: list) -> None:
        """Feed the device tables to the family's engine (hook)."""
        raise NotImplementedError
