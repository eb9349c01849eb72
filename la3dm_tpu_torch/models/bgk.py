"""BGKOctoMap — Bayesian generalized kernel inference with Beta posteriors,
on PyTorch and hand-written CUDA kernels.

The port of ``la3dm_tpu/models/bgk.py`` (reference
``src/bgkoctomap/bgkoctomap.cpp:214-366``), a two-pass engine over whole
scan sequences, on one of two ingest paths:

  device ingest (``device_ingest`` on, or auto on a CUDA map): raw clouds →
          block-sorted entry tables on the device (K7, models/ingest.py) →
          HEAVY pass K1′ (kernels/bgk_aligned_heavy.py): each test block's
          neighbour entry runs, relative to their block's centre, against
          the slot-shifted node tables
  host ingest: scans → training entries + per-block neighbour tables
          (native ``bgk_training_data`` + ``scan_bucket_tables``) →
          fixed-width entry rows (native ``row_tables``) → HEAVY pass K1
          (kernels/bgk_heavy.py): every (row × node) kernel product at ALL
          octree-level node centres of the row's test block, accumulated per
          (scan, block, neighbour slot)

then, on either path, the LIGHT pass (K2, kernels/bgk_light.py) — once per
scan, in order: the per-slot k̄ gate, the Beta update at each voxel's
eff-level node, and the prune.

Tensors take their exact sizes (no pad ladder: nothing here is compiled
per shape), and the pool tensors are updated in place.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from la3dm_tpu_torch.geometry import blocks as geo, native
from la3dm_tpu_torch.kernels import bgk_aligned_heavy, bgk_heavy, bgk_light
from la3dm_tpu_torch.models import base, bucketing, ingest, posterior
from la3dm_tpu_torch.utils import profiling
from la3dm_tpu_torch.utils.config import MapConfig

#: fixed entry-row width; per-block entry lists are cut into rows of W
_ROW_W = bgk_heavy.ROW_W
#: max scans per dispatch (one heavy pass, then one light pass per scan)
_SCAN_BATCH = 16
#: the host path's dispatch tables, in the step's argument order, and their
#: types: entries, labels, merged entry ids and their neighbour slot, the
#: rows' block, start and count, the test blocks' slots and centres
_HOST_TABLES = {"ent": np.float32, "lab": np.float32, "ids": np.int32, "gs": np.int8,
                "rb": np.int32, "rs": np.int32, "rn": np.int32, "slots": np.int32,
                "ctr": np.float32}


def _bgk_seq_step(A, Bv, touched, eff, all_nodes, node_idx_tab,
                  entries, labels, ids_flat, gslot_flat,
                  row_block, row_start, row_count,
                  slots_flat, centers_flat, scan_start, scan_count, *,
                  G: int, sf2: float, ell: float, gate: float, n: int,
                  max_level: int, state_fn, do_prune: bool) -> None:
    """K scans in one dispatch: the heavy pass once, then the light pass
    once per scan, in scan order.  Updates A, Bv, touched and eff in place.

    Shapes (the JAX step's argument tuple, padded or not): entries [N,3],
    labels [N], ids_flat/gslot_flat [F] merged entry ids and their
    neighbour slot, row_* [R] with ``row_block`` non-decreasing (count 0 ⇒
    padding), slots_flat/centers_flat [T] the stacked per-scan block lists
    (slot == pool capacity ⇒ padding).  ``scan_start``/``scan_count`` [K]
    are host integers: each scan's segment of the block lists.
    """
    acc = bgk_heavy.bgk_heavy(entries, labels, ids_flat, gslot_flat, row_block,
                              row_start, row_count, centers_flat, all_nodes,
                              G=G, sf2=sf2, ell=ell)
    for start, count in zip(scan_start, scan_count):
        with profiling.span("la3dm.light.launch"):
            bgk_light.bgk_light(acc, A, Bv, touched, eff, node_idx_tab, slots_flat,
                                int(start), int(count), G=G, gate=gate, n=n,
                                max_level=max_level, state_fn=state_fn,
                                do_prune=do_prune)


def _bgk_seq_step_aligned(A, Bv, touched, eff, ext_nodes, node_idx_tab, ent_rel, labels,
                          ustart, ucount, tb_u, slots_flat, scan_start, scan_count, *,
                          G: int, sf2: float, ell: float, gate: float, n: int,
                          max_level: int, state_fn, do_prune: bool) -> None:
    """The device-ingest dispatch (``_bgk_seq_step_aligned`` of the JAX
    package): K1′ once, then the light pass K2 once per scan, in scan order,
    on K1′'s accumulator [T, Vall, 2G].  ``slots_flat`` [T] are the test
    blocks' pool slots; ``scan_start``/``scan_count`` host integers."""
    acc = bgk_aligned_heavy.bgk_aligned_heavy(ent_rel, labels, ustart, ucount, tb_u,
                                              ext_nodes, G=G, sf2=sf2, ell=ell)
    for start, count in zip(scan_start, scan_count):
        with profiling.span("la3dm.light.launch"):
            bgk_light.bgk_light(acc, A, Bv, touched, eff, node_idx_tab, slots_flat,
                                int(start), int(count), G=G, gate=gate, n=n,
                                max_level=max_level, state_fn=state_fn,
                                do_prune=do_prune)


class BGKOctoMap(ingest.DeviceIngestMixin, base.OccupancyMapBase):
    """BGK occupancy map (ctor params: bgkoctomap.cpp:31-56).

    ``device`` is where the pool lives and the engine runs: CUDA unless the
    caller names another (``device="cpu"`` runs the plain PyTorch versions of
    the kernels).  ``cfg.device_ingest`` picks the ingest path (on, off, or
    auto: on for a CUDA map).
    """

    GATE = 0.0  # update gate: k̄ > 0 (bgkoctomap.cpp:332)
    SCAN_BATCH = _SCAN_BATCH

    @profiling.traced("la3dm.map.build")
    def __init__(self, cfg: MapConfig, device=None):
        super().__init__(cfg, device)
        nodes, node_idx = geo.all_level_nodes(cfg.resolution, cfg.block_depth)
        self._all_nodes_host = nodes
        self._node_idx_host = node_idx
        self._all_nodes = torch.as_tensor(nodes, device=self.device)
        self._node_idx = torch.as_tensor(node_idx, device=self.device)
        # the node tables shifted by each neighbour slot: all_nodes − off_g·bs
        # (f32, as the JAX package builds them), [G·Vall, 3]
        shifts = -np.asarray(self._neighbor_offsets, np.float32) * np.float32(self.block_size)
        self._ext_nodes = torch.as_tensor(
            (nodes[None] + shifts[:, None, :]).reshape(-1, 3).astype(np.float32),
            device=self.device)
        self.stats["ingest_host_chunks"] = 0

    def _field_fills(self):
        # prior pseudo-counts are the pool fill values (bgkoctree_node.h:33)
        return {"A": self.cfg.prior_A, "B": self.cfg.prior_B}

    def _make_state_fn(self):
        cfg = self.cfg
        return posterior.BetaStateFn(cfg.var_thresh, cfg.free_thresh,
                                     cfg.occupied_thresh)

    # ------------------------------------------------------------------ API

    @profiling.traced("la3dm.map.insert")
    def insert_pointcloud(self, cloud: np.ndarray, origin: np.ndarray,
                          ds_resolution: float | None = None,
                          free_resolution: float | None = None,
                          max_range: float | None = None) -> None:
        """Integrate one scan (reference insert_pointcloud, bgkoctomap.cpp:214)."""
        if self._insert_device([cloud], [origin], ds_resolution, free_resolution,
                               max_range):
            return
        t0 = time.perf_counter()
        t = self._scan_tables(cloud, origin, ds_resolution, free_resolution,
                              max_range)
        self.stats["host_s"] += time.perf_counter() - t0
        self._integrate([t] if t is not None else [])

    @profiling.traced("la3dm.map.insert")
    def insert_pointclouds(self, clouds, origins, ds_resolution=None,
                           free_resolution=None, max_range=None) -> None:
        """Integrate a scan sequence, ≤ SCAN_BATCH scans per dispatch.

        Exact relative to the sequential loop up to f32 sum order: the
        light pass applies each scan's gate, update and prune in order, and
        each dispatch resumes from the previous one's pool state.  With device
        ingest the device builds each dispatch's tables.  On the host path,
        scan preprocessing runs in a thread pool while earlier dispatches run
        on the device; ``host_s`` counts main-thread host work plus the waits
        for preprocessing.
        """
        if self._insert_device(clouds, origins, ds_resolution, free_resolution,
                               max_range):
            return
        with ThreadPoolExecutor(max_workers=min(8, max(len(clouds), 1))) as ex:
            futures = [ex.submit(self._scan_tables, c, o, ds_resolution,
                                 free_resolution, max_range)
                       for c, o in zip(clouds, origins)]
            buf = []
            for f in futures:
                t0 = time.perf_counter()
                t = f.result()
                self.stats["host_s"] += time.perf_counter() - t0
                if t is not None:
                    buf.append(t)
                if len(buf) == _SCAN_BATCH:
                    self._integrate(buf)
                    buf = []
            if buf:
                self._integrate(buf)

    def insert_training_data(self, points: np.ndarray, labels: np.ndarray) -> None:
        """Integrate pre-labeled training points (bgkoctomap.cpp:82-212)."""
        points = np.asarray(points, np.float32)
        coords, idx = geo.point_block_memberships(points, self.block_size)
        t = bucketing.bucket_tables(
            coords, points[idx], np.asarray(labels, np.float32)[idx],
            self._neighbor_offsets)
        self._integrate([t] if len(t.test_coords) else [])

    # ------------------------------------------------------------- internals

    def _scan_tables(self, cloud, origin, ds_resolution, free_resolution,
                     max_range) -> bucketing.BucketTables | None:
        """Scan → bucket tables through the native library (None if empty)."""
        cfg = self.cfg
        ds = cfg.ds_resolution if ds_resolution is None else ds_resolution
        fr = cfg.free_resolution if free_resolution is None else free_resolution
        mr = cfg.max_range if max_range is None else max_range
        td = native.bgk_training_data(cloud, origin, ds, fr, mr, free_label=0.0)
        if len(td.points) == 0:
            return None
        nt = native.scan_bucket_tables(td.points, td.labels, self.block_size,
                                       self._neighbor_offsets)
        if len(nt["test_coords"]) == 0:
            return None
        return bucketing.BucketTables(
            test_coords=nt["test_coords"], entries=nt["entries"],
            labels=nt["labels"], starts=nt["starts"], counts=nt["counts"],
            max_total=int(nt["counts"].sum(axis=1).max()))

    def _row_tables(self, t: bucketing.BucketTables):
        """Merged per-block entry id list + fixed-width rows (native).

        Returns (ids [F] i32, gslot [F] i8, row_block [R] i32, row_start [R]
        i64, row_count [R] i32, totals [B] i64): for each test block its G
        neighbour segments concatenated in slot order (``gslot`` carries the
        slot for the per-model gate), cut into rows of ``_ROW_W``.
        """
        return native.row_tables(t.starts, t.counts, _ROW_W)

    def _integrate(self, tables: list) -> None:
        """Integrate K ≤ SCAN_BATCH scans' bucket tables in one dispatch."""
        if not tables:
            return
        if len(tables) > _SCAN_BATCH:
            for i in range(0, len(tables), _SCAN_BATCH):
                self._integrate(tables[i:i + _SCAN_BATCH])
            return
        t_host0 = time.perf_counter()
        Vall = self._all_nodes_host.shape[0]
        parts = {k: [] for k in _HOST_TABLES}
        coords, scan_start, scan_count = [], [], []
        ent_off = id_off = blk_off = 0
        gen0 = self.pool.generation
        for t in tables:
            # entry totals weight the sharded pool's placement
            slots = self.pool.ensure(t.test_coords, weights=t.counts.sum(axis=1))
            ids, gslot, row_block, row_start, row_count, totals = \
                self._row_tables(t)
            parts["ent"].append(t.entries)
            parts["lab"].append(t.labels)
            parts["ids"].append(ids + ent_off)
            parts["gs"].append(gslot)
            parts["rb"].append(row_block + blk_off)
            parts["rs"].append(row_start + id_off)
            parts["rn"].append(row_count)
            parts["slots"].append(slots)
            parts["ctr"].append(self.block_centers(t.test_coords))
            coords.append(t.test_coords)
            scan_start.append(blk_off)
            scan_count.append(len(slots))
            ent_off += len(t.entries)
            id_off += len(ids)
            blk_off += len(slots)
            self.stats["kernel_evals"] += int(totals.sum()) * Vall
            self.stats["scans"] += 1
        profiling.count("scans", len(tables))
        profiling.count("dispatches")

        cat = {k: np.concatenate(v).astype(_HOST_TABLES[k]) for k, v in parts.items()}
        if self.pool.generation != gen0:
            # a sharded pool re-laid out its slots while later tables were
            # ensured: re-resolve the whole batch
            cat["slots"] = self.pool.lookup(np.concatenate(coords)).astype(np.int32)
        self.stats["host_s"] += time.perf_counter() - t_host0
        self._host_step(cat, scan_start, scan_count)

    @profiling.traced("la3dm.heavy.launch")
    def _host_step(self, cat: dict, scan_start: list, scan_count: list,
                   rows: slice = slice(None)) -> None:
        """K1, then K2 a scan, on the host path's tables ``cat`` (host
        arrays of :data:`_HOST_TABLES`' types, or tensors on the device) and
        the pool rows ``rows``, which the slots address."""
        t0 = time.perf_counter()
        cfg = self.cfg
        dev = self._to_device
        pool = self.pool
        args = (pool.fields["A"][rows], pool.fields["B"][rows], pool.touched[rows],
                pool.eff_level[rows], self._all_nodes, self._node_idx,
                *(dev(cat[k]) for k in _HOST_TABLES), scan_start, scan_count)
        statics = dict(G=self.num_slots, sf2=cfg.sf2, ell=cfg.ell, gate=self.GATE,
                       n=self.n, max_level=cfg.block_depth - 1,
                       state_fn=self._state_fn, do_prune=cfg.block_depth > 1)
        self.stats["host_s"] += time.perf_counter() - t0
        if getattr(self, "_capture_step_args", False):
            # the step updates the pool in place: keep copies of its inputs
            self._last_step_call = (
                tuple(a.clone() if torch.is_tensor(a) else list(a) for a in args),
                statics)
        _bgk_seq_step(*args, **statics)

    def _dispatch_ingest_chunk(self, tabs, ucount, slots, centers, scan_start,
                               scan_count) -> None:
        """Device tables of one dispatch → K1′ + K2 (``centers`` None: K1′
        takes the entries relative to their block's centre)."""
        G, Vall = self.num_slots, self._all_nodes_host.shape[0]
        self.stats["kernel_evals"] += int(ucount.sum()) * G * Vall
        self._ingest_step(tabs, slots, scan_start, scan_count)

    @profiling.traced("la3dm.heavy.launch")
    def _ingest_step(self, tabs: dict, slots, scan_start: list, scan_count: list,
                     rows: slice = slice(None)) -> None:
        """K1′, then K2 a scan, on the device tables ``tabs`` (``tb_u`` [T, G]
        the test blocks' rows, ``slots`` [T] int32 their slots, a device
        tensor or a host array) and the pool rows ``rows``."""
        cfg = self.cfg
        pool = self.pool
        _bgk_seq_step_aligned(
            pool.fields["A"][rows], pool.fields["B"][rows], pool.touched[rows],
            pool.eff_level[rows], self._ext_nodes, self._node_idx, tabs["ent_rel"],
            tabs["lab"], tabs["ustart"], tabs["ucount"], tabs["tb_u"],
            self._to_device(slots), scan_start, scan_count, G=self.num_slots,
            sf2=cfg.sf2, ell=cfg.ell, gate=self.GATE, n=self.n,
            max_level=cfg.block_depth - 1, state_fn=self._state_fn,
            do_prune=cfg.block_depth > 1)

    def _posterior(self, fields: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        cfg = self.cfg
        A, B = fields["A"], fields["B"]
        prob = A / (A + B)
        var = (A * B) / ((A + B) ** 2 * (A + B + 1.0))
        st = np.where(prob > cfg.occupied_thresh, posterior.OCCUPIED,
                      np.where(prob < cfg.free_thresh, posterior.FREE,
                               posterior.UNKNOWN))
        st = np.where(var > cfg.var_thresh, posterior.UNKNOWN, st)
        st = np.where(fields["touched"], st, posterior.UNKNOWN).astype(np.int8)
        return {"prob": prob, "var": var, "state": st, "A": A, "B": B}
