"""BGKLVOctoMap — evidence-mass occupancy with per-voxel ℓ-ball inference,
on PyTorch and hand-written CUDA kernels.

The port of ``la3dm_tpu/models/bgklv.py`` (reference
``src/bgklvoctomap/bgklvoctomap.cpp:89-285``): every block in the scan's
bbox sweep is materialised; each base-resolution voxel takes the hits and
the free rays whose R-tree proxy samples fall in its ±ℓ cube, and runs the
BGKLV predict with the gate k̄ > 0.001 (:236-238); pruning runs only with
``original_size`` (:271-272).

  host:   scans → segment training data (native ``lv_training_data``) →
          per-8³-tile halo tables (native ``lv_tile_tables_ray``) → the
          candidate block sweep, the tiles' merged entry ids and fixed-width
          rows (``_scan_rows``, ``_integrate_many``)
  device: the row engine (K3, kernels/lv_rows.py) — membership, LV kernel,
          per-(scan, tile) sums, gate and pool add — once per dispatch of
          ≤ 12 scans; with ``original_size``, one scan per dispatch and the
          tile-major prune (K8, kernels/lv_prune.py) after it.

The pool stores each block's voxels TILE-MAJOR (stored column pos·Vt + vt,
``geometry/blocks.py::tile_vox_map``) so that a tile's update is one
contiguous run; the base-class hooks convert queries, exports and
checkpoints to raster order.  Tensors take their exact sizes (no pad
ladder), and the pool tensors are updated in place.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from la3dm_tpu_torch.geometry import blocks as geo, native
from la3dm_tpu_torch.geometry.preprocess import SegmentTrainingData
from la3dm_tpu_torch.kernels import lv_prune, lv_rows
from la3dm_tpu_torch.models import base, posterior
from la3dm_tpu_torch.utils import profiling
from la3dm_tpu_torch.utils.config import MapConfig

#: fixed entry-row width; tiles with more entries get several rows
_ROW_W = lv_rows.ROW_W
#: max scans per dispatch
_SCAN_BATCH = 12


def _intra(counts: np.ndarray) -> np.ndarray:
    """[sum(counts)] int64: 0..c−1 within each group, groups laid out in order."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    return np.arange(total, dtype=np.int64) - np.repeat(ends - counts, counts)


class BGKLVOctoMap(base.OccupancyMapBase):
    """BGKLV occupancy map.  ``device`` is where the pool lives and the
    engine runs: CUDA unless the caller names another (``device="cpu"``
    runs the plain PyTorch versions of the kernels)."""

    GATE = 0.001  # update gate: k̄ > 0.001 (bgklvoctomap.cpp:236-238)
    SCAN_BATCH = _SCAN_BATCH
    # the server passes the raw cloud through (bgklvoctomap_server.cpp:76-77)
    SERVER_DOWNSAMPLE = False

    @profiling.traced("la3dm.map.build")
    def __init__(self, cfg: MapConfig, device=None):
        # ``cfg.device_ingest`` is not read: LV runs its own ray-shortening
        # host ingest whatever the flag, as the JAX class does
        super().__init__(cfg, device)
        self._vox_base = geo.voxel_offsets(cfg.resolution, cfg.block_depth)
        # tile geometry: 8³ voxels (or the whole block when smaller)
        self.tile_edge = min(8, self.n)
        self.tiles_per_axis = self.n // self.tile_edge
        self.Vt = self.tile_edge ** 3
        self._tile_vox_map = geo.tile_vox_map(self.n)          # [tpb, Vt]
        self._vox_perm = self._tile_vox_map.reshape(-1)       # stored → raster
        self._vox_inv = np.argsort(self._vox_perm)            # raster → stored
        self._vox_inv_dev = torch.as_tensor(self._vox_inv, device=self.device)
        self._vox_base_t = torch.as_tensor(self._vox_base[self._tile_vox_map],
                                           device=self.device)  # [tpb,Vt,3]
        self._last_free_res = float(cfg.free_resolution)

    # -- voxel-storage order hooks (models/base.py) -----------------------

    def _stored_vidx(self, vidx):
        return self._vox_inv[vidx]

    def _stored_to_raster(self, rows):
        return rows[:, self._vox_inv]

    def _raster_to_stored(self, rows):
        return rows[:, self._vox_perm]

    def _stored_to_raster_dev(self, arr):
        return arr[:, self._vox_inv_dev]

    def _field_fills(self):
        return {"A": self.cfg.prior_A, "B": self.cfg.prior_B}

    def _make_state_fn(self):
        cfg = self.cfg
        return posterior.LVStateFn(cfg.min_W, cfg.var_thresh, cfg.free_thresh,
                                   cfg.occupied_thresh)

    # ------------------------------------------------------------------ API

    def _preprocess_scan(self, cloud, origin, ds_resolution, free_resolution,
                         max_range) -> SegmentTrainingData:
        cfg = self.cfg
        ds = cfg.ds_resolution if ds_resolution is None else ds_resolution
        ds = min(ds, cfg.resolution)  # clamp (bgklvoctomap.cpp:102-104)
        fr = cfg.free_resolution if free_resolution is None else free_resolution
        mr = cfg.max_range if max_range is None else max_range
        self._last_free_res = float(fr)
        return native.lv_training_data(cloud, origin, ds, fr, mr, cfg.ell)

    @profiling.traced("la3dm.map.insert")
    def insert_pointcloud(self, cloud, origin, ds_resolution=None,
                          free_resolution=None, max_range=None) -> None:
        """Integrate one scan (reference insert_pointcloud, bgklvoctomap.cpp:89)."""
        t0 = time.perf_counter()
        td = self._preprocess_scan(cloud, origin, ds_resolution,
                                   free_resolution, max_range)
        self.stats["host_s"] += time.perf_counter() - t0
        self._integrate_many([td])

    @profiling.traced("la3dm.map.insert")
    def insert_pointclouds(self, clouds, origins, ds_resolution=None,
                           free_resolution=None, max_range=None) -> None:
        """Integrate a scan sequence, ≤ SCAN_BATCH scans per dispatch.

        Exact relative to the sequential loop up to f32 sum order whenever
        pruning is off (the default; the reference prunes only with
        original_size, bgklvoctomap.cpp:271-272): the Beta update is an
        additive scatter gated per (scan, voxel).  With original_size each
        scan is integrated and pruned on its own, so that it sees the
        previous scan's leaf levels.  Scan preprocessing runs in a thread
        pool while earlier dispatches run on the device.
        """
        if self.cfg.original_size and self.cfg.block_depth > 1:
            for cloud, origin in zip(clouds, origins):
                self.insert_pointcloud(cloud, origin, ds_resolution,
                                       free_resolution, max_range)
            return

        def work(co):
            td = self._preprocess_scan(co[0], co[1], ds_resolution,
                                       free_resolution, max_range)
            return td, self._scan_tables(td)

        with ThreadPoolExecutor(max_workers=min(8, max(len(clouds), 1))) as ex:
            futures = [ex.submit(work, co) for co in zip(clouds, origins)]
            buf = []
            for f in futures:
                t0 = time.perf_counter()
                pair = f.result()
                self.stats["host_s"] += time.perf_counter() - t0
                buf.append(pair)
                if len(buf) == _SCAN_BATCH:
                    self._integrate_many([td for td, _ in buf],
                                         tables=[t for _, t in buf])
                    buf = []
            if buf:
                self._integrate_many([td for td, _ in buf],
                                     tables=[t for _, t in buf])

    # ------------------------------------------------------------- internals

    def _scan_tables(self, td: SegmentTrainingData):
        """Per-tile halo membership tables of one scan (native segment event
        walk), or None for an empty scan.

        Returns (active_keys, h_start, h_count, r_start, r_count,
        hits_sorted, rays_sorted): contiguous per-tile segments into the
        tile-sorted hit and ray id tables.
        """
        if len(td.hits) == 0 and len(td.samples) == 0:
            return None
        bs = self.block_size
        # tile grid in the block-corner frame: blocks are CENTERED at k·bs
        # (round-half-up hashing), so shift by bs/2 to make tile m cover
        # q ∈ [m·ts, (m+1)·ts) with block k = floor(m / tpa) exactly aligned
        ts = bs / self.tiles_per_axis
        shift = np.float64(bs) / 2.0
        tables = native.lv_tile_tables_ray(td.hits, td.rays, ts, self.cfg.ell,
                                           float(shift))
        return tables if len(tables[0]) else None

    def _scan_rows(self, td: SegmentTrainingData, tables=None):
        """One scan's (scan, tile) list in this scan's block sweep and its
        merged per-tile entry ids (hits first, then rays; scan-local
        numbering hits 0..H−1, rays H..H+R−1 — the reference builds each
        voxel's training set hits-then-frees, bgklvoctomap.cpp:176-207).
        None if the scan reaches no tile."""
        if len(td.hits) == 0 and len(td.samples) == 0:
            return None
        if tables is None:
            tables = self._scan_tables(td)
        if tables is None:
            return None
        lim_min = td.bbox[0].astype(np.float64)
        lim_max = td.bbox[1].astype(np.float64)
        (active_keys, h_start, h_count, r_start, r_count,
         hits_sorted, rays_sorted) = tables

        # candidate blocks: the reference's float-stepped bbox sweep creates
        # every block from lim_min−bs to lim_max+2bs (bgkloctomap.cpp:409-418)
        bs = self.block_size
        los, his = [], []
        for ax in range(3):
            k_max = int(np.floor((lim_max[ax] + 2 * bs - (lim_min[ax] - bs)) / bs))
            los.append(int(np.floor((lim_min[ax] - bs) / bs + 0.5)))
            his.append(int(np.floor((lim_min[ax] - bs + k_max * bs) / bs + 0.5)))
        gx, gy, gz = np.meshgrid(*[np.arange(lo, hi + 1) for lo, hi in zip(los, his)],
                                 indexing="ij")
        cand = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.int64)

        tile_coords = geo.unpack_key(active_keys)               # [T,3]
        tpa = self.tiles_per_axis
        blk_coords = np.floor_divide(tile_coords, tpa)
        tile_pos = tile_coords - blk_coords * tpa               # [T,3] ∈ [0,tpa)
        pos_id = (tile_pos[:, 0] + tile_pos[:, 1] * tpa
                  + tile_pos[:, 2] * tpa * tpa).astype(np.int32)
        # only blocks in THIS scan's sweep are updated (the reference
        # iterates the sweep's blocks); halo spill outside it is dropped
        cand_keys = np.sort(geo.pack_key(cand))
        bk = geo.pack_key(blk_coords)
        pos = np.clip(np.searchsorted(cand_keys, bk), 0, max(len(cand_keys) - 1, 0))
        in_sweep = cand_keys[pos] == bk if len(cand_keys) else np.zeros(len(bk), bool)
        # the worked blocks first, in key order, then the rest of the sweep:
        # the JAX package's allocation order, so both give the same slots;
        # the worked blocks' hit and ray counts weight the sharded pool's
        # placement
        wb_keys, wb_inv = np.unique(bk[in_sweep], return_inverse=True)
        if len(wb_keys):
            w = np.zeros(len(wb_keys), np.float64)
            np.add.at(w, wb_inv.reshape(-1),
                      (h_count + r_count)[in_sweep].astype(np.float64))
            self.pool.ensure(geo.unpack_key(wb_keys), weights=w)
        self.pool.ensure(cand)
        slots = self.pool.lookup(blk_coords)
        keep = (slots >= 0) & in_sweep
        pos_id, slots = pos_id[keep], slots[keep]
        h_start, h_count = h_start[keep], h_count[keep]
        r_start, r_count = r_start[keep], r_count[keep]
        if len(slots) == 0:
            return None
        centers = geo.block_center(blk_coords[keep], bs)        # [T,3]

        # merged tile-major entry id table: hits then rays per tile
        H = len(td.hits)
        mcount = (h_count + r_count).astype(np.int64)
        mstart = np.concatenate([[0], np.cumsum(mcount)[:-1]])
        ids = np.empty(int(mcount.sum()), np.int64)
        hi_ = _intra(h_count)
        ids[np.repeat(mstart, h_count) + hi_] = \
            hits_sorted[np.repeat(h_start, h_count) + hi_]
        ri_ = _intra(r_count)
        ids[np.repeat(mstart + h_count, r_count) + ri_] = \
            rays_sorted[np.repeat(r_start, r_count) + ri_].astype(np.int64) + H
        return {"slots": slots, "blk_coords": blk_coords[keep], "pos_id": pos_id,
                "centers": centers, "mcount": mcount, "ids": ids, "td": td}

    def _integrate_many(self, tds: list, tables: list | None = None) -> None:
        """Integrate K ≤ SCAN_BATCH scans in one dispatch (then prune each
        updated block with original_size)."""
        if self.pool.shard_rows * self.V >= 2 ** 31:
            raise ValueError("pool capacity × V overflows int32 flat addressing")
        if tables is None:
            tables = [None] * len(tds)
        if len(tds) > _SCAN_BATCH:
            for i in range(0, len(tds), _SCAN_BATCH):
                self._integrate_many(tds[i:i + _SCAN_BATCH],
                                     tables[i:i + _SCAN_BATCH])
            return
        t_host0 = time.perf_counter()
        gen0 = self.pool.generation
        scans = [s for s in (self._scan_rows(td, tb)
                             for td, tb in zip(tds, tables)) if s is not None]
        if not scans:
            return
        if self.pool.generation != gen0:
            # a sharded pool re-laid out its slots while later scans' sweeps
            # were ensured: re-resolve the earlier scans' slots
            for s in scans:
                s["slots"] = self.pool.lookup(s["blk_coords"])

        # global entries: per scan [hits as degenerate segments; rays]
        ent_parts, lab_parts, base_off = [], [], []
        off = 0
        for s in scans:
            td = s["td"]
            H, R = len(td.hits), len(td.rays)
            ent_parts.append(np.concatenate([td.hits, td.hits], axis=1))
            ent_parts.append(td.rays)
            lab_parts.append(np.ones(H, np.float32))
            lab_parts.append(np.zeros(R, np.float32))
            base_off.append(off)
            off += H + R
        entries = np.concatenate(ent_parts, axis=0).astype(np.float32)
        labels = np.concatenate(lab_parts)
        ids = np.concatenate([s["ids"] + b for s, b in zip(scans, base_off)])
        tiles = {k: np.concatenate([s[k] for s in scans])
                 for k in ("slots", "pos_id", "centers", "mcount")}
        tiles["mstart"] = np.concatenate([[0], np.cumsum(tiles["mcount"])[:-1]])

        self.stats["kernel_evals"] += int(tiles["mcount"].sum()) * self.Vt
        self.stats["scans"] += len(scans)
        profiling.count("scans", len(scans))
        profiling.count("dispatches")
        dev = self._to_device
        entries, labels, ids = dev(entries), dev(labels), dev(ids.astype(np.int32))
        self.stats["host_s"] += time.perf_counter() - t_host0
        self._lv_step(entries, labels, ids, tiles)

    def _lv_step(self, entries, labels, ids, tiles: dict, rows: slice = slice(None)) -> None:
        """K3 on the (scan, tile) list ``tiles`` (host arrays: each tile's
        slot, position in its block, block centre, and its run ``mstart``,
        ``mcount`` of the merged entry ids ``ids``), cut into rows of
        ``_ROW_W``, on the pool rows ``rows``, which the slots address; then,
        with original_size, K8 over the tiles' blocks."""
        t0 = time.perf_counter()
        W = _ROW_W
        mcount = tiles["mcount"]
        nrows = (mcount + W - 1) // W
        j = _intra(nrows)
        row_tile = np.repeat(np.arange(len(mcount), dtype=np.int32), nrows)
        row_start = (np.repeat(tiles["mstart"], nrows) + j * W).astype(np.int32)
        row_count = np.minimum(W, np.repeat(mcount, nrows) - j * W).astype(np.int32)

        cfg = self.cfg
        dev = self._to_device
        pool = self.pool
        args = (pool.fields["A"][rows], pool.fields["B"][rows], pool.touched[rows],
                pool.eff_level[rows], self._vox_base_t, entries, labels, ids,
                dev(row_tile), dev(row_start), dev(row_count),
                dev(tiles["slots"].astype(np.int32)), dev(tiles["pos_id"]),
                dev(tiles["centers"].astype(np.float32)))
        statics = dict(sf2=cfg.sf2, ell=cfg.ell, free_res=self._last_free_res,
                       gate=self.GATE)
        self.stats["host_s"] += time.perf_counter() - t0
        if getattr(self, "_capture_step_args", False):
            # the step updates the pool in place: keep copies of its inputs
            self._last_step_call = (tuple(a.clone() for a in args), statics)
        lv_rows.lv_rows(*args, **statics)

        if cfg.original_size and cfg.block_depth > 1:
            self._prune(np.unique(tiles["slots"]), rows)

    def _prune(self, slots: np.ndarray, rows: slice = slice(None)) -> None:
        """original_size pruning of the given blocks on the tile-major pool
        rows ``rows``, which ``slots`` address."""
        if self.cfg.block_depth <= 1 or len(slots) == 0:
            return
        pool = self.pool
        args = (pool.fields["A"][rows], pool.fields["B"][rows], pool.touched[rows],
                pool.eff_level[rows], self._to_device(np.asarray(slots, np.int32)))
        statics = dict(n=self.n, max_level=self.cfg.block_depth - 1,
                       state_fn=self._state_fn)
        if getattr(self, "_capture_step_args", False):
            self._last_prune_call = (tuple(a.clone() for a in args), statics)
        lv_prune.lv_prune(*args, **statics)

    def _posterior(self, fields: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        cfg = self.cfg
        A, B = fields["A"], fields["B"]
        with np.errstate(divide="ignore", invalid="ignore"):
            W = np.maximum(A + B, cfg.min_W)
            occ = A / (W - B) + (W - A - B) * 0.5 / (W - B)
            free = 0.5 * (W - B - A) / (W - A)
            prob = np.where(A > B, occ, free)
            var = (A / W) * (1 - prob) ** 2 + ((W - A - B) / W) * (0.5 - prob) ** 2 \
                + (B / W) * prob ** 2
        st = np.where(prob > cfg.occupied_thresh, posterior.OCCUPIED,
                      np.where(prob < cfg.free_thresh, posterior.FREE,
                               posterior.UNKNOWN))
        st = np.where(var > cfg.var_thresh, posterior.UNCERTAIN, st)
        st = np.where(fields["touched"], st, posterior.UNKNOWN).astype(np.int8)
        return {"prob": prob, "var": var, "state": st, "A": A, "B": B}
