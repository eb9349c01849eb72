"""GPOctoMap — per-block exact GP regression with BCM fusion, on PyTorch and
hand-written CUDA kernels.

The port of ``la3dm_tpu/models/gp.py`` on its host-ingest path (reference
``src/gpoctomap/gpoctomap.cpp``, ``gpregressor.h``, ``gpoctree_node.cpp``):
each block with training points trains an exact GP (Matérn-3/2 +
Cholesky) on its own points; each test block queries the models of its
extended neighbourhood and fuses them with the BCM information-filter update
``ivar += 1/σ² − sf2; m_ivar += μ/σ²``, with the order-dependent persistent
ivar chop (gpoctree_node.cpp:36-49).  Free space is labelled −1
(gpoctomap.cpp:399); there is no k̄ gate.

The same two-pass engine as the port's BGK:

  ingest: on the device (``device_ingest`` on, or auto on a CUDA map; K7,
          models/ingest.py): raw clouds → block-sorted training points, one
          model per entry block, and the test blocks each serves; or on the
          host: scans → training points (native ``bgk_training_data``) →
          per-model point segments and served test blocks (native
          ``scan_bucket_tables``)
  device: HEAVY pass (K4, kernels/gp_heavy.py) — once per size tier: every
          model's GP, predicted at ALL octree-level node centres of each test
          block it serves, into per-(block, slot) tables; LIGHT pass (K5,
          kernels/gp_light.py) — once per scan, in order: the sequential BCM
          at each voxel's eff-level node, then the prune.

Size tiers: models are split by point count into a base tier (≤ 128 points)
and, only when a dispatch holds denser blocks, one overflow tier (the JAX
step pads it to next_pow2(max count); here every model keeps its own count,
and K4 runs the same kernels on both tiers).  Tensors
take their exact sizes (no pad ladder), and the pool tensors are updated in
place.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from la3dm_tpu_torch.geometry import blocks as geo, native
from la3dm_tpu_torch.kernels import gp_heavy, gp_light
from la3dm_tpu_torch.models import base, ingest, posterior
from la3dm_tpu_torch.utils import profiling
from la3dm_tpu_torch.utils.config import MapConfig

#: max scans per dispatch (one heavy pass per tier, then one light per scan)
_SCAN_BATCH = 16


def _gp_seq_step(m_ivar, ivar, touched, eff, all_nodes, node_idx_tab, pts, lab,
                 tiers, slots_flat, centers_flat, scan_start, scan_count, failed, *,
                 G: int, sf2: float, ell: float, noise: float, min_known_ivar: float,
                 max_ivar: float, n: int, max_level: int, state_fn,
                 do_prune: bool, uncounted=()) -> None:
    """K scans in one dispatch: the heavy pass once per tier, then the light
    pass once per scan, in scan order.  Updates the pool in place and adds
    failed factorisations to ``failed``.

    ``tiers``: (starts [M] i32, counts [M] i32, nb_rows [M, G] i32, the
    counts as a host array) per size tier; pts [N,3] / lab [N] the dispatch's
    block-sorted training points; slots_flat/centers_flat [T] the stacked
    per-scan block lists.
    ``scan_start``/``scan_count`` [K] are host integers: each scan's segment
    of the block lists.  ``uncounted``: tiers as ``tiers`` whose failed
    factorisations are not added to ``failed`` (a sharded map's models that
    another shard counts).
    """
    T, Vall = centers_flat.shape[0], all_nodes.shape[0]
    dev = pts.device
    acc_mean = torch.zeros((T * G, Vall), dtype=torch.float32, device=dev)
    acc_var = torch.ones((T * G, Vall), dtype=torch.float32, device=dev)
    present = torch.zeros((T * G,), dtype=torch.bool, device=dev)
    scratch = torch.zeros_like(failed) if uncounted else None
    for tier_list, fails in ((tiers, failed), (uncounted, scratch)):
        for starts, counts, nb_rows, host_counts in tier_list:
            gp_heavy.gp_heavy(pts, lab, starts, counts, nb_rows, centers_flat, all_nodes,
                              acc_mean, acc_var, present, fails,
                              host_counts=host_counts, sf2=sf2, ell=ell, noise=noise)
    for start, count in zip(scan_start, scan_count):
        with profiling.span("la3dm.light.launch"):
            gp_light.gp_light(acc_mean, acc_var, present, m_ivar, ivar, touched, eff,
                              node_idx_tab, slots_flat, int(start), int(count), G=G,
                              sf2=sf2, min_known_ivar=min_known_ivar, max_ivar=max_ivar,
                              n=n, max_level=max_level, state_fn=state_fn,
                              do_prune=do_prune)


def _size_tiers(counts: np.ndarray) -> list[np.ndarray]:
    """The models of each size tier of the host ``counts``, as index arrays:
    the base tier (≤ ``gp_heavy.BASE_MAX_C`` points), then the overflow tier,
    each if it holds a model."""
    base_tier = counts <= gp_heavy.BASE_MAX_C
    return [sel for sel in (np.nonzero(base_tier)[0], np.nonzero(~base_tier)[0]) if len(sel)]


def _gp_tier_gather(ustart, ucount, nb_row, sel):
    """One size tier's model tables from the device-ingest tables: the
    entry blocks ``sel`` (an index tensor) as (starts, counts, nb_rows)
    int32, K4's arguments (``_gp_tier_gather`` of the JAX package)."""
    return (ustart[sel].to(torch.int32), ucount[sel].to(torch.int32),
            nb_row[sel].to(torch.int32))


def _host_typed(x, dtype):
    """``x`` as it is where it is a tensor, else a host array of ``dtype``."""
    return x if torch.is_tensor(x) else np.asarray(x, dtype)


class GPOctoMap(ingest.DeviceIngestMixin, base.OccupancyMapBase):
    """GP occupancy map (ctor params: gpoctomap.cpp:31-56).

    ``device`` is where the pool lives and the engine runs: CUDA unless the
    caller names another (``device="cpu"`` runs the plain PyTorch versions of
    the kernels).  ``failed_models`` counts, on the device, the block models
    whose Gram was not positive definite (their predictions are NaN, as in
    the JAX package).  ``cfg.device_ingest`` picks the ingest path (on, off,
    or auto: on for a CUDA map).
    """

    SCAN_BATCH = _SCAN_BATCH
    FREE_LABEL = -1.0  # gpoctomap.cpp:399
    TEST_CENTERS = True  # K4 predicts at the test blocks' centres

    @profiling.traced("la3dm.map.build")
    def __init__(self, cfg: MapConfig, device=None):
        # min_ivar = 1/max_var etc. (gpoctomap.cpp:39-41)
        self.min_ivar = 1.0 / cfg.max_var
        self.max_ivar = 1.0 / cfg.min_var
        self.min_known_ivar = 1.0 / cfg.max_known_var
        super().__init__(cfg, device)
        nodes, node_idx = geo.all_level_nodes(cfg.resolution, cfg.block_depth)
        self._all_nodes = torch.as_tensor(nodes, device=self.device)
        self._node_idx = torch.as_tensor(node_idx, device=self.device)
        self.failed_models = torch.zeros(1, dtype=torch.int32, device=self.device)
        #: heavy passes dispatched, one per (dispatch, size tier)
        self.stats["heavy_tiers"] = 0
        self.stats["ingest_host_chunks"] = 0

    def _field_fills(self):
        return {"m_ivar": 0.0, "ivar": self.min_ivar}

    def _make_state_fn(self):
        cfg = self.cfg
        return posterior.GPStateFn(cfg.l, self.max_ivar, self.min_known_ivar,
                                   cfg.free_thresh, cfg.occupied_thresh)

    # ------------------------------------------------------------------ API

    @profiling.traced("la3dm.map.insert")
    def insert_pointcloud(self, cloud: np.ndarray, origin: np.ndarray,
                          ds_resolution: float | None = None,
                          free_resolution: float | None = None,
                          max_range: float | None = None) -> None:
        """Integrate one scan (reference insert_pointcloud, gpoctomap.cpp)."""
        if self._insert_device([cloud], [origin], ds_resolution, free_resolution,
                               max_range):
            return
        t0 = time.perf_counter()
        t = self._scan_model_tables(cloud, origin, ds_resolution, free_resolution,
                                    max_range)
        self.stats["host_s"] += time.perf_counter() - t0
        self._integrate([t] if t is not None else [])

    @profiling.traced("la3dm.map.insert")
    def insert_pointclouds(self, clouds, origins, ds_resolution=None,
                           free_resolution=None, max_range=None) -> None:
        """Integrate a scan sequence, ≤ SCAN_BATCH scans per dispatch (one
        heavy pass per size tier, usually one, then one light pass per scan).
        Scan preprocessing runs in a thread pool while earlier dispatches run
        on the device (see models/bgk.py::insert_pointclouds)."""
        if self._insert_device(clouds, origins, ds_resolution, free_resolution,
                               max_range):
            return
        with ThreadPoolExecutor(max_workers=min(8, max(len(clouds), 1))) as ex:
            futures = [ex.submit(self._scan_model_tables, c, o, ds_resolution,
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
        """Integrate pre-labeled training points (+1 occupied, −1 free)."""
        t = self._model_tables(np.asarray(points, np.float32),
                               np.asarray(labels, np.float32))
        self._integrate([t] if t is not None else [])

    # ------------------------------------------------------------- internals

    def _scan_model_tables(self, cloud, origin, ds_resolution, free_resolution,
                           max_range):
        """Scan → model tables through the native library (None if empty)."""
        cfg = self.cfg
        td = native.bgk_training_data(
            cloud, origin,
            cfg.ds_resolution if ds_resolution is None else ds_resolution,
            cfg.free_resolution if free_resolution is None else free_resolution,
            cfg.max_range if max_range is None else max_range,
            free_label=-1.0)  # gpoctomap.cpp:399
        if len(td.points) == 0:
            return None
        return self._model_tables(td.points, td.labels)

    def _model_tables(self, points: np.ndarray, labels: np.ndarray):
        """One scan → (sorted points/labels, per-model segments, test-block
        coords, per-model target rows), or None without models."""
        nt = native.scan_bucket_tables(points, labels, self.block_size,
                                       self._neighbor_offsets)
        if len(nt["model_starts"]) == 0:
            return None
        return {"pts": nt["entries"], "lab": nt["labels"],
                "starts": nt["model_starts"].astype(np.int64),
                "counts": nt["model_counts"].astype(np.int64),
                "nb_t": nt["nb_t"], "test_coords": nt["test_coords"]}

    def _integrate(self, tables: list) -> None:
        """Integrate K ≤ SCAN_BATCH scans' model tables in one dispatch."""
        if not tables:
            return
        if len(tables) > _SCAN_BATCH:
            for i in range(0, len(tables), _SCAN_BATCH):
                self._integrate(tables[i:i + _SCAN_BATCH])
            return
        t_host0 = time.perf_counter()
        G = self.num_slots
        Vall = self._all_nodes.shape[0]
        parts = {k: [] for k in ("pts", "lab", "st", "ct", "nb", "slots", "ctr", "coords")}
        scan_start, scan_count = [], []
        pt_off = blk_off = 0
        gen0 = self.pool.generation
        for t in tables:
            # each test block's training-point total over the G models it
            # reads weights the sharded pool's placement
            w = np.zeros(len(t["test_coords"]), np.float64)
            np.add.at(w, t["nb_t"].reshape(-1), np.repeat(t["counts"], t["nb_t"].shape[1]))
            slots = self.pool.ensure(t["test_coords"], weights=w)
            parts["pts"].append(t["pts"])
            parts["lab"].append(t["lab"])
            parts["st"].append(t["starts"] + pt_off)
            parts["ct"].append(t["counts"])
            parts["nb"].append(t["nb_t"] + blk_off)
            parts["slots"].append(slots)
            parts["ctr"].append(self.block_centers(t["test_coords"]))
            parts["coords"].append(t["test_coords"])
            scan_start.append(blk_off)
            scan_count.append(len(slots))
            pt_off += len(t["pts"])
            blk_off += len(slots)
            self.stats["kernel_evals"] += int(
                (t["counts"] ** 2).sum() + t["counts"].sum() * G * Vall)
            self.stats["scans"] += 1
        profiling.count("scans", len(tables))
        profiling.count("dispatches")

        cat = {k: np.concatenate(v) for k, v in parts.items()}
        if self.pool.generation != gen0:
            # a sharded pool re-laid out its slots while later tables were
            # ensured: re-resolve the whole batch
            cat["slots"] = self.pool.lookup(cat["coords"])
        counts = cat["ct"]
        self._count_models(counts)
        dev = self._to_device
        pts, lab = dev(cat["pts"].astype(np.float32)), dev(cat["lab"].astype(np.float32))
        self.stats["host_s"] += time.perf_counter() - t_host0
        self._gp_step(pts, lab, cat["st"], counts, cat["nb"], counts, cat["slots"],
                      cat["ctr"], scan_start, scan_count)

    def _dispatch_ingest_chunk(self, tabs, ucount, slots, centers, scan_start,
                               scan_count) -> None:
        """Device tables of one dispatch → one K4 per size tier (the entry
        blocks are the models, on absolute points, predicting at the test
        blocks' centres), then K5 per scan."""
        G, Vall = self.num_slots, self._all_nodes.shape[0]
        counts = ucount.astype(np.int64)
        self.stats["kernel_evals"] += int((counts ** 2).sum() + counts.sum() * G * Vall)
        self._count_models(counts)
        self._gp_step(tabs["ent"], tabs["lab"], tabs["ustart"], tabs["ucount"],
                      tabs["nb_row"], counts, slots, centers, scan_start, scan_count)

    def _count_models(self, counts: np.ndarray) -> None:
        """A dispatch's models, of host ``counts`` points each: its K4 size
        tiers in ``stats["heavy_tiers"]``, and while a profiler records the
        counters ``gp_models``, ``gp_model_points`` (Σ counts),
        ``gp_overflow_models`` (over ``gp_heavy.BASE_MAX_C`` points) and
        ``gp_tier_launches`` (the size tiers)."""
        tiers = len(_size_tiers(counts))
        self.stats["heavy_tiers"] += tiers
        profiling.count("gp_models", len(counts))
        profiling.count("gp_model_points", int(counts.sum()))
        profiling.count("gp_overflow_models", int((counts > gp_heavy.BASE_MAX_C).sum()))
        profiling.count("gp_tier_launches", tiers)

    @profiling.traced("la3dm.heavy.launch")
    def _gp_step(self, pts, lab, starts, counts, nb, host_counts, slots, centers,
                 scan_start, scan_count, rows: slice = slice(None),
                 counted: np.ndarray | None = None) -> None:
        """K4 once per size tier of the models, then K5 once per scan, on the
        pool rows ``rows``, which ``slots`` address.  The models' ``starts``,
        ``counts`` and ``nb`` [M, G] rows are host arrays or tensors on the
        device, ``host_counts`` the counts on the host; ``slots`` [T] and
        ``centers`` [T, 3] host arrays or tensors on the device.  Models
        outside the host mask ``counted`` (None: every model) add their
        failed factorisations to a scratch counter, not to
        ``failed_models``: a sharded map counts them where it counts them
        once."""
        t0 = time.perf_counter()
        cfg = self.cfg
        dev = self._to_device

        def tier(sel):
            if torch.is_tensor(starts):
                return (*_gp_tier_gather(starts, counts, nb, dev(sel)), host_counts[sel])
            return (dev(starts[sel].astype(np.int32)), dev(counts[sel].astype(np.int32)),
                    dev(nb[sel].astype(np.int32)), host_counts[sel])

        tiers, uncounted = [], []
        for sel in _size_tiers(host_counts):
            parts = ((sel, tiers),) if counted is None else \
                ((sel[counted[sel]], tiers), (sel[~counted[sel]], uncounted))
            for s, out in parts:
                if len(s):
                    out.append(tier(s))
        args = (self.pool.fields["m_ivar"][rows], self.pool.fields["ivar"][rows],
                self.pool.touched[rows], self.pool.eff_level[rows], self._all_nodes,
                self._node_idx, pts, lab, tiers, dev(_host_typed(slots, np.int32)),
                dev(_host_typed(centers, np.float32)), scan_start, scan_count,
                self.failed_models)
        statics = dict(G=self.num_slots, sf2=cfg.sf2, ell=cfg.ell, noise=cfg.noise,
                       min_known_ivar=self.min_known_ivar, max_ivar=self.max_ivar,
                       n=self.n, max_level=cfg.block_depth - 1,
                       state_fn=self._state_fn, do_prune=cfg.block_depth > 1)
        if uncounted:
            statics["uncounted"] = uncounted
        self.stats["host_s"] += time.perf_counter() - t0
        if getattr(self, "_capture_step_args", False):
            # the step updates the pool in place: keep copies of its inputs
            self._last_step_call = (
                tuple(a.clone() if torch.is_tensor(a) else list(a) for a in args),
                statics)
        _gp_seq_step(*args, **statics)

    def _posterior(self, fields: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        cfg = self.cfg
        mi, iv = fields["m_ivar"], fields["ivar"]
        with np.errstate(over="ignore", divide="ignore"):
            prob = 1.0 / (1.0 + np.exp(-cfg.l * mi / self.max_ivar))
            var = 1.0 / iv
        st = np.where(prob > cfg.occupied_thresh, posterior.OCCUPIED,
                      np.where(prob < cfg.free_thresh, posterior.FREE,
                               posterior.UNKNOWN))
        st = np.where(iv < self.min_known_ivar, posterior.UNKNOWN, st)
        st = np.where(fields["touched"], st, posterior.UNKNOWN).astype(np.int8)
        return {"prob": prob, "var": var, "state": st,
                "m_ivar": np.asarray(mi), "ivar": np.asarray(iv)}
