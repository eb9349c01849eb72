"""Offline mapping pipelines — the reference's static/server executables.

The port of ``la3dm_tpu/pipeline.py``.  ``run_static`` mirrors
``{method}_static_node`` (e.g. ``src/bgkoctomap/bgkoctomap_static_node.cpp:
86-140``): read ``dir/prefix_i.pcd`` for i=1..scan_num with the origin from
the PCD VIEWPOINT, integrate each scan, log wall-clock, then export
occupied/free leaves with the reference's display conventions.

The static nodes pass ``resolution`` — not the config's ds_resolution — as
the downsampling leaf (bgkoctomap_static_node.cpp:95); ``run_static``
reproduces that.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np

from la3dm_tpu_torch.geometry.preprocess import voxel_downsample
from la3dm_tpu_torch.io.pcd import load_pcd
from la3dm_tpu_torch.io.rosbag import quat_angle
from la3dm_tpu_torch.kernels import ingest_voxel_grid
from la3dm_tpu_torch.models.base import OccupancyMapBase, State
from la3dm_tpu_torch.models.bgk import BGKOctoMap
from la3dm_tpu_torch.models.bgkl import BGKLOctoMap
from la3dm_tpu_torch.models.bgklv import BGKLVOctoMap
from la3dm_tpu_torch.models.gp import GPOctoMap
from la3dm_tpu_torch.utils import profiling
from la3dm_tpu_torch.utils.config import DatasetConfig, MapConfig

MAP_CLASSES = {
    "bgk": BGKOctoMap,
    "bgkl": BGKLOctoMap,
    "bgklv": BGKLVOctoMap,
    "gp": GPOctoMap,
}


def build_map(cfg: MapConfig, device=None) -> OccupancyMapBase:
    """A map of ``cfg.method`` on ``device`` (CUDA unless named)."""
    if cfg.method not in MAP_CLASSES:
        raise NotImplementedError(
            f"method {cfg.method!r} is not ported yet (ROADMAP queue 1)")
    return MAP_CLASSES[cfg.method](cfg, device=device)


@dataclasses.dataclass
class StaticRunResult:
    map: OccupancyMapBase
    per_scan_seconds: list
    total_seconds: float

    @property
    def scans_per_second(self) -> float:
        return len(self.per_scan_seconds) / max(self.total_seconds, 1e-12)


def run_static(cfg: MapConfig, ds: DatasetConfig,
               progress: Optional[Callable[[int, float], None]] = None,
               block_per_scan: bool = False, map_obj=None,
               batch_scans: bool = True, device=None) -> StaticRunResult:
    """Run the offline scan-sequence demo; returns the map + timings.

    Unless per-scan observation is requested, the sequence is preprocessed
    in a thread pool and integrated ≤ SCAN_BATCH scans per dispatch.
    Otherwise the device work stays asynchronous between scans and only the
    final state is synchronised.  ``total_seconds`` is end-to-end wall clock.
    """
    m = map_obj if map_obj is not None else build_map(cfg, device)
    per_scan = []
    t0 = time.perf_counter()
    batched = batch_scans and not block_per_scan and progress is None
    if batched:
        clouds, origins = [], []
        for i in range(1, ds.scan_num + 1):
            cloud, origin = load_pcd(os.path.join(ds.dir, f"{ds.prefix}_{i}.pcd"))
            clouds.append(cloud)
            origins.append(origin)
        # static nodes pass `resolution` as ds_resolution (static_node.cpp:95)
        m.insert_pointclouds(clouds, origins, ds_resolution=cfg.resolution,
                             free_resolution=cfg.free_resolution,
                             max_range=ds.max_range)
    else:
        for i in range(1, ds.scan_num + 1):
            cloud, origin = load_pcd(os.path.join(ds.dir, f"{ds.prefix}_{i}.pcd"))
            t1 = time.perf_counter()
            m.insert_pointcloud(cloud, origin, ds_resolution=cfg.resolution,
                                free_resolution=cfg.free_resolution,
                                max_range=ds.max_range)
            if block_per_scan:
                m.synchronize()
            dt = time.perf_counter() - t1
            per_scan.append(dt)
            if progress:
                progress(i, dt)
    m.synchronize()
    total = time.perf_counter() - t0
    if batched:
        per_scan = [total / max(ds.scan_num, 1)] * ds.scan_num
    return StaticRunResult(map=m, per_scan_seconds=per_scan, total_seconds=total)


class OnlineIntegrator:
    """The reference server's cloudHandler policy
    (``src/bgkoctomap/bgkoctomap_server.cpp``):

    * motion gate — integrate only if the sensor moved > 0.1 m or rotated
      > 0.2 rad since the last *integrated* cloud (:17-20, :60);
    * pre-downsample the cloud with a ds_resolution voxel grid before
      ``insert_pointcloud`` (:70-82), where the map class's
      ``SERVER_DOWNSAMPLE`` says so (not BGKLV).

    Where the map will ingest the cloud on the card (a CUDA map with
    device ingest on and a config that ``device_ingest.beam_slots``
    bounds), the voxel grid runs there too (K7v,
    ``kernels/ingest_voxel_grid.py``: the same bits as
    ``preprocess.voxel_downsample``) and its centroids go to
    ``insert_pointcloud`` as a tensor on the card, less the cells of points
    that are not finite or lie past K7v's window, whose centroids device
    ingest would drop by range; every other map takes numpy's.  The whole
    of it is the span ``la3dm.server.downsample``; the counters
    ``server_ds_card`` and ``server_ds_host`` count the clouds each path
    took.
    """

    POS_GATE = 0.1   # m   (server.cpp:17)
    ROT_GATE = 0.2   # rad (server.cpp:18)

    def __init__(self, m: OccupancyMapBase):
        self.map = m
        self._last_pos = None
        self._last_quat = None
        self.n_integrated = 0
        self.n_skipped = 0

    def offer(self, cloud: np.ndarray, origin: np.ndarray,
              quat: Optional[np.ndarray] = None) -> bool:
        """Integrate the cloud unless the motion gate rejects it.

        Returns True if integrated.  ``quat`` is the sensor orientation
        (xyzw); None disables the rotation check for that cloud.
        """
        origin = np.asarray(origin, np.float32).reshape(3)
        if self._last_pos is not None:
            moved = float(np.linalg.norm(origin - self._last_pos)) > self.POS_GATE
            rotated = (quat is not None and self._last_quat is not None
                       and quat_angle(quat, self._last_quat) > self.ROT_GATE)
            if not (moved or rotated):
                self.n_skipped += 1
                return False
        self._last_pos, self._last_quat = origin, quat
        if self.map.SERVER_DOWNSAMPLE:
            with profiling.span("la3dm.server.downsample"):
                cloud = self._downsample(cloud, origin)
        self.map.insert_pointcloud(cloud, origin)
        self.n_integrated += 1
        return True

    def _downsample(self, cloud, origin):
        """The server's voxel grid of ``cloud``: on the card where the map
        ingests there (class docstring), else numpy's."""
        m, leaf = self.map, self.map.cfg.ds_resolution
        if not m._ingests_on_card():
            profiling.count("server_ds_host")
            return voxel_downsample(cloud, leaf)
        # K7v leaves out the cells past its window, which device ingest
        # drops by range where the window covers it
        assert ingest_voxel_grid.covers(leaf, m.cfg.max_range)
        profiling.count("server_ds_card")
        return ingest_voxel_grid.voxel_grid(
            m._to_device(np.asarray(cloud, np.float32).reshape(-1, 3)), leaf, origin)


def frontier_leaves(m: OccupancyMapBase, var_min: float, prob_max: float,
                    z_min: float, z_max: float) -> dict:
    """Frontier query: leaves with high posterior variance and low occupancy
    probability inside a z band (the reference's commented-out frontier
    demo, ``bgkloctomap_static_node.cpp:102-115``)."""
    leaves = m.leaves(expand_pruned=True)
    sel = ((leaves["var"] > var_min) & (leaves["prob"] < prob_max)
           & (leaves["z"] > z_min) & (leaves["z"] < z_max))
    return {k: v[sel] for k, v in leaves.items()}


def export_leaves(m: OccupancyMapBase, original_size: bool = False,
                  occupied_z_max: float | None = None) -> dict:
    """Occupied + free leaf sets with the static nodes' display semantics,
    expanding pruned leaves to base resolution unless original_size
    (static_node.cpp:111-136).  ``occupied_z_max`` hides occupied voxels
    above that height (the LV static node's display cutoff)."""
    leaves = m.leaves(expand_pruned=not original_size)
    occ_sel = leaves["state"] == int(State.OCCUPIED)
    if occupied_z_max is not None:
        occ_sel &= leaves["z"] <= occupied_z_max
    occ = {k: v[occ_sel] for k, v in leaves.items()}
    free = {k: v[leaves["state"] == int(State.FREE)] for k, v in leaves.items()}
    return {"occupied": occ, "free": free, "all": leaves}
