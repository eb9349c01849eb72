"""BGKLOctoMap — BGK with free-space line-segment training data, on PyTorch
and hand-written CUDA kernels.

The port of ``la3dm_tpu/models/bgkl.py``.  Reference delta from BGK
(``src/bgkloctomap/bgkloctomap.cpp``): training data is (segment, label);
free rays are deduplicated per block — a beam contributes one segment to a
block's model iff ≥ 1 of its proxy samples lies in the block
(``bgkloctomap.cpp:145-172``); occupied hits are degenerate segments
(:153-159); the update gate is k̄ > 0.001 (:231).

The engine is BGK's (models/bgk.py) with segment entries [N,6]: on the
host path the native ``bgkl_training_data`` + ``bgkl_scan_tables`` build the
bucket tables and K1 runs its segment branch; with device ingest
``geometry/device_ingest.py::ingest_batch_bgkl`` (K7a, K7b, K7d, K7c) builds
the tables and K1′ runs its segment branch; K2 applies the 0.001 gate.
"""

from __future__ import annotations

import numpy as np

from la3dm_tpu_torch.geometry import blocks as geo, native, preprocess
from la3dm_tpu_torch.models import bucketing
from la3dm_tpu_torch.models.bgk import BGKOctoMap


def segment_block_entries(td: preprocess.SegmentTrainingData,
                          block_size: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten per-block training lists: (block coord, segment [6], label).

    Hits become degenerate segments in their own blocks; each ray is entered
    once per block holding ≥ 1 of its samples (per-block dedup).  The numpy
    form of the native ``bgkl_scan_tables``' entry lists.
    """
    h_coords, h_idx = geo.point_block_memberships(td.hits, block_size)
    h_entries = np.concatenate([td.hits[h_idx], td.hits[h_idx]], axis=1).astype(np.float32)

    s_coords, s_idx = geo.point_block_memberships(td.samples, block_size)
    s_keys = geo.pack_key(s_coords)
    s_rays = td.sample_ray[s_idx]
    # dedup (block, ray) pairs by a lexsort
    order = np.lexsort((s_rays, s_keys))
    sk, sr = s_keys[order], s_rays[order]
    if len(sk):
        keep = np.empty(len(sk), bool)
        keep[0] = True
        keep[1:] = (sk[1:] != sk[:-1]) | (sr[1:] != sr[:-1])
        sk, sr = sk[keep], sr[keep]
    r_coords = geo.unpack_key(sk)
    r_entries = td.rays[sr].astype(np.float32)

    coords = np.concatenate([h_coords, r_coords], axis=0)
    entries = np.concatenate([h_entries, r_entries], axis=0)
    labels = np.concatenate([np.ones(len(h_coords), np.float32),
                             np.zeros(len(r_coords), np.float32)])
    return coords, entries, labels


class BGKLOctoMap(BGKOctoMap):
    """BGKL occupancy map: BGK's engine on segment entries, gate 0.001."""

    SEGMENTS = True
    GATE = 0.001  # bgkloctomap.cpp:231

    def _scan_tables(self, cloud, origin, ds_resolution, free_resolution,
                     max_range) -> bucketing.BucketTables | None:
        """Scan → segment bucket tables through the native library (None if
        empty)."""
        cfg = self.cfg
        ds = cfg.ds_resolution if ds_resolution is None else ds_resolution
        fr = cfg.free_resolution if free_resolution is None else free_resolution
        mr = cfg.max_range if max_range is None else max_range
        td = native.bgkl_training_data(cloud, origin, ds, fr, mr)
        if len(td.hits) == 0 and len(td.rays) == 0:
            return None
        nt = native.bgkl_scan_tables(td.hits, td.rays, td.samples, td.sample_ray,
                                     self.block_size, self._neighbor_offsets)
        if len(nt["test_coords"]) == 0:
            return None
        return bucketing.BucketTables(
            test_coords=nt["test_coords"], entries=nt["entries"], labels=nt["labels"],
            starts=nt["starts"], counts=nt["counts"],
            max_total=int(nt["counts"].sum(axis=1).max()))

    # The reference declares insert_training_data for BGKL but never
    # implemented it (bgkloctomap.h:89); the JAX package inserts segments:
    def insert_training_data(self, segments: np.ndarray, labels: np.ndarray) -> None:
        """Insert raw (segment [N,6], label) rows; each segment is keyed by
        its start point's block (``bgkl.py:95-102`` of the JAX package)."""
        segments = np.asarray(segments, np.float32)
        coords = geo.point_to_block_coord(segments[:, :3], self.block_size)
        t = bucketing.bucket_tables(coords, segments, np.asarray(labels, np.float32),
                                    self._neighbor_offsets)
        self._integrate([t] if len(t.test_coords) else [])
