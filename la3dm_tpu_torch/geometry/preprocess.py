"""Scan → training-data generation for BGK and BGKL (host-side, vectorized
numpy).

The port's copy of the BGK and BGKL parts of
``la3dm_tpu/geometry/preprocess.py``: the reference's ``get_training_data``
(``src/bgkoctomap/bgkoctomap.cpp:383-458``) — voxel-grid downsample of hits,
max-range filter, free-space points sampled along each beam, then a second
downsample of the free cloud; BGK labels free space 0.  BGKL
(``src/bgkloctomap/bgkloctomap.cpp:285-344``) keeps each in-range hit, its
free ray and the ray's backward proxy samples.  The fused native path
(geometry/native.py) gives bit-identical data; this numpy version backs
``OnlineIntegrator``'s server pre-downsample and the tests.  BGKLV's
training data (:class:`SegmentTrainingData`) comes from the native library
only.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def voxel_downsample(points: np.ndarray, leaf: float) -> np.ndarray:
    """Voxel-grid downsample: centroid of points per occupied voxel.

    Matches pcl::VoxelGrid (used at bgkoctomap.cpp:419-431): voxel index =
    floor(p/leaf) per axis, output = per-voxel centroid, ordered by
    (z-major) voxel index.  ``leaf < 0`` is a passthrough.
    """
    if leaf < 0 or len(points) == 0:
        return np.asarray(points, dtype=np.float32)
    pts = np.asarray(points, dtype=np.float32)
    ijk = np.floor(pts * np.float32(1.0 / leaf)).astype(np.int64)
    # PCL orders leaves by flattened index (x fastest, z slowest)
    order = np.lexsort((ijk[:, 0], ijk[:, 1], ijk[:, 2]))
    ijk_s, pts_s = ijk[order], pts[order]
    change = np.any(ijk_s[1:] != ijk_s[:-1], axis=1)
    start = np.concatenate([[0], np.nonzero(change)[0] + 1])
    counts = np.diff(np.concatenate([start, [len(ijk_s)]]))
    sums = np.add.reduceat(pts_s.astype(np.float64), start, axis=0)
    return (sums / counts[:, None]).astype(np.float32)


def beam_free_points(hits: np.ndarray, origin: np.ndarray, free_resolution: float,
                     backward: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Sample free-space points along each origin→hit beam.

    forward (BGK, bgkoctomap.cpp:433-458): d = fr, 2fr, … < l, plus one
    point at l − fr if l > fr.
    backward (BGKL, bgkloctomap.cpp:360-383): d = l − fr, l − 2fr, … > 0.

    Returns (points [M,3], beam_index [M]) with beam_index into ``hits``.
    """
    hits = np.asarray(hits, dtype=np.float32).reshape(-1, 3)
    origin = np.asarray(origin, dtype=np.float32).reshape(3)
    H = len(hits)
    if H == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0,), np.int64)
    diff = hits - origin
    l = np.sqrt((diff.astype(np.float32) ** 2).sum(-1)).astype(np.float32)
    n = diff / l[:, None]
    fr = np.float32(free_resolution)

    Kmax = max(int(np.floor(float(l.max()) / float(fr))) + 1, 1)
    k = np.arange(1, Kmax + 1, dtype=np.float32)[None, :]          # [1,K]
    if backward:
        d = l[:, None] - k * fr                                    # l−fr, l−2fr, …
        mask = d > 0.0
    else:
        d = (k * fr).astype(np.float32) * np.ones((H, 1), np.float32)
        mask = d < l[:, None]
    rows, cols = np.nonzero(mask)
    pts = origin + n[rows] * d[rows, cols][:, None]
    idx = rows.astype(np.int64)
    if backward:
        return pts.astype(np.float32), idx
    # the extra point at l − fr for beams longer than fr (bgkoctomap.cpp:456-457)
    extra = l > fr
    epts = origin + n[extra] * (l[extra] - fr)[:, None]
    pts = np.concatenate([pts, epts.astype(np.float32)])
    idx = np.concatenate([idx, np.nonzero(extra)[0].astype(np.int64)])
    order = np.argsort(idx, kind="stable")
    return pts[order].astype(np.float32), idx[order]


@dataclasses.dataclass
class PointTrainingData:
    """BGK training set: labeled points (hits first, then frees)."""

    points: np.ndarray  # [N,3] f32
    labels: np.ndarray  # [N]   f32 (1 occupied; 0 free)


@dataclasses.dataclass
class SegmentTrainingData:
    """BGKL / BGKLV training set: occupied points + free rays + ray sample points.

    ``samples``/``sample_ray`` are the R-tree proxy points of each ray
    (origin + beam samples); ``hits`` are the occupied endpoints (degenerate
    segments in the reference).
    """

    hits: np.ndarray        # [H,3] f32 occupied endpoints
    rays: np.ndarray        # [R,6] f32 free segments (start,end)
    samples: np.ndarray     # [S,3] f32 free sample points (incl. ray origins)
    sample_ray: np.ndarray  # [S]   int64 ray id per sample
    #: [2,3] (min,max) over hits ∪ samples — the R-tree extent of the
    #: candidate block sweep; None for an empty scan
    bbox: np.ndarray | None = None


def bgk_training_data(cloud: np.ndarray, origin: np.ndarray, ds_resolution: float,
                      free_resolution: float, max_range: float,
                      free_label: float = 0.0) -> PointTrainingData:
    """BGK pipeline (bgkoctomap.cpp:383-417)."""
    origin = np.asarray(origin, dtype=np.float32).reshape(3)
    hits = voxel_downsample(cloud, ds_resolution)
    if len(hits):
        # max-range filter in double precision (bgkoctomap.cpp:394-397)
        d = np.linalg.norm(hits.astype(np.float64) - origin.astype(np.float64), axis=1)
        hits = hits[(max_range <= 0) | (d <= max_range)]
    free_pts, _ = beam_free_points(hits, origin, free_resolution)
    # frees cloud includes the origin once per hit (bgkoctomap.cpp:404)
    origins = np.repeat(origin[None, :], len(hits), axis=0)
    frees = np.concatenate([origins, free_pts], axis=0) if len(hits) else free_pts
    frees = voxel_downsample(frees, ds_resolution)
    points = np.concatenate([hits, frees], axis=0).astype(np.float32)
    labels = np.concatenate(
        [np.ones(len(hits), np.float32), np.full(len(frees), free_label, np.float32)]
    )
    return PointTrainingData(points=points, labels=labels)


def bgkl_training_data(cloud: np.ndarray, origin: np.ndarray, ds_resolution: float,
                       free_resolution: float, max_range: float) -> SegmentTrainingData:
    """BGKL pipeline (bgkloctomap.cpp:285-344).

    Per in-range hit: the hit endpoint (recomputed as origin + n·l in float32,
    :316), a free ray (origin, origin + n·(l−fr)) (:335-338), and the ray's
    proxy samples: the origin (:328) plus backward beam samples (:325).
    """
    origin = np.asarray(origin, dtype=np.float32).reshape(3)
    hits_ds = voxel_downsample(cloud, ds_resolution)
    if len(hits_ds):
        d = np.linalg.norm(hits_ds.astype(np.float64) - origin.astype(np.float64), axis=1)
        hits_ds = hits_ds[(max_range <= 0) | (d <= max_range)]
    diff = hits_ds - origin
    l = np.sqrt((diff ** 2).sum(-1)).astype(np.float32)
    n = diff / np.maximum(l, 1e-30)[:, None]
    occ = (origin + n * l[:, None]).astype(np.float32)

    free_pts, beam_idx = beam_free_points(occ, origin, free_resolution, backward=True)
    ray_ends = (origin + n * (l - np.float32(free_resolution))[:, None]).astype(np.float32)
    rays = np.concatenate([np.repeat(origin[None], len(occ), 0), ray_ends], axis=1)

    samples = np.concatenate([np.repeat(origin[None], len(occ), 0), free_pts], axis=0)
    sample_ray = np.concatenate([np.arange(len(occ), dtype=np.int64), beam_idx])
    return SegmentTrainingData(hits=occ, rays=rays.astype(np.float32),
                               samples=samples.astype(np.float32), sample_ray=sample_ray)
