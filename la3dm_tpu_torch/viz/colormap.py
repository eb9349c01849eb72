"""Marker coloring — the reference's RViz visualization semantics, vectorized.

Reproduces ``MarkerArrayPub`` (include/common/markerarray_pub.h):
* ``heightMapColor`` (:12-73) — HSV ramp with s=v=1 and the even-sextant
  flip ``f = 1−f``.
* occupied voxels: height color with h = (1 − clamp((z−min_z)/(max_z−min_z)))·0.8
  (:116-119).
* free voxels: gray (0.8,0.8,0.8) below p=0.5, else
  heightMapColor(min(2−2p, 0.6)) (:137-144).
* markers are grouped into 10 CUBE_LISTs by depth = log2(size/resolution)
  (:110-113), reproduced by :func:`marker_depth`.

(The port's own copy of ``la3dm_tpu/viz/colormap.py``.)
"""

from __future__ import annotations

import numpy as np


def height_map_color(h: np.ndarray) -> np.ndarray:
    """heightMapColor (markerarray_pub.h:12-73): h (any real) → RGB [..,3]."""
    h = np.asarray(h, dtype=np.float64)
    h = h - np.floor(h)
    h = h * 6.0
    i = np.floor(h).astype(np.int64)
    f = h - i
    f = np.where(i % 2 == 0, 1.0 - f, f)  # even-sextant flip
    m = np.zeros_like(f)      # v*(1-s) with s=1
    n = 1.0 - f               # v*(1-s*f)
    v = np.ones_like(f)
    i6 = np.where(i == 6, 0, i)
    r = np.select([i6 == 0, i6 == 1, i6 == 2, i6 == 3, i6 == 4, i6 == 5], [v, n, m, m, n, v], 1.0)
    g = np.select([i6 == 0, i6 == 1, i6 == 2, i6 == 3, i6 == 4, i6 == 5], [n, v, v, n, m, m], 0.5)
    b = np.select([i6 == 0, i6 == 1, i6 == 2, i6 == 3, i6 == 4, i6 == 5], [m, m, n, v, v, n], 0.5)
    return np.stack([r, g, b], axis=-1)


def occupied_colors(z: np.ndarray, min_z: float, max_z: float) -> np.ndarray:
    """Height coloring for OCCUPIED markers (markerarray_pub.h:116-119)."""
    if not (min_z < max_z):
        return np.broadcast_to([0.0, 0.0, 1.0], (len(np.atleast_1d(z)), 3)).copy()
    t = np.clip((np.asarray(z, np.float64) - min_z) / (max_z - min_z), 0.0, 1.0)
    return height_map_color((1.0 - t) * 0.8)


def free_colors(prob: np.ndarray) -> np.ndarray:
    """Probability coloring for FREE markers (markerarray_pub.h:137-144)."""
    p = np.asarray(prob, dtype=np.float64)
    colored = height_map_color(np.minimum(2.0 - 2.0 * p, 0.6))
    gray = np.broadcast_to([0.8, 0.8, 0.8], colored.shape)
    return np.where((p < 0.5)[..., None], gray, colored)


def marker_depth(size: np.ndarray, resolution: float) -> np.ndarray:
    """CUBE_LIST group id: int(log2(size/resolution)) (markerarray_pub.h:110-113)."""
    size = np.asarray(size, np.float64)
    d = np.zeros(size.shape, np.int64)
    pos = size > 0
    d[pos] = np.log2(size[pos] / resolution).astype(np.int64)
    return d
