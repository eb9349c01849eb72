"""Scan-local packed keys of the device ingest (K7a, K7b, K7c), as plain torch
and numpy; the CUDA twin is ``csrc/ingest_keys.cuh``.

A key is ``scan << 48 | fz << 32 | fy << 16 | fx``: each field a cell (or
block) coordinate minus the scan's anchor plus 32768, clamped to 16 bits.
Invalid rows carry :data:`SENT`, which sorts after every key.  Sorting keys
orders rows by scan, then z, y, x — the JAX package's z-major order
(``la3dm_tpu/geometry/device_ingest.py`` packs 10 bits an axis relative to
each scan's minimum instead; the order is the same, since the device path
only runs where the 1024-cell windows hold a scan's reach).  The anchor is a
cell near the scan's origin, so every field of a reachable point stays far
from the clamp.
"""

from __future__ import annotations

import numpy as np
import torch

#: sentinel key: sorts after every valid key
SENT = int(np.iinfo(np.int64).max)
FIELD_BIAS = 32768


def pack(scan: torch.Tensor, ijk: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Keys [N] int64 of coordinates ``ijk`` [N,3] in scans ``scan`` [N]
    (anchors [K,3] int32)."""
    s = scan.long()
    f = torch.clamp(ijk.long() - anchors.long()[s] + FIELD_BIAS, 0, 0xFFFF)
    return (s << 48) | (f[:, 2] << 32) | (f[:, 1] << 16) | f[:, 0]


def unpack(keys: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Coordinates [N,3] int64 of valid keys [N]."""
    s = keys >> 48
    f = torch.stack([keys & 0xFFFF, (keys >> 16) & 0xFFFF, (keys >> 32) & 0xFFFF], dim=-1)
    return f - FIELD_BIAS + anchors.long()[s]


def unpack_np(keys: np.ndarray, anchors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of :func:`unpack`: (scan [N], coordinates [N,3]) int64."""
    k = np.asarray(keys, np.int64)
    s = k >> 48
    f = np.stack([k & 0xFFFF, (k >> 16) & 0xFFFF, (k >> 32) & 0xFFFF], axis=-1)
    return s, f - FIELD_BIAS + np.asarray(anchors, np.int64)[s]


def pack_offsets(offsets: np.ndarray) -> np.ndarray:
    """Neighbour offsets [G,3] → key deltas [G] int64 (valid while no field
    leaves its 16 bits, which the anchor's margin guarantees)."""
    o = np.asarray(offsets, np.int64)
    return (o[:, 2] << 32) + (o[:, 1] << 16) + o[:, 0]
