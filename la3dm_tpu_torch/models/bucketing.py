"""Host-side bucketing: ragged per-block training sets → padded device tensors.

Replaces the reference's per-scan R-tree (``rtree.Insert``/``Search``,
``bgkoctomap.cpp:240-243``): the R-tree only ever answers "entries in an
axis-aligned box" over the current scan, which block bucketing + the
face-neighbor gather answers exactly (ExtendedBlock semantics,
``bgkblock.cpp:85-101``).

:func:`bucket_tables` produces, for every *test block* (any block whose
extended neighborhood holds ≥1 training entry — the reference's test_blocks,
``bgkoctomap.cpp:253-262``), per-neighbor-slot (start, count) segments into
the block-sorted entry table; the row engines (models/bgk.py) expand these
into fixed-width rows on the host and gather entries on device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from la3dm_tpu_torch.geometry import blocks as geo


@dataclasses.dataclass
class BucketTables:
    """Compact bucketing: sorted entries + per-(test block, slot) segments.

    The row tables (models/bgk.py) index entries through these segments, so
    only a few hundred KB per scan cross to the device, not the padded
    [B,S,D] neighbour-gathered tensor.
    """

    test_coords: np.ndarray   # [B,3] int64
    entries: np.ndarray       # [N,D] f32 sorted by owning block
    labels: np.ndarray        # [N]   f32
    starts: np.ndarray        # [B,G] int32 segment start in entries
    counts: np.ndarray        # [B,G] int32 segment length
    max_total: int            # max over rows of counts.sum(axis=1)


def bucket_tables(entry_coords: np.ndarray, entries: np.ndarray, labels: np.ndarray,
                  neighbor_offsets: np.ndarray) -> BucketTables:
    """Sort entries by block and build the (start,count) neighbor table."""
    order, ukeys, starts, counts = group_by_block(entry_coords)
    entries_s = np.ascontiguousarray(entries[order], dtype=np.float32)
    labels_s = np.ascontiguousarray(labels[order], dtype=np.float32)

    test_coords = test_blocks_for(ukeys, neighbor_offsets)
    B, G = len(test_coords), len(neighbor_offsets)
    nb_keys = geo.pack_key(test_coords[:, None, :] + neighbor_offsets[None, :, :])
    pos = np.searchsorted(ukeys, nb_keys.reshape(-1))
    pos = np.clip(pos, 0, max(len(ukeys) - 1, 0))
    hit = ukeys[pos] == nb_keys.reshape(-1) if len(ukeys) else np.zeros(pos.shape, bool)
    seg_start = np.where(hit, starts[pos], 0).reshape(B, G).astype(np.int32)
    seg_count = np.where(hit, counts[pos], 0).reshape(B, G).astype(np.int32)
    max_total = int(seg_count.sum(axis=1).max()) if B else 0
    return BucketTables(test_coords=test_coords, entries=entries_s, labels=labels_s,
                        starts=seg_start, counts=seg_count, max_total=max_total)


def group_by_block(coords: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sort entries by block key; return (order, unique_keys, starts, counts)."""
    keys = geo.pack_key(coords)
    order = np.argsort(keys, kind="stable")
    ukeys, starts, counts = np.unique(keys[order], return_index=True, return_counts=True)
    return order, ukeys, starts, counts


def test_blocks_for(ukeys: np.ndarray, neighbor_offsets: np.ndarray) -> np.ndarray:
    """Coords of every block whose G-neighborhood intersects the entry blocks."""
    ucoords = geo.unpack_key(ukeys)
    cand = (ucoords[:, None, :] + neighbor_offsets[None, :, :]).reshape(-1, 3)
    return geo.unpack_key(np.unique(geo.pack_key(cand)))
