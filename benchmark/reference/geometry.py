"""Block and octree geometry of the LA3DM map, in numpy: the reference's
own tables, independent of the program under test.

A block of ``block_depth`` levels holds n³ voxels, n = 2^(block_depth−1),
in raster order (x fastest).  Every octree node of a block, from the leaves
to the root, has a centre offset from the block's centre; a voxel whose
leaf was pruned to level L is read and updated at its level-L ancestor.
The offsets follow the upstream ``init_key_loc_map`` (``bgkblock.cpp:7-32``):
each level's children at ±half/2 of their parent, accumulated in double and
rounded to float32 a level at a time, in the child order x ← bit 2, y ← bit
1, z ← bit 0.
"""

from __future__ import annotations

import numpy as np

#: the ExtendedBlock order of the upstream map: self, +x, −x, +y, −y, +z, −z
FACE_OFFSETS = np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                         [0, 0, 1], [0, 0, -1]], dtype=np.int64)


def block_size(resolution: float, block_depth: int) -> float:
    """A block's edge in metres, as the map computes it (in double)."""
    return (1 << (block_depth - 1)) * resolution


def _levels(resolution: float, block_depth: int) -> list[np.ndarray]:
    out = [np.zeros((1, 3), np.float32)]
    for depth in range(block_depth - 1):
        half = float(np.float32(resolution * (2.0 ** (block_depth - depth - 1)) * 0.5))
        prev = out[-1].astype(np.float64)
        nxt = np.zeros((len(prev) * 8, 3), np.float64)
        for i in range(8):
            step = np.array([half * (0.5 if i & 4 else -0.5), half * (0.5 if i & 2 else -0.5),
                             half * (0.5 if i & 1 else -0.5)])
            nxt[i::8] = prev + step
        out.append(nxt.astype(np.float32))
    return out


def node_tables(resolution: float, block_depth: int) -> tuple[np.ndarray, np.ndarray]:
    """(nodes [Vall, 3] f32, node_idx [block_depth, n³] int64): every node's
    centre offset, the leaves in raster order first, then each coarser
    level's nodes in raster order of their groups; node_idx[L, v] is the row
    of voxel v's level-L ancestor."""
    levels = _levels(resolution, block_depth)
    leaves = levels[-1]
    perm = np.arange(len(leaves))
    for axis in (0, 1, 2):                     # raster index → BFS leaf index
        perm = perm[np.argsort(leaves[perm, axis], kind="stable")]
    n = 1 << (block_depth - 1)
    v = np.arange(n ** 3)
    vx, vy, vz = v % n, (v // n) % n, v // (n * n)
    nodes, idx, base = [], [], 0
    for L in range(block_depth):
        m = n >> L
        anc = levels[block_depth - 1 - L][perm >> (3 * L)]       # [n³, 3]
        gid = (vx >> L) + (vy >> L) * m + (vz >> L) * m * m
        first = np.zeros(m ** 3, np.int64)
        seen = np.unique(gid, return_index=True)[1]
        first[gid[seen]] = seen
        nodes.append(anc[first])
        idx.append(gid + base)
        base += m ** 3
    return np.concatenate(nodes).astype(np.float32), np.stack(idx).astype(np.int64)
