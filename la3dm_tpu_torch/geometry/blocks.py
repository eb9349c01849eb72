"""Block-grid geometry: hash keys, voxel rasterization, neighborhoods.

The reference partitions space into blocks of ``2^(depth-1)`` voxels per edge,
centered on integer multiples of ``block_size`` — ``block_to_hash_key`` packs
``int64(x/size + 524288.5)`` per axis into an int64
(``src/bgkoctomap/bgkblock.cpp:73-77``), i.e. each block index is the
*round-half-up nearest integer* of ``center/size``.

Here a block is identified by its integer coordinate triple ``(bx,by,bz)``
(int32); the packed int64 key is only used as a dict key host-side.  Voxels
within a block are stored in raster order ``idx = x + y*n + z*n²`` with x
fastest — matching the reference's ``index_map`` built by three stable sorts
(z-major; ``bgkblock.cpp:34-67``) and ``Block::get_node`` (``bgkblock.cpp:132-135``).
Voxel centers are ``block_center + res*(i - n/2 + 0.5)`` per axis
(``init_key_loc_map``, ``bgkblock.cpp:7-32``).
"""

from __future__ import annotations

import numpy as np

# 6 face neighbors in the reference's ExtendedBlock order: self, +x, -x, +y, -y, +z, -z
# (bgkblock.cpp:114-130: i=0..5 → ex/ey/ez = ±size on axis i//2, + first).
FACE_NEIGHBOR_OFFSETS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [-1, 0, 0],
        [0, 1, 0],
        [0, -1, 0],
        [0, 0, 1],
        [0, 0, -1],
    ],
    dtype=np.int32,
)


def full_neighbor_offsets() -> np.ndarray:
    """27-cell neighborhood for -DPREDICT mode (bgkblock.h:22-26), self first."""
    offs = [[0, 0, 0]]
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if (dx, dy, dz) != (0, 0, 0):
                    offs.append([dx, dy, dz])
    return np.array(offs, dtype=np.int32)


def point_to_block_coord(points: np.ndarray, block_size: float) -> np.ndarray:
    """Map points [N,3] → integer block coords [N,3].

    Matches ``block_to_hash_key`` (bgkblock.cpp:73-77): index =
    floor(p/size + 0.5) in double precision (the +524288.5 bias makes the
    int64 truncation a floor for all in-range coordinates).
    """
    return np.floor(points.astype(np.float64) / float(block_size) + 0.5).astype(np.int64)


def block_center(coords: np.ndarray, block_size: float) -> np.ndarray:
    """Integer block coords [...,3] → world-space centers [...,3] (float32).

    hash_key_to_block computes ``index * Block::size`` in float32
    (bgkblock.cpp:79-83).
    """
    return (coords.astype(np.float64) * np.float32(block_size)).astype(np.float32)


def pack_key(coords: np.ndarray) -> np.ndarray:
    """Pack int block coords [...,3] → int64 scalar keys (20 bits/axis + bias).

    Same packing as the reference BlockHashKey (bgkblock.cpp:73-77).
    """
    c = coords.astype(np.int64) + 524288
    return (c[..., 0] << 40) | (c[..., 1] << 20) | c[..., 2]


def unpack_key(keys: np.ndarray) -> np.ndarray:
    keys = np.asarray(keys, dtype=np.int64)
    return np.stack(
        [
            (keys >> 40) - 524288,
            ((keys >> 20) & 0xFFFFF) - 524288,
            (keys & 0xFFFFF) - 524288,
        ],
        axis=-1,
    ).astype(np.int64)


def node_offsets_by_depth(resolution: float, block_depth: int) -> list[np.ndarray]:
    """Node-center offsets per octree depth, BFS child order, float32-exact.

    Replicates ``init_key_loc_map`` (bgkblock.cpp:7-32) bit-for-bit: at each
    depth the half-size is ``(float)(res · 2^(max_depth−depth−1) · 0.5)`` and
    child centers accumulate ``(float)(parent ± half·0.5)`` (double arithmetic
    rounded to float per step, child bits i&4→x, i&2→y, i&1→z).  Voxel-center
    parity matters because the k̄>0 update gate sits on the sparse kernel's
    clamp boundary.
    """
    out = [np.zeros((1, 3), np.float32)]
    for depth in range(block_depth - 1):
        half = np.float32(resolution * (2.0 ** (block_depth - depth - 1)) * 0.5)
        prev = out[depth].astype(np.float64)
        nxt = np.zeros((len(prev) * 8, 3), np.float64)
        for i in range(8):
            off = np.array([
                float(half) * (0.5 if i & 4 else -0.5),
                float(half) * (0.5 if i & 2 else -0.5),
                float(half) * (0.5 if i & 1 else -0.5),
            ])
            nxt[i::8] = prev + off
        out.append(nxt.astype(np.float32))
    return out


def _leaf_raster_perm(leaf_centers: np.ndarray) -> np.ndarray:
    """Raster index → BFS leaf index, via the reference's three stable sorts
    (x, then y, then z; bgkblock.cpp:44-58)."""
    perm = np.arange(len(leaf_centers))
    for axis in (0, 1, 2):
        perm = perm[np.argsort(leaf_centers[perm, axis], kind="stable")]
    return perm


def voxel_offsets(resolution: float, block_depth: int) -> np.ndarray:
    """Leaf-voxel center offsets from block center, [n³,3] float32, raster order
    (x fastest, z slowest — index_map semantics, bgkblock.cpp:34-67)."""
    levels = node_offsets_by_depth(resolution, block_depth)
    leaves = levels[block_depth - 1]
    return leaves[_leaf_raster_perm(leaves)]


def tile_vox_map(n: int) -> np.ndarray:
    """[tiles_per_block, Vt] int32: raster voxel indices of each 8³ tile
    (the whole block when n < 8), tiles and their voxels both in raster order
    (x fastest).  Flattened, it is the BGKLV tile-major storage order: stored
    column k = pos·Vt + vt holds raster voxel ``tile_vox_map(n).reshape(-1)[k]``
    (la3dm_tpu/models/bgklv.py:276-303)."""
    te = min(8, n)
    tpa = n // te
    t = np.arange(tpa)
    v = np.arange(te)
    tz, ty, tx = np.meshgrid(t, t, t, indexing="ij")
    z, y, x = np.meshgrid(v, v, v, indexing="ij")
    gx = tx.reshape(-1, 1) * te + x.reshape(1, -1)
    gy = ty.reshape(-1, 1) * te + y.reshape(1, -1)
    gz = tz.reshape(-1, 1) * te + z.reshape(1, -1)
    return (gx + gy * n + gz * n * n).astype(np.int32)


def level_offsets(resolution: float, block_depth: int, level: int) -> np.ndarray:
    """Center offsets of each leaf voxel's 2^level-aligned ancestor node.

    ``level=0`` is the leaf itself; used to evaluate kernels at pruned-leaf
    centers (pruned leaves are later scans' update targets in the reference).
    """
    levels = node_offsets_by_depth(resolution, block_depth)
    leaves = levels[block_depth - 1]
    perm = _leaf_raster_perm(leaves)
    anc = levels[block_depth - 1 - level]
    return anc[perm >> (3 * level)]


def all_level_nodes(resolution: float, block_depth: int) -> tuple[np.ndarray, np.ndarray]:
    """Every octree node's center offset + the (level, leaf voxel) → node map.

    Returns:
      nodes: [Vall, 3] f32 — node-center offsets from the block center for
        ALL levels, level 0 (base leaves, raster order) first, then level 1's
        (n/2)³ nodes in group-raster order, ..., up to the block root.
        Vall = Σ_L (n >> L)³.
      node_idx: [L, n³] int32 — node_idx[L, v] is the row in ``nodes`` of
        base voxel v's level-L ancestor (node_idx[0] is the identity).

    Evaluating kernels at all node positions up front makes the hot predict
    pass independent of pruning state: the per-scan update just *selects*
    each voxel's current eff-level node value (the reference updates pruned
    leaves at their coarser node centers, bgkoctomap.cpp:309-336 via the
    leaf iterator).
    """
    n = 1 << (block_depth - 1)
    V = n ** 3
    nodes_parts: list[np.ndarray] = []
    idx_rows: list[np.ndarray] = []
    base_off = 0
    vox = np.arange(V)
    vx, vy, vz = vox % n, (vox // n) % n, vox // (n * n)
    for L in range(block_depth):
        m = n >> L
        # per-level offsets replicated per base voxel (level_offsets) → one
        # row per node, picked via each node's minimum-corner base voxel
        rep = level_offsets(resolution, block_depth, L)  # [V,3]
        gx, gy, gz = vx >> L, vy >> L, vz >> L
        gid = (gx + gy * m + gz * m * m).astype(np.int64)
        first = np.zeros(m ** 3, np.int64)
        # minimum-corner representative: raster order ⇒ first occurrence
        seen_order = np.unique(gid, return_index=True)[1]
        first[gid[seen_order]] = seen_order
        nodes_parts.append(rep[first])
        idx_rows.append((gid + base_off).astype(np.int32))
        base_off += m ** 3
    return (np.concatenate(nodes_parts, axis=0).astype(np.float32),
            np.stack(idx_rows, axis=0))


def point_block_memberships(points: np.ndarray, block_size: float) -> tuple[np.ndarray, np.ndarray]:
    """All (block, point) incidences under the reference's closed-box query.

    The per-scan R-tree stores each training point as a degenerate rect and
    ``get_gp_points_in_bbox`` queries the *closed* block box
    [center−bs/2, center+bs/2] (rtree.h Overlap + bgkoctomap.cpp:497-524), so
    a point exactly on a face plane belongs to both adjacent blocks — sensor
    origins routinely sit on block boundaries.  Bounds are evaluated in
    float32 exactly as the reference computes them.

    Returns (coords [M,3] int64, point_index [M]) with M ≥ N.
    """
    pts = np.asarray(points, dtype=np.float32)
    bs = np.float32(block_size)
    half = np.float32(bs / 2.0)
    base = point_to_block_coord(pts, block_size)  # nearest block per axis
    # per-axis membership of candidate indices base-1, base, base+1
    member = np.zeros((len(pts), 3, 3), dtype=bool)  # [N, axis, cand]
    for c, d in enumerate((-1, 0, 1)):
        cand = base + d
        ctr = (cand.astype(np.float64) * bs).astype(np.float32)
        member[:, :, c] = (ctr - half <= pts) & (pts <= ctr + half)
    coords_list, idx_list = [], []
    for cx in range(3):
        for cy in range(3):
            for cz in range(3):
                m = member[:, 0, cx] & member[:, 1, cy] & member[:, 2, cz]
                if not m.any():
                    continue
                coords_list.append(base[m] + np.array([cx - 1, cy - 1, cz - 1]))
                idx_list.append(np.nonzero(m)[0])
    return np.concatenate(coords_list), np.concatenate(idx_list)


def point_to_voxel_index(points: np.ndarray, centers: np.ndarray, resolution: float, n: int) -> np.ndarray:
    """Points [N,3] + their block centers [N,3] → raster voxel index [N].

    Matches ``Block::get_index`` (bgkblock.cpp:141-149): int cast (trunc) of
    (p-center)/res + n/2, clipped to [0, n-1], then x + y*n + z*n².
    """
    rel = (points - centers) / np.float32(resolution) + n / 2.0
    idx = np.clip(rel.astype(np.int32), 0, n - 1)
    return idx[:, 0] + idx[:, 1] * n + idx[:, 2] * n * n


def rotate_euler(points: np.ndarray, roll: float, pitch: float, yaw: float) -> np.ndarray:
    """Euler rotation with the reference's sequence and rounding.

    ``Vector3::rotate_IP`` (src/common/point3f.cpp:8-30) applies pitch
    (about y), then yaw (about z), then roll (about x), casting to float32
    after each stage; used by pose application in scan ingestion.
    """
    p = np.asarray(points, np.float32).reshape(-1, 3).copy()
    x, z = p[:, 0].astype(np.float64), p[:, 2].astype(np.float64)
    p[:, 0] = (z * np.sin(pitch) + x * np.cos(pitch)).astype(np.float32)
    p[:, 2] = (z * np.cos(pitch) - x * np.sin(pitch)).astype(np.float32)
    x, y = p[:, 0].astype(np.float64), p[:, 1].astype(np.float64)
    p[:, 0] = (x * np.cos(yaw) - y * np.sin(yaw)).astype(np.float32)
    p[:, 1] = (x * np.sin(yaw) + y * np.cos(yaw)).astype(np.float32)
    y, z = p[:, 1].astype(np.float64), p[:, 2].astype(np.float64)
    p[:, 1] = (y * np.cos(roll) - z * np.sin(roll)).astype(np.float32)
    p[:, 2] = (y * np.sin(roll) + z * np.cos(roll)).astype(np.float32)
    return p.reshape(np.asarray(points).shape)
