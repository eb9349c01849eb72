"""OctoMap ``.bt`` (binary tree) reader — the bundled ground-truth maps.

The reference ships ``data/*/map.bt`` (and ``sim_structured_octomap.csv``)
as evaluation artifacts that no code in the repo reads (SURVEY.md §6).
This reader decodes the standard OctoMap binary format: an ASCII header
(``id OcTree``, ``size N``, ``res R``, ``data``) followed by a depth-first
bitstream of 2 bytes per inner node — 2 bits per child:

    0b00  no child          0b01  free leaf
    0b10  occupied leaf     0b11  inner child (recurse)

(Label orientation pinned against the bundled
``sim_structured_octomap.csv`` — the same map's per-leaf occupancy
probabilities: the decoded centers match its 138,477 rows 1:1 and the
binary labels equal prob > 0.5 on every leaf; tests/test_eval.py.)

(``octomap::OcTree::readBinaryData``; child i offsets: x from bit 0,
y from bit 1, z from bit 2 of i.)  Returns every leaf's center, size and
occupancy label, which `cli eval` scores maps against.

(The port's own copy of ``la3dm_tpu/io/octomap_bt.py``.  ``write_bt`` finds
every leaf's path at once in numpy, where the JAX package's builds the tree
node by node in Python, and writes the same bytes, its header comment
included.)
"""

from __future__ import annotations

import numpy as np

_MAX_DEPTH = 16


def read_bt(path: str) -> dict:
    """Parse a .bt file → dict(centers [L,3], sizes [L], occupied [L] bool)."""
    with open(path, "rb") as f:
        raw = f.read()
    # ASCII header up to the "data\n" line
    off = 0
    res = None
    size = None
    tree_id = None
    while True:
        nl = raw.index(b"\n", off)
        line = raw[off:nl].decode("ascii", "replace").strip()
        off = nl + 1
        if line.startswith("#") or not line:
            continue
        k, _, v = line.partition(" ")
        if k == "id":
            tree_id = v
        elif k == "size":
            size = int(v)
        elif k == "res":
            res = float(v)
        elif k == "data":
            break
    # only the plain OcTree .bt 2-bit bitstream is implemented; a ColorOcTree
    # (.ot payload: floats + RGB per node) would silently misparse, so reject
    if tree_id != "OcTree":
        raise ValueError(f"unsupported octomap id {tree_id!r} (only 'OcTree' "
                         f".bt bitstreams are implemented)")
    stream = np.frombuffer(raw, dtype=np.uint8, offset=off)

    centers: list[tuple[float, float, float]] = []
    sizes: list[float] = []
    occ: list[bool] = []

    # iterative DFS: stack of (cx, cy, cz, node_size); stream is laid out in
    # the same order octomap writes it (children 0..7 depth-first)
    root_size = res * (1 << _MAX_DEPTH)
    pos = 0

    def read_node(cx, cy, cz, s):
        nonlocal pos
        b1 = int(stream[pos])
        b2 = int(stream[pos + 1])
        pos += 2
        bits = b1 | (b2 << 8)
        q = s / 4.0
        for i in range(8):
            code = (bits >> (2 * i)) & 3
            if code == 0:
                continue
            dx = q if (i & 1) else -q
            dy = q if (i & 2) else -q
            dz = q if (i & 4) else -q
            x, y, z = cx + dx, cy + dy, cz + dz
            if code == 3:
                read_node(x, y, z, s / 2.0)
            else:
                centers.append((x, y, z))
                sizes.append(s / 2.0)
                occ.append(code == 2)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(10000)
    try:
        read_node(0.0, 0.0, 0.0, root_size)
    finally:
        sys.setrecursionlimit(old_limit)
    return {
        "centers": np.asarray(centers, np.float64),
        "sizes": np.asarray(sizes, np.float64),
        "occupied": np.asarray(occ, bool),
        "resolution": res,
        "size": size,
    }


def write_bt(path: str, centers: np.ndarray, sizes: np.ndarray,
             occupied: np.ndarray, resolution: float) -> None:
    """Write leaves as a standard OctoMap ``.bt`` file (inverse of read_bt).

    The output opens in the OctoMap ecosystem's own tools (octovis,
    octomap_server) — the reference's evaluation artifacts
    (``data/*/map.bt``) are this format.  Unknown space is simply absent
    (code 0b00), exactly as OcTree::writeBinary leaves it.

    centers [L,3] must lie on the octomap grid for ``resolution`` (odd
    multiples of size/2 per axis); sizes [L] must be resolution·2^k.
    """
    centers = np.asarray(centers, np.float64)
    sizes = np.asarray(sizes, np.float64)
    occupied = np.asarray(occupied, bool)
    root_size = resolution * (1 << _MAX_DEPTH)

    # depth of each leaf: root_size / 2^d == size
    depths = np.round(np.log2(root_size / np.maximum(sizes, 1e-300))).astype(int)
    if len(depths) and (depths.min() < 1 or depths.max() > _MAX_DEPTH):
        raise ValueError("leaf sizes out of range for a depth-16 octomap")

    # each leaf's path from the root: its child index at every level, found
    # by center comparison (the exact inverse of read_node's ±q child-center
    # arithmetic, in the same f64 operations), all leaves at once
    L = len(depths)
    digits = np.zeros((L, _MAX_DEPTH), np.int64)
    c = np.zeros((L, 3))
    s = root_size
    for level in range(_MAX_DEPTH):
        live = depths > level
        i = (centers > c).astype(np.int64) @ np.array([1, 2, 4])
        q = s / 4.0
        step = np.where((i[:, None] >> np.arange(3)) & 1 == 1, q, -q)
        c = np.where(live[:, None], c + step, c)
        digits[:, level] = np.where(live, i, 0)
        s /= 2.0

    # a node's key: the child indices of its path as 3-bit digits from the
    # top, then the path's length, so that keys sort depth-first, each node
    # before its children (the order octomap writes them); the root is 0
    tops = np.cumsum(digits << (3 * (_MAX_DEPTH - 1 - np.arange(_MAX_DEPTH))), axis=1)
    lengths = np.arange(1, _MAX_DEPTH + 1)

    def key(length):
        """Keys of each leaf's path prefix of ``length`` [L] (≥ 0)."""
        top = np.take_along_axis(tops, np.maximum(length - 1, 0)[:, None], axis=1)[:, 0]
        return np.where(length > 0, (top << 5) | length, 0)

    inner = np.unique(np.concatenate([
        np.zeros(1, np.int64),
        ((tops << 5) | lengths)[lengths[None] < depths[:, None]]]))
    leaf = key(depths)
    uniq, counts = np.unique(leaf, return_counts=True)
    clash = np.isin(leaf, inner) | (counts[np.searchsorted(uniq, leaf)] > 1)
    if clash.any():
        bad = tuple(centers[np.argmax(clash)])
        raise ValueError(f"duplicate/overlapping leaf, or a leaf above a leaf, at {bad}")

    # each inner node's 16 bits: 2 bits per child (read_bt's codes), the
    # leaves' 1 (free) or 2 (occupied), the inner children's 3
    bits = np.zeros(len(inner), np.int64)
    last = np.take_along_axis(digits, np.maximum(depths - 1, 0)[:, None], axis=1)[:, 0]
    np.add.at(bits, np.searchsorted(inner, key(depths - 1)),
              np.where(occupied, 2, 1) << (2 * last))
    child = inner[1:]
    clen = child & 31
    cshift = 5 + 3 * (_MAX_DEPTH - clen)
    cdigit = (child >> cshift) & 7
    np.add.at(bits, np.searchsorted(inner, child - (cdigit << cshift) - 1), 3 << (2 * cdigit))
    n_nodes = len(inner) + L
    out = bits.astype("<u2").tobytes()

    with open(path, "wb") as f:
        f.write(b"# Octomap OcTree binary file\n")
        f.write(b"# (created by la3dm_tpu write_bt)\n")
        f.write(b"id OcTree\n")
        f.write(f"size {n_nodes}\n".encode())
        f.write(f"res {resolution!r}\n".encode())
        f.write(b"data\n")
        f.write(out)


def write_bt_from_map(path: str, m) -> None:
    """Export a map's classified leaves (OCCUPIED/FREE; UNKNOWN omitted) as
    a .bt at the map's resolution, keeping pruned leaves coarse where the
    global octomap grid allows.

    The map's block octrees are centered on ``k·block_size`` (the reference
    geometry), so a block's coarsest nodes sit half a cell off the global
    power-of-two grid an OcTree nests on; such leaves are split into their
    (aligned) children until every emitted node is grid-representable —
    base-resolution voxels always are.
    """
    from la3dm_tpu_torch.models.posterior import OCCUPIED, FREE

    leaves = m.leaves(expand_pruned=False)
    keep = (leaves["state"] == int(OCCUPIED)) | (leaves["state"] == int(FREE))
    centers = np.stack([leaves["x"][keep], leaves["y"][keep],
                        leaves["z"][keep]], axis=1).astype(np.float64)
    sizes = leaves["size"][keep].astype(np.float64)
    occ = leaves["state"][keep] == int(OCCUPIED)

    res = float(m.cfg.resolution)
    out_c, out_s, out_o = [], [], []
    while len(sizes):
        # aligned ⇔ center/size − ½ is integral per axis (cell [k·s,(k+1)·s))
        frac = centers / sizes[:, None] - 0.5
        ok = (np.abs(frac - np.round(frac)) < 1e-4).all(axis=1)
        ok |= sizes <= res * 1.0001  # base voxels are aligned by construction
        out_c.append(centers[ok])
        out_s.append(sizes[ok])
        out_o.append(occ[ok])
        centers, sizes, occ = centers[~ok], sizes[~ok], occ[~ok]
        if len(sizes):  # split each misaligned leaf into its 8 children
            q = sizes[:, None] / 4.0
            offs = np.array([[sx, sy, sz] for sz in (-1, 1)
                             for sy in (-1, 1) for sx in (-1, 1)], np.float64)
            centers = (centers[:, None, :] + q[..., None] * offs[None]).reshape(-1, 3)
            sizes = np.repeat(sizes / 2.0, 8)
            occ = np.repeat(occ, 8)

    write_bt(path, np.concatenate(out_c), np.concatenate(out_s),
             np.concatenate(out_o), res)


def expand_to_voxels(bt: dict, resolution: float | None = None) -> dict:
    """Expand coarse leaves to base-resolution voxel centers (labels kept).

    Vectorized per leaf-size group (most leaves are already base size)."""
    res = resolution or bt["resolution"]
    ks = np.maximum(np.round(bt["sizes"] / res).astype(np.int64), 1)
    out_c, out_o = [], []
    for k in np.unique(ks):
        sel = ks == k
        centers = bt["centers"][sel]
        occ = bt["occupied"][sel]
        if k == 1:
            out_c.append(centers)
            out_o.append(occ)
            continue
        ax = (np.arange(k) - (k - 1) / 2.0) * res
        gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
        offs = np.stack([gx, gy, gz], -1).reshape(-1, 3)       # [k³,3]
        out_c.append((centers[:, None, :] + offs[None]).reshape(-1, 3))
        out_o.append(np.repeat(occ, len(offs)))
    return {"centers": np.concatenate(out_c), "occupied": np.concatenate(out_o)}
