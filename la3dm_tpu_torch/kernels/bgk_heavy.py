"""K1 — the BGK heavy pass: wrapper, plain version and launch counter.

Replaces the heavy half of ``la3dm_tpu/models/bgk.py::_bgk_seq_step``
(lines 106-138, with ``kernels/math.py::cov_sparse`` — or, for BGKL's
segment entries, ``cov_sparse_segment(lv=False)``, lines 121-122 — and
``kernels/predict.py::_slot_rhs``).  For each row of ≤ W merged neighbour
entries of one test block: the sparse kernel K[Vall, W] between the block's
all-level node centres and the entries (points [N,3], or segments [N,6]:
start, end), masked by the row count, times the one-hot slot RHS [W, 2G],
accumulated into acc[Tp, Vall, 2G] at ``row_block``.

On a CUDA tensor :func:`bgk_heavy` launches the hand-written kernel
(``csrc/bgk_heavy.cu``; points and segments alike: one warp per (test
block, 32 nodes) work unit with exact warp-level culling; no atomics); on a
CPU tensor it runs :func:`bgk_heavy_plain`.  :func:`bgk_heavy_cull` is the
kernel's culling predicate in plain PyTorch.  What bounds the kernel is FP32
arithmetic on the CUDA cores (:data:`FLOP_PER_EVAL` per kernel evaluation,
:data:`FLOP_PER_EVAL_SEGMENT` with segments) on the pairs the culling
keeps; parity keeps it off the tensor cores (see the source note).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from la3dm_tpu_torch.kernels import _build, math as km, predict as kp

#: fixed entry-row width; the kernel loads one row at a time
ROW_W = 64
#: kernel launches since the counter was last reset (one per dispatch)
launches = 0
#: operations per point evaluation (distance, cos, sin, clamp, two
#: accumulations), the count the JAX package's bench uses
FLOP_PER_EVAL = 50
#: per segment evaluation: the point distance's 9 replaced by the
#: point-to-segment distance's 43 (two squared distances 16, c1 5, the
#: projection 2, the midpoint and its square 14, three square roots and
#: three comparisons 6) and the division by ℓ
FLOP_PER_EVAL_SEGMENT = 85
#: r_c: the sparse kernel (``csrc/sparse_kernel.cuh::sparse_kernel_r``,
#: clamped at 0) is exactly 0 for every f32 r ≥ R_CULL — a scan of every
#: f32 value in [1, 2) on the card and on the CPU (tests/test_torch_cull.py,
#: tests/test_torch_cuda.py); above 2 the formula is negative.  At r = 1
#: itself 2π·r rounds below 2π (TWO_PI = float32(2·3.1415926)), so the
#: sine term is already negative; the analytic value is O((1 − r)⁵), and on
#: the CPU the f32 formula rounds to ≤ 0 from r = 0.98376 on.  The kernel
#: skips an entry whose segment (a point entry: the point) lies farther than
#: R_CULL·ℓ from all of a warp's nodes.
R_CULL = 1.0

_INT_ARGS = ("ids", "row_start", "row_count", "row_block")


@functools.lru_cache(maxsize=None)
def node_order(Vall: int, device: str = "cpu") -> torch.Tensor:
    """[Vall] int32 on ``device``: the segment kernel's node order, so that
    its warps, 32 consecutive nodes each, own compact boxes.  For the
    all-level node table of ``geometry/blocks.py::all_level_nodes`` (level
    L's (n >> L)³ nodes in raster order, L = 0, 1, ...), the nodes along a
    Morton curve of their centres (on the half-leaf grid, quantised to
    1024 steps across the block); for any other table, the table's own
    order.  Any permutation gives the same sums."""
    n, total = 1, 1
    while total < Vall:
        n *= 2
        total = sum((n >> L) ** 3 for L in range(n.bit_length()))
    if total != Vall:
        return torch.arange(Vall, dtype=torch.int32, device=device)
    codes = []
    for L in range(n.bit_length()):
        m = n >> L
        i = np.arange(m ** 3)
        code = np.zeros(m ** 3, np.int64)
        for ax, x in enumerate((i % m, (i // m) % m, i // (m * m))):
            c = ((2 * x + 1) << L) - 1                 # centre, in half-leaf units
            q = np.minimum(c * 1024 // max(2 * n - 2, 1), 1023)
            for bit in range(10):
                code |= ((q >> bit) & 1) << (3 * bit + ax)
        codes.append(code)
    order = np.argsort(np.concatenate(codes), kind="stable").astype(np.int32)
    return torch.from_numpy(order).to(device)


def bgk_heavy(entries, labels, ids, gslot, row_block, row_start, row_count,
              centers, all_nodes, *, G: int, sf2: float, ell: float, culled=None):
    """acc [Tp, Vall, 2G] f32: per (test block, node) the slot-grouped
    (ȳ_g | k̄_g).  ``entries`` are points [N,3] or segments [N,6] (start,
    end).  ``row_block`` must be non-decreasing (rows of a block are
    contiguous); a row with count 0 is padding.  ``culled`` (an int64 [1]
    tensor on the card, or None) counts the (warp, entry) pairs the
    kernel's warps skip (:func:`bgk_heavy_cull`)."""
    if entries.device.type == "cpu":
        return bgk_heavy_plain(entries, labels, ids, gslot, row_block, row_start,
                               row_count, centers, all_nodes, G=G, sf2=sf2, ell=ell)
    if entries.device.type != "cuda":
        raise ValueError(f"bgk_heavy: unsupported device {entries.device}")
    global launches
    Tp, Vall = centers.shape[0], all_nodes.shape[0]
    args = dict(entries=entries, labels=labels, ids=ids, gslot=gslot,
                row_block=row_block, row_start=row_start, row_count=row_count,
                centers=centers, all_nodes=all_nodes)
    want = {"entries": torch.float32, "labels": torch.float32,
            "centers": torch.float32, "all_nodes": torch.float32,
            "gslot": torch.int8, "culled": torch.int64,
            **{k: torch.int32 for k in _INT_ARGS}}
    if culled is not None:
        args["culled"] = culled
    for k, x in args.items():
        if x.device != entries.device or x.dtype != want[k] or not x.is_contiguous():
            raise ValueError(f"bgk_heavy: {k} must be a contiguous {want[k]} "
                             f"tensor on {entries.device}")
    if G not in (7, 27):
        raise ValueError(f"bgk_heavy: G={G} (the kernel takes 7 or 27)")
    R = row_block.shape[0]
    D = entries.shape[1] if entries.dim() == 2 else 0
    if (D not in (3, 6) or centers.shape[1:] != (3,)
            or all_nodes.shape[1:] != (3,) or labels.shape[0] != entries.shape[0]
            or gslot.shape[0] != ids.shape[0]
            or row_start.shape[0] != R or row_count.shape[0] != R
            or (culled is not None and culled.shape != (1,))):
        raise ValueError("bgk_heavy: inconsistent shapes")
    acc = torch.empty((Tp, Vall, 2 * G), dtype=torch.float32, device=entries.device)
    if Tp == 0:
        return acc
    block_rows = torch.searchsorted(
        row_block, torch.arange(Tp + 1, dtype=row_block.dtype, device=row_block.device))
    order = node_order(Vall, str(entries.device))
    code = _build.lib().la3dm_bgk_heavy(
        entries.data_ptr(), labels.data_ptr(), ids.data_ptr(), gslot.data_ptr(),
        row_start.data_ptr(), row_count.data_ptr(), block_rows.data_ptr(),
        centers.data_ptr(), all_nodes.data_ptr(), order.data_ptr(),
        culled.data_ptr() if culled is not None else None, Tp, Vall, G, D, float(sf2),
        float(ell), cull_reach(ell), acc.data_ptr(),
        torch.cuda.current_stream(entries.device).cuda_stream)
    _build.check(code, "bgk_heavy")
    launches += 1
    return acc


def cull_reach(ell: float) -> float:
    """The culling reach r_c·ℓ in f32."""
    return float(torch.tensor(R_CULL * float(torch.tensor(ell, dtype=torch.float32)),
                              dtype=torch.float32))


def bgk_heavy_cull(entries, ids, row_block, row_start, row_count, centers, all_nodes,
                   *, ell: float, chunk: int = 256):
    """The kernel's culling predicate in plain PyTorch: [R, ⌈Vall/32⌉, W]
    bool over (row, warp, entry), True where the warp's nodes
    ``node_order(Vall)[32·w : 32·w + 32]`` in the row's block skip the
    entry, False for padding entries.  The warp's box is taken over the f32
    values all_nodes[v] + centers[t] of its live nodes and padded by r_c·ℓ
    and the margin m = 1e-4·(1 + |x|) (``csrc/cull.cuh``).

    Segments: the segment misses the box, so every node lies farther than
    r_c·ℓ from it and the kernel's value is exactly 0 (:data:`R_CULL`).
    Points (in world coordinates): the point lies outside the box, on some
    axis at least (ℓ + m)(1 − 2⁻²³) − 2⁻²⁴·B from every node x of the warp
    (B = max |box| ≥ |x|).  The kernel evaluates ``sqrt(dist2(x/ℓ −
    e/ℓ))``; the two divisions lose at most 2⁻²⁴·(2|x| + |x − e|)/ℓ, so the
    scaled difference on that axis is ≥ 1 whenever m·(1 − 2⁻²²) ≥
    2⁻²²·(ℓ + B), which m meets for every B (it grows with |x|) and every ℓ
    below 200 m.  Rounding is monotone and 1 exact, so dx² ≥ 1, d2 ≥ 1,
    r = √d2 ≥ 1 and the kernel is 0 (``tests/test_torch_cull.py`` holds
    this on the CPU, with block centres up to 100 m out)."""
    Vall = all_nodes.shape[0]
    wpb = (Vall + 31) // 32
    dev = entries.device
    order = node_order(Vall, str(dev)).long()
    nodes = torch.nn.functional.pad(all_nodes[order], (0, 0, 0, wpb * 32 - Vall))
    live = (torch.arange(wpb * 32, device=dev) < Vall).view(wpb, 32)

    def points(c0, c1):
        blk = row_block[c0:c1].long()
        return (nodes[None] + centers[blk][:, None, :]).view(-1, wpb, 32, 3)

    return km.warp_cull(points, live, cull_reach(ell), entries, ids, row_start, row_count,
                        row_w=ROW_W, chunk=chunk)


def sparse_kernel_scan(r: torch.Tensor, sf2: float) -> torch.Tensor:
    """The sparse kernel (clamped at 0) of every r [n] f32: on the card the
    segment kernel's own ``sparse_kernel_r``, on the CPU the plain version
    (``kernels/math.py::sparse_kernel``).  For the r_c scan."""
    if r.device.type == "cpu":
        return km.sparse_kernel(r, sf2)
    if r.device.type != "cuda":
        raise ValueError(f"sparse_kernel_scan: unsupported device {r.device}")
    if r.dtype != torch.float32 or not r.is_contiguous() or r.dim() != 1:
        raise ValueError("sparse_kernel_scan: r must be a contiguous 1-D f32 tensor")
    out = torch.empty_like(r)
    if r.numel() == 0:
        return out
    code = _build.lib().la3dm_sparse_kernel_scan(
        r.data_ptr(), out.data_ptr(), r.numel(), float(sf2),
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(code, "sparse_kernel_scan")
    return out


def bgk_heavy_plain(entries, labels, ids, gslot, row_block, row_start, row_count,
                    centers, all_nodes, *, G: int, sf2: float, ell: float,
                    chunk: int | None = None):
    """The plain PyTorch heavy pass: rows in chunks of ``chunk`` (2048 for
    points, 512 for segments, whose distance holds more temporaries); each
    row's [Vall, W] × [W, 2G] product summed over the entries in order, as
    the kernel sums them (a library matmul would pick its order by the
    thread count), then added at ``row_block`` in row order: the k-th rows
    of the chunk's blocks in one ``index_add_`` for each k, whose targets are
    distinct (one ``index_add_`` of a block's several rows adds them in no
    fixed order on the card)."""
    Tp, Vall = centers.shape[0], all_nodes.shape[0]
    dev = entries.device
    segments = entries.shape[1] == 6
    chunk = chunk or (512 if segments else 2048)
    acc = torch.zeros((Tp, Vall, 2 * G), dtype=torch.float32, device=dev)
    F, R = ids.shape[0], row_block.shape[0]
    if F == 0 or R == 0:
        return acc
    wcol = torch.arange(ROW_W, device=dev)
    for c0 in range(0, R, chunk):
        blk = row_block[c0:c0 + chunk].long()
        fidx = torch.clamp_max(row_start[c0:c0 + chunk].long()[:, None] + wcol, F - 1)
        valid = wcol < row_count[c0:c0 + chunk].long()[:, None]       # [c,W]
        eid = ids[fidx].long()
        ent = entries[eid]                                            # [c,W,D]
        vox = all_nodes[None] + centers[blk][:, None, :]              # [c,Vall,3]
        if segments:
            K = km.cov_sparse_segment(vox, ent, sf2, ell)             # [c,Vall,W]
        else:
            K = km.cov_sparse(vox, ent, sf2, ell)
        K = torch.where(valid[:, None, :], K, 0.0)
        rhs = kp._slot_rhs(labels[eid], gslot[fidx], valid, G)        # [c,W,2G]
        part = torch.zeros((len(blk), Vall, 2 * G), dtype=torch.float32, device=dev)
        for w in range(ROW_W):
            part += K[:, :, w, None] * rhs[:, None, w, :]
        rank = torch.arange(len(blk), device=dev) - torch.searchsorted(blk, blk)
        for k in range(int(rank.max()) + 1):
            sel = rank == k
            acc.index_add_(0, blk[sel], part[sel])
    return acc
