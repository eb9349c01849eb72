"""K3 — the BGKLV tile row engine: wrapper, plain version and launch counter.

Replaces ``la3dm_tpu/models/bgklv.py::_lv_rows_step`` (lines 127-208, with
``_ray_membership`` :66-119, ``kernels/math.py::point_to_segment_dist`` and
``sparse_kernel_lv``).  For each row of ≤ W segment entries (hits are
degenerate segments) of one (scan, 8³ tile): whether a proxy sample of each
ray lies in the voxel's ±ℓ cube (closed form, :func:`ray_membership`), the
LV kernel of the point-to-segment distance, (ȳ, k̄) per voxel summed over
the tile's rows; then, once per (scan, tile), the gate k̄ > gate ∧ eff == 0
and the add into the tile-major pool row ``slot·tpb + pos``.

On a CUDA tensor :func:`lv_rows` launches the hand-written kernel
(``csrc/lv_rows.cu``) on the plan of :func:`lv_rows_plan`: per chunk of the
(scan, tile) list, the row sums over parallel (row, 32 voxels) warp units
with exact warp-level culling, then the tile sums, the gate and the add in
scan order; no atomics.  On a CPU tensor it runs :func:`lv_rows_plain`.
:func:`lv_rows_cull` is the kernel's culling predicate in plain PyTorch.
What bounds the kernel is FP32 arithmetic on the CUDA cores (see
``FLOP_*`` below).
"""

from __future__ import annotations

import torch

from la3dm_tpu_torch.kernels import _build, math as km

#: fixed entry-row width; a warp of the kernel loads a row two entries a lane
ROW_W = 64
#: operations per (voxel, entry) pair: the membership test, evaluated for
#: every pair (per axis: slab test, flat test, two divisions, min/max and
#: the interval update, 16 × 3; then k_min, k_max and the decision, 13) ...
FLOP_MEMBERSHIP = 61
#: ... and, for a member pair, the point-to-segment distance (45), the LV
#: kernel with sinf/cosf counted as one each (13) and the two sums (3)
FLOP_MEMBER = 61
#: bytes of the per-row (ȳ, k̄) scratch [Rc, Vt] f32 that one chunk of the
#: tile list may take; longer dispatches run in chunks of consecutive tiles
SCRATCH_BYTES = 1 << 28
#: kernel launches since the counter was last reset (one per dispatch)
launches = 0


def lv_rows_plan(row_tile, tile_slot, tile_pos, *, tpb: int, Vt: int):
    """K3's work plan, on the tiles' device.

    Returns (tile_rows, chunks): tile_rows [T+1] int64, tile t's rows being
    tile_rows[t] .. tile_rows[t+1] (``row_tile`` must be non-decreasing);
    chunks a list of (t0, t1, r0, r1, apply_order), runs of consecutive
    tiles t0 .. t1 and their rows r0 .. r1, each of at most
    :data:`SCRATCH_BYTES` of row sums unless one tile alone has more.  The
    sum phase runs ⌈Vt/32⌉ warps a row; apply_order (chunk-relative int64)
    is the chunk's tiles by pool row ``slot·tpb + pos``, stable, so scan
    order within a pool row: the gate phase adds each run of equal pool rows
    in this order.  Chunks run one after the
    other, so every pool row takes its (scan, tile) sums in tile-list order.
    One chunk needs no host sync; more read tile_rows on the host.
    """
    T, R = tile_slot.shape[0], row_tile.shape[0]
    dev = tile_slot.device
    max_rows = max(1, SCRATCH_BYTES // (8 * Vt))
    tile_rows = torch.searchsorted(
        row_tile, torch.arange(T + 1, dtype=row_tile.dtype, device=dev))
    key = tile_slot.long() * tpb + tile_pos.long()
    if R <= max_rows:
        bounds = [(0, T, 0, R)] if T else []
    else:
        tr = tile_rows.tolist()
        bounds, t0 = [], 0
        while t0 < T:
            t1 = t0 + 1
            while t1 < T and tr[t1 + 1] - tr[t0] <= max_rows:
                t1 += 1
            bounds.append((t0, t1, tr[t0], tr[t1]))
            t0 = t1
    return tile_rows, [(t0, t1, r0, r1, torch.argsort(key[t0:t1], stable=True))
                       for t0, t1, r0, r1 in bounds]


def lv_rows(A, Bv, touched, eff, vox_base_t, entries, labels, ids, row_tile,
            row_start, row_count, tile_slot, tile_pos, tile_ctr, *, sf2: float,
            ell: float, free_res: float, gate: float, culled=None) -> None:
    """One dispatch of (scan, tile) rows into the pool (A, Bv, touched
    updated in place).

    Pool tensors are [cap, V] in tile-major voxel order (stored column
    pos·Vt + vt).  vox_base_t [tpb, Vt, 3] block-local voxel centres per tile
    position; entries [E, 6] f32 segments, labels [E] f32; ids [F] i32 the
    tiles' merged entry ids; row_* [R] i32, each row covering
    ids[start:start+count] (count ≤ W, 0 ⇒ padding) of tile ``row_tile``;
    tile_slot / tile_pos [T] i32 (slot == cap ⇒ padding), tile_ctr [T, 3]
    block centres.  The kernel needs ``row_tile`` non-decreasing (a tile's
    rows contiguous), as the map builds it.  ``culled`` (an int64 [1] tensor
    on the card, or None) counts the (warp, entry) pairs the kernel's warps
    skip.
    """
    if entries.device.type == "cpu":
        lv_rows_plain(A, Bv, touched, eff, vox_base_t, entries, labels, ids,
                      row_tile, row_start, row_count, tile_slot, tile_pos,
                      tile_ctr, sf2=sf2, ell=ell, free_res=free_res, gate=gate)
        return
    if entries.device.type != "cuda":
        raise ValueError(f"lv_rows: unsupported device {entries.device}")
    global launches
    args = dict(A=(A, torch.float32), Bv=(Bv, torch.float32),
                touched=(touched, torch.bool), eff=(eff, torch.int8),
                vox_base_t=(vox_base_t, torch.float32),
                entries=(entries, torch.float32), labels=(labels, torch.float32),
                ids=(ids, torch.int32), row_tile=(row_tile, torch.int32),
                row_start=(row_start, torch.int32), row_count=(row_count, torch.int32),
                tile_slot=(tile_slot, torch.int32), tile_pos=(tile_pos, torch.int32),
                tile_ctr=(tile_ctr, torch.float32))
    if culled is not None:
        args["culled"] = (culled, torch.int64)
    for k, (x, dt) in args.items():
        if x.device != entries.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"lv_rows: {k} must be a contiguous {dt} tensor "
                             f"on {entries.device}")
    tpb, Vt = vox_base_t.shape[0], vox_base_t.shape[1]
    T, R = tile_slot.shape[0], row_tile.shape[0]
    if (A.dim() != 2 or not A.shape == Bv.shape == touched.shape == eff.shape
            or A.shape[1] != tpb * Vt or Vt > 512 or vox_base_t.shape[2:] != (3,)
            or entries.shape[1:] != (6,) or labels.shape[0] != entries.shape[0]
            or row_start.shape[0] != R or row_count.shape[0] != R
            or tile_pos.shape[0] != T or tile_ctr.shape != (T, 3)
            or (culled is not None and culled.shape != (1,))):
        raise ValueError("lv_rows: inconsistent shapes (pool [cap, tpb·Vt], "
                         "Vt ≤ 512, entries [E, 6])")
    if T == 0:
        return
    cap = A.shape[0]
    tile_rows, chunks = lv_rows_plan(row_tile, tile_slot, tile_pos, tpb=tpb, Vt=Vt)
    rows = max(r1 - r0 for _, _, r0, r1, _ in chunks)
    rows_y = torch.empty((max(rows, 1), Vt), dtype=torch.float32, device=entries.device)
    rows_k = torch.empty_like(rows_y)
    stream = torch.cuda.current_stream(entries.device).cuda_stream
    lib = _build.lib()
    for t0, t1, r0, r1, apply_order in chunks:
        code = lib.la3dm_lv_rows(
            entries.data_ptr(), labels.data_ptr(), ids.data_ptr(), row_start.data_ptr(),
            row_count.data_ptr(), row_tile.data_ptr(), tile_rows.data_ptr(),
            apply_order.data_ptr(), tile_slot.data_ptr(), tile_pos.data_ptr(),
            tile_ctr.data_ptr(), vox_base_t.data_ptr(), eff.data_ptr(), A.data_ptr(),
            Bv.data_ptr(), touched.data_ptr(), rows_y.data_ptr(), rows_k.data_ptr(),
            culled.data_ptr() if culled is not None else None, t0, t1 - t0, r0, r1 - r0,
            cap, tpb, Vt, float(sf2), float(ell), float(free_res), float(gate), stream)
        _build.check(code, "lv_rows")
    launches += 1


def lv_rows_cull(vox_base_t, entries, ids, row_tile, row_start, row_count, tile_pos,
                 tile_ctr, *, ell: float, chunk: int = 1024):
    """K3's culling predicate in plain PyTorch: [R, ⌈Vt/32⌉, W] bool over
    (row, warp, entry), True where warp w (lane i: voxel 32·w + i of the
    row's tile) skips the entry — its segment misses the warp's voxel box
    padded by ℓ (``csrc/cull.cuh``) — and False for padding entries.  Every
    proxy sample of a ray lies on its segment, so a culled entry is a member
    of none of the warp's cubes."""
    Vt = vox_base_t.shape[1]
    wpt = (Vt + 31) // 32
    live = (torch.arange(wpt * 32, device=entries.device) < Vt).view(wpt, 32)

    def points(c0, c1):
        rt = row_tile[c0:c1].long()
        vox = tile_ctr[rt][:, None, :] + vox_base_t[tile_pos[rt].long()]   # [c,Vt,3]
        return torch.nn.functional.pad(vox, (0, 0, 0, wpt * 32 - Vt)).view(-1, wpt, 32, 3)

    return km.warp_cull(points, live, float(torch.tensor(ell, dtype=torch.float32)),
                        entries, ids, row_start, row_count, row_w=ROW_W, chunk=chunk)


def ray_membership(vox, seg, valid, free_res: float, ell: float):
    """[..., V, W] bool: does any proxy sample of segment w (its start, and
    the backward beam samples at d = l − k·fr > 0) lie in voxel v's closed
    ±ℓ cube?  Interval arithmetic per axis, as
    ``la3dm_tpu/models/bgklv.py::_ray_membership``; degenerate segments
    (hits) reduce to the start-in-cube test.

    vox [..., V, 3], seg [..., W, 6], valid [..., W] bool.
    """
    inf = float("inf")
    a = seg[..., None, :, 0:3]                       # [..., 1, W, 3]
    u = seg[..., None, :, 3:6] - a
    l = torch.sqrt(u[..., 0] * u[..., 0] + u[..., 1] * u[..., 1]
                   + u[..., 2] * u[..., 2])          # [..., 1, W]
    nd = u / torch.clamp_min(l, 1e-30)[..., None]
    in_a = dlo = dhi = None
    for ax in range(3):
        lo = vox[..., :, None, ax] - ell             # [..., V, 1]
        hi = vox[..., :, None, ax] + ell
        a_, n_ = a[..., ax], nd[..., ax]             # [..., 1, W]
        slab = (a_ >= lo) & (a_ <= hi)
        in_a = slab if in_a is None else in_a & slab
        flat = n_.abs() < 1e-12
        safe = torch.where(flat, 1.0, n_)
        t0 = (lo - a_) / safe
        t1 = (hi - a_) / safe
        tmn = torch.where(flat, torch.where(slab, -inf, inf), torch.minimum(t0, t1))
        tmx = torch.where(flat, torch.where(slab, inf, -inf), torch.maximum(t0, t1))
        dlo = tmn if dlo is None else torch.maximum(dlo, tmn)
        dhi = tmx if dhi is None else torch.minimum(dhi, tmx)
    k_min = torch.clamp_min(torch.ceil((l - dhi) / free_res), 1.0)
    k_max = torch.minimum(torch.floor((l - torch.clamp_min(dlo, 0.0)) / free_res),
                          torch.ceil(l / free_res) - 1.0)
    in_beam = (k_min <= k_max) & (dhi >= dlo)
    return (in_a | in_beam) & valid[..., None, :]


def lv_rows_acc_plain(vox_base_t, entries, labels, ids, row_tile, row_start,
                      row_count, tile_pos, tile_ctr, *, sf2: float, ell: float,
                      free_res: float, chunk: int = 32):
    """The plain per-tile sums: (acc_y, acc_k) [T, Vt] f32 and the number
    of member (voxel, entry) pairs.  Rows go in chunks of ``chunk``; each
    row's entries are summed one by one in order, as the kernel sums them
    (a library matmul would pick its order by the thread count), then the
    row totals are index-added at ``row_tile`` in row order."""
    ell = float(torch.tensor(ell, dtype=torch.float32))
    fr = float(torch.tensor(free_res, dtype=torch.float32))
    T, Vt = tile_pos.shape[0], vox_base_t.shape[1]
    dev = entries.device
    acc_y = torch.zeros((T, Vt), dtype=torch.float32, device=dev)
    acc_k = torch.zeros((T, Vt), dtype=torch.float32, device=dev)
    members = torch.zeros((), dtype=torch.int64, device=dev)
    F, R = ids.shape[0], row_tile.shape[0]
    if F == 0 or R == 0:
        return acc_y, acc_k, members
    wcol = torch.arange(ROW_W, device=dev)
    for c0 in range(0, R, chunk):
        rt = row_tile[c0:c0 + chunk].long()
        fidx = torch.clamp_max(row_start[c0:c0 + chunk].long()[:, None] + wcol, F - 1)
        valid = wcol < row_count[c0:c0 + chunk].long()[:, None]      # [c,W]
        eid = ids[fidx].long()
        seg = entries[eid]                                            # [c,W,6]
        lab = labels[eid]                                             # [c,W]
        vox = tile_ctr[rt][:, None, :] + vox_base_t[tile_pos[rt].long()]  # [c,Vt,3]
        member = ray_membership(vox, seg, valid, fr, ell)             # [c,Vt,W]
        d = km.point_to_segment_dist(vox, seg)
        K = torch.where(member, km.sparse_kernel_lv(d / ell, sf2), 0.0)
        members += member.sum()
        ry = torch.zeros((len(rt), Vt), dtype=torch.float32, device=dev)
        rk = torch.zeros_like(ry)
        for w in range(ROW_W):
            k = K[:, :, w]
            ry = ry + k * lab[:, None, w]
            rk = rk + k
        acc_y.index_add_(0, rt, ry)
        acc_k.index_add_(0, rt, rk)
    return acc_y, acc_k, members


def lv_rows_apply_plain(A, Bv, touched, eff, acc_y, acc_k, tile_slot, tile_pos,
                        *, gate: float) -> None:
    """Gate each (scan, tile) sum on k̄ > gate at base-resolution leaves
    (eff == 0) and add it into the pool rows, in tile order."""
    Vt = acc_y.shape[1]
    cap, V = A.shape
    tpb = V // Vt
    keep = tile_slot.long() < cap                   # drop padding tiles
    row = (tile_slot.long() * tpb + tile_pos.long())[keep]
    ay, ak = acc_y[keep], acc_k[keep]
    g = (ak > gate) & (eff.view(-1, Vt)[row] == 0)
    A.view(-1, Vt).index_add_(0, row, torch.where(g, ay, 0.0))
    Bv.view(-1, Vt).index_add_(0, row, torch.where(g, ak - ay, 0.0))
    # touched |= g; a pool row may appear once per scan of the dispatch
    urow, inv = torch.unique(row, return_inverse=True)
    hits = torch.zeros((len(urow), Vt), dtype=torch.int32, device=A.device)
    hits.index_add_(0, inv, g.to(torch.int32))
    tv = touched.view(-1, Vt)
    tv[urow] = tv[urow] | (hits > 0)


def lv_rows_plain(A, Bv, touched, eff, vox_base_t, entries, labels, ids, row_tile,
                  row_start, row_count, tile_slot, tile_pos, tile_ctr, *,
                  sf2: float, ell: float, free_res: float, gate: float) -> None:
    """The plain PyTorch row engine (in place); takes padding rows and tiles
    in any order, as the JAX step's padded argument tuple has them."""
    acc_y, acc_k, _ = lv_rows_acc_plain(
        vox_base_t, entries, labels, ids, row_tile, row_start, row_count,
        tile_pos, tile_ctr, sf2=sf2, ell=ell, free_res=free_res)
    lv_rows_apply_plain(A, Bv, touched, eff, acc_y, acc_k, tile_slot, tile_pos,
                        gate=gate)
