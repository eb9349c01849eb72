"""The warp-level culling of K3, of K1 (both branches) and of K1′, on the
CPU.

The kernels skip a (warp, entry) pair only where the entry provably adds
nothing to any of the warp's 32 outputs (``csrc/cull.cuh``).  Their
predicates are plain PyTorch functions beside the plain versions
(``kernels/lv_rows.py::lv_rows_cull``, ``kernels/bgk_heavy.py::
bgk_heavy_cull``, ``kernels/bgk_aligned_heavy.py::bgk_aligned_heavy_cull``);
here they are held, on seeded and on hypothesis-made entries (cube faces,
flat axes, degenerate hits, segments grazing the box, points on the padded
box faces, K1's points round block centres up to 100 m out), to never cull
a K3 member pair (``ray_membership``) or a K1 or K1′ pair whose plain kernel
value is non-zero.  K1's and K1′'s point sums taken as their kernels take
them, the culled pairs skipped, equal their plain versions bit for bit.
K3's work plan is held to a direct numpy count.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from la3dm_tpu_torch.geometry import blocks as geo
from la3dm_tpu_torch.kernels import bgk_aligned_heavy as kah, bgk_heavy, lv_rows, math as km

from torch_cases import (LV_ROWS_STATICS, aligned_heavy_inputs, heavy_inputs,  # noqa: F401
                         lv_rows_inputs, one_torch_thread)  # (autouse fixture)

F32 = np.float32
W = lv_rows.ROW_W


def _rows(ids, row_start, row_count):
    """The rows' entry ids [R, W] and the valid mask."""
    wcol = torch.arange(W)
    fidx = torch.clamp_max(row_start.long()[:, None] + wcol, max(ids.shape[0] - 1, 0))
    return ids[fidx].long(), wcol < row_count.long()[:, None]


def _k3_cull_and_members(a, ell=0.2, free_res=0.1):
    """K3's cull [R, wpt, W] and, per (row, warp, entry), whether any of the
    warp's voxels is a member."""
    vbt, ent, _, ids, rt, rs, rn, _, pos, ctr = a[4:]
    cull = lv_rows.lv_rows_cull(vbt, ent, ids, rt, rs, rn, pos, ctr, ell=ell)
    ell32 = float(torch.tensor(ell, dtype=torch.float32))
    fr32 = float(torch.tensor(free_res, dtype=torch.float32))
    eid, valid = _rows(ids, rs, rn)
    vox = ctr[rt.long()][:, None, :] + vbt[pos[rt.long()].long()]            # [R,Vt,3]
    member = lv_rows.ray_membership(vox, ent[eid], valid, fr32, ell32)       # [R,Vt,W]
    R, Vt = member.shape[:2]
    wpt = (Vt + 31) // 32
    member = torch.nn.functional.pad(member, (0, 0, 0, wpt * 32 - Vt))
    return cull, member.view(R, wpt, 32, W).any(2), valid


@pytest.mark.parametrize("depth", [1, 2, 3, 5, 6])
def test_k3_cull_never_skips_a_member(depth):
    a = lv_rows_inputs(31 + depth, depth=depth, n_scans=4)
    cull, member, valid = _k3_cull_and_members(a)
    assert not (cull & member).any()
    n_valid = int(valid.sum()) * cull.shape[1]
    # the predicate does skip pairs (a depth-1 tile is one warp of 8 voxels
    # whose halo holds every entry)
    assert depth == 1 or int(cull.sum()) > 0.05 * n_valid
    assert not (cull & ~valid[:, None, :]).any()


def _tile_case(depth, seed):
    """One BGKLV tile (depth ≥ 3: 8³ voxels) and its voxel centres."""
    n = 2 ** (depth - 1)
    te = min(8, n)
    vbt = geo.voxel_offsets(0.1, depth)[geo.tile_vox_map(n)].astype(F32)
    rng = np.random.default_rng(seed)
    pos = int(rng.integers(0, vbt.shape[0]))
    ctr = (rng.integers(-20, 20, 3) * F32(0.1 * n)).astype(F32)
    return vbt, pos, ctr, te ** 3


@st.composite
def _k3_entries(draw):
    """Entries aimed at a tile's cube faces: each starts on (or just off) a
    face of a voxel's ±ℓ cube, or passes a face corner, in a direction that
    may be axis-aligned, nearly so (|n| < 1e-12 on an axis) or none at all
    (a degenerate hit)."""
    depth = draw(st.sampled_from([3, 5, 6]))
    seed = draw(st.integers(0, 10_000))
    vbt, pos, ctr, Vt = _tile_case(depth, seed)
    ell = F32(0.2)
    vox = (ctr + vbt[pos]).astype(F32)                      # the kernel's p
    lo, hi = (vox - ell).astype(F32), (vox + ell).astype(F32)
    n = draw(st.integers(1, 40))
    ents = []
    for _ in range(n):
        v = draw(st.integers(0, Vt - 1))
        ax = draw(st.integers(0, 2))
        face = draw(st.sampled_from(["lo", "hi"]))
        nudge = draw(st.sampled_from([0, -1, 1]))           # ulps off the face
        p = np.array([draw(st.floats(float(lo[v, i]), float(hi[v, i]), width=32))
                      for i in range(3)], F32)
        p[ax] = (lo if face == "lo" else hi)[v, ax]
        p[ax] = np.nextafter(p[ax], F32(np.inf) if nudge > 0 else F32(-np.inf)) \
            if nudge else p[ax]
        kind = draw(st.sampled_from(["hit", "axis", "near_axis", "any", "into"]))
        if kind == "hit":
            ents.append(np.concatenate([p, p]))
            continue
        d = np.array([draw(st.floats(-1, 1, width=32)) for _ in range(3)], F32)
        if kind == "axis":
            d = np.zeros(3, F32)
            d[draw(st.integers(0, 2))] = draw(st.sampled_from([-1.0, 1.0]))
        elif kind == "near_axis":
            d = np.zeros(3, F32)
            d[ax] = 1.0
            d[(ax + 1) % 3] = F32(1e-13)
        if not np.any(d):
            d[0] = 1.0
        length = F32(draw(st.floats(0.01, 4.0)))
        # "into": the ray ends on the face (its backward samples walk away
        # from it); otherwise it starts there
        if kind == "into":
            ents.append(np.concatenate([p - d * length, p]).astype(F32))
        else:
            ents.append(np.concatenate([p, p + d * length]).astype(F32))
    ent = np.stack(ents).astype(F32)
    E = len(ent)
    ids = np.arange(E, dtype=np.int32)
    rs = np.arange(0, E, W, dtype=np.int32)
    rn = np.minimum(W, E - rs).astype(np.int32)
    rt = np.zeros(len(rs), np.int32)
    V = vbt.shape[0] * Vt
    pool = (torch.zeros((1, V)), torch.zeros((1, V)), torch.zeros((1, V), dtype=torch.bool),
            torch.zeros((1, V), dtype=torch.int8))
    rest = tuple(torch.from_numpy(x) for x in (
        vbt, ent, np.zeros(E, F32), ids, rt, rs, rn, np.zeros(1, np.int32),
        np.array([pos], np.int32), ctr[None].astype(F32)))
    fr = draw(st.sampled_from([0.1, 0.05, 0.3]))
    return pool + rest, fr


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_k3_entries())
def test_k3_cull_never_skips_a_member_on_cube_faces(case):
    a, fr = case
    cull, member, _ = _k3_cull_and_members(a, ell=0.2, free_res=fr)
    assert not (cull & member).any()


def _k1_cull_and_nonzero(a, ell, sf2=0.1):
    """K1's cull [R, wpb, W] and, per (row, warp, entry), whether the
    plain kernel is non-zero at any of the warp's nodes (segments or
    points)."""
    ent, ids, rb, rs, rn, ctr, nodes = (a[k] for k in ("entries", "ids", "row_block",
                                                       "row_start", "row_count", "centers",
                                                       "all_nodes"))
    cull = bgk_heavy.bgk_heavy_cull(ent, ids, rb, rs, rn, ctr, nodes, ell=ell)
    order = bgk_heavy.node_order(nodes.shape[0]).long()
    eid, valid = _rows(ids, rs, rn)
    pts = nodes[order][None] + ctr[rb.long()][:, None, :]                    # [R,Vall,3]
    cov = km.cov_sparse_segment if ent.shape[1] == 6 else km.cov_sparse
    K = cov(pts, ent[eid], sf2, ell)                                         # [R,Vall,W]
    K = torch.where(valid[:, None, :], K, 0.0)
    R, Vall = K.shape[:2]
    wpb = (Vall + 31) // 32
    K = torch.nn.functional.pad(K, (0, 0, 0, wpb * 32 - Vall))
    return cull, (K.view(R, wpb, 32, W) != 0).any(2), valid


@pytest.mark.parametrize("depth,res,ell", [(3, 0.1, 0.2), (4, 0.2, 0.6), (5, 0.2, 0.6)])
def test_k1_segment_cull_never_skips_a_nonzero_pair(depth, res, ell):
    a = heavy_inputs(41 + depth, G=27, n_blocks=3 if depth == 5 else 8, segments=True,
                     depth=depth, res=res)
    cull, nonzero, valid = _k1_cull_and_nonzero(a, ell)
    assert not (cull & nonzero).any()
    assert int(cull.sum()) > 0.05 * int(valid.sum()) * cull.shape[1]


@st.composite
def _k1_entries(draw):
    """Segments that pass a node at a distance of about r_c·ℓ (a few ulps
    either side, the last ulp of the kernel's support), along or across the
    axes, degenerate or shorter than the 1e-4 threshold."""
    depth = draw(st.sampled_from([3, 4]))
    res = 0.1 if depth == 3 else 0.2
    ell = F32(draw(st.sampled_from([0.2, 0.6])))
    nodes, _ = geo.all_level_nodes(res, depth)
    ctr = (np.array([draw(st.integers(-30, 30)) for _ in range(3)]) * F32(
        res * 2 ** (depth - 1))).astype(F32)
    n = draw(st.integers(1, 40))
    ents = []
    for _ in range(n):
        p = (nodes[draw(st.integers(0, len(nodes) - 1))] + ctr).astype(F32)
        off = np.array([draw(st.floats(-1, 1, width=32)) for _ in range(3)], np.float64)
        if draw(st.booleans()):
            off = np.zeros(3)
            off[draw(st.integers(0, 2))] = draw(st.sampled_from([-1.0, 1.0]))
        if not np.any(off):
            off[2] = 1.0
        off /= np.linalg.norm(off)
        r = bgk_heavy.R_CULL * float(ell) * (1 + draw(st.integers(-8, 8)) * 2.0 ** -23)
        q = (p + off * r).astype(F32)                       # the segment's closest point
        side = np.cross(off, [0.3, 0.5, 0.7])
        side = side / max(np.linalg.norm(side), 1e-9)
        kind = draw(st.sampled_from(["hit", "tiny", "across", "from"]))
        if kind == "hit":
            ents.append(np.concatenate([q, q]))
        elif kind == "tiny":
            ents.append(np.concatenate([q, q + side * 5e-5]).astype(F32))
        elif kind == "across":                              # tangent to the sphere
            h = draw(st.floats(0.01, 3.0))
            ents.append(np.concatenate([q - side * h, q + side * h]).astype(F32))
        else:                                               # pointing away from p
            h = draw(st.floats(0.01, 3.0))
            ents.append(np.concatenate([q, q + off * h]).astype(F32))
    ent = np.stack(ents).astype(F32)
    E = len(ent)
    rs = np.arange(0, E, W, dtype=np.int32)
    a = dict(entries=ent, ids=np.arange(E, dtype=np.int32), row_start=rs,
             row_count=np.minimum(W, E - rs).astype(np.int32),
             row_block=np.zeros(len(rs), np.int32), centers=ctr[None], all_nodes=nodes)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}, float(ell)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_k1_entries())
def test_k1_segment_cull_never_skips_a_nonzero_pair_at_the_support(case):
    a, ell = case
    cull, nonzero, _ = _k1_cull_and_nonzero(a, ell)
    assert not (cull & nonzero).any()


#: K1 point cases: block_depth → (res, ℓ, test blocks)
K1_POINT_CASES = {3: (0.1, 0.2, 8), 5: (0.2, 0.6, 3)}


@pytest.mark.parametrize("offset", [0.0, 30.0, 100.0])
@pytest.mark.parametrize("depth,G", [(3, 7), (3, 27), (5, 7), (5, 27)])
def test_k1_point_cull_never_skips_a_nonzero_pair(depth, G, offset):
    """K1's point branch culls in world coordinates: block centres near the
    origin and 30 m and 100 m out (the large maps reach 30 m), at block_depth
    3 and 5."""
    res, ell, T = K1_POINT_CASES[depth]
    a = heavy_inputs(61 + depth + G, G=G, n_blocks=T, depth=depth, res=res, offset=offset)
    cull, nonzero, valid = _k1_cull_and_nonzero(a, ell, sf2=1.0)
    assert not (cull & nonzero).any()
    assert not (cull & ~valid[:, None, :]).any()
    n_pairs = int(valid.sum()) * cull.shape[1]
    # it does skip pairs (ℓ is half a block at depth 3), and leaves some
    assert int(cull.sum()) > 0.2 * n_pairs and int(nonzero.sum()) > 0


@st.composite
def _k1_point_entries(draw):
    """K1 point entries where its culling decides in the last ulps: on a
    warp's padded box faces (a few ulps either side) and at about r_c·ℓ
    from one of its nodes, round a block centre up to 100 m out."""
    depth = draw(st.sampled_from([3, 5]))
    res, ell = K1_POINT_CASES[depth][:2]
    nodes, _ = geo.all_level_nodes(res, depth)
    bs = res * 2 ** (depth - 1)
    far = draw(st.sampled_from([0.0, 30.0, 100.0]))
    ctr = (far + np.array([draw(st.integers(-20, 20)) for _ in range(3)]) * F32(bs)).astype(F32)
    Vall = len(nodes)
    wpb = (Vall + 31) // 32
    w = draw(st.integers(0, wpb - 1))
    lanes = bgk_heavy.node_order(Vall).long()[32 * w:32 * w + 32]
    pts = torch.from_numpy(nodes)[lanes] + torch.from_numpy(ctr)             # f32, as K1
    plo, phi = km.warp_box(pts[None], torch.ones((1, len(lanes)), dtype=torch.bool),
                           bgk_heavy.cull_reach(ell))
    plo, phi = plo[0].numpy(), phi[0].numpy()
    n = draw(st.integers(1, 40))
    ents = []
    for _ in range(n):
        if draw(st.booleans()):                          # on a padded face
            p = np.array([draw(st.floats(float(plo[i]), float(phi[i]), width=32))
                          for i in range(3)], F32)
            ax = draw(st.integers(0, 2))
            p[ax] = (plo if draw(st.booleans()) else phi)[ax]
            for _ in range(draw(st.integers(0, 3))):
                p[ax] = np.nextafter(p[ax], F32(draw(st.sampled_from([-np.inf, np.inf]))))
        else:                                            # at the support of a node
            v = pts[draw(st.integers(0, len(lanes) - 1))].numpy()
            off = np.array([draw(st.floats(-1, 1, width=32)) for _ in range(3)], np.float64)
            if not np.any(off):
                off[0] = 1.0
            off /= np.linalg.norm(off)
            r = bgk_heavy.R_CULL * ell * (1 + draw(st.integers(-8, 8)) * 2.0 ** -23)
            p = (v + off * r).astype(F32)
        ents.append(p)
    ent = np.stack(ents).astype(F32)
    rs = np.arange(0, n, W, dtype=np.int32)
    a = dict(entries=ent, ids=np.arange(n, dtype=np.int32), row_start=rs,
             row_count=np.minimum(W, n - rs).astype(np.int32),
             row_block=np.zeros(len(rs), np.int32), centers=ctr[None], all_nodes=nodes)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}, ell


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_k1_point_entries())
def test_k1_point_cull_never_skips_a_nonzero_pair_on_the_box_faces(case):
    a, ell = case
    cull, nonzero, _ = _k1_cull_and_nonzero(a, ell, sf2=1.0)
    assert not (cull & nonzero).any()


def _k1_skipping(a, G, sf2, ell):
    """K1's sums as its kernel takes them: each row's surviving entries (the
    pairs ``bgk_heavy_cull`` keeps) into their slot's row sum in row order,
    each slot's row sum added to the block's only where the row has a
    survivor in that slot, the rows of a block in order; the culled entries
    never added.  Returns acc [T, Vall, 2G]."""
    ent, lab, ids, gs, rb, rs, rn, ctr, nodes = (
        a[k] for k in ("entries", "labels", "ids", "gslot", "row_block", "row_start",
                       "row_count", "centers", "all_nodes"))
    T, Vall = ctr.shape[0], nodes.shape[0]
    order = bgk_heavy.node_order(Vall).long()
    cull = bgk_heavy.bgk_heavy_cull(ent, ids, rb, rs, rn, ctr, nodes, ell=ell)
    eid, valid = _rows(ids, rs, rn)
    fidx = torch.clamp_max(rs.long()[:, None] + torch.arange(W), ids.shape[0] - 1)
    slot = gs[fidx].long()                                                    # [R,W]
    keep = torch.repeat_interleave(~cull, 32, dim=1)[:, :Vall] & valid[:, None, :]
    pts = nodes[order][None] + ctr[rb.long()][:, None, :]                    # [R,Vall,3]
    K = km.cov_sparse(pts, ent[eid], sf2, ell)                               # [R,Vall,W]
    R = rs.shape[0]
    rows = torch.arange(R)
    ry = torch.zeros((R, Vall, G))
    rk = torch.zeros((R, Vall, G))
    seen = torch.zeros((R, Vall, G), dtype=torch.bool)
    for j in range(W):
        g, m, k = slot[:, j], keep[:, :, j], K[:, :, j]
        ry[rows, :, g] = torch.where(m, ry[rows, :, g] + k * lab[eid[:, j]][:, None],
                                     ry[rows, :, g])
        rk[rows, :, g] = torch.where(m, rk[rows, :, g] + k, rk[rows, :, g])
        seen[rows, :, g] |= m
    acc = torch.zeros((T, Vall, 2 * G))
    for r in range(R):                                   # rows in order, blocks apart
        t = int(rb[r])
        s2 = torch.cat([seen[r], seen[r]], -1)
        acc[t] = torch.where(s2, acc[t] + torch.cat([ry[r], rk[r]], -1), acc[t])
    out = torch.zeros_like(acc)
    out[:, order] = acc
    return out


@pytest.mark.parametrize("offset", [0.0, 100.0])
@pytest.mark.parametrize("depth,G", [(3, 7), (3, 27), (5, 27)])
def test_k1_point_skipping_the_culled_pairs_is_bit_exact(depth, G, offset):
    """K1's plain version, and its point sums taken the kernel's way with
    the culled pairs skipped (never added), are equal bit for bit: a skipped
    entry adds exactly +0 to its slot's row sum."""
    res, ell, T = K1_POINT_CASES[depth]
    a = heavy_inputs(90 + depth + G, G=G, n_blocks=T, depth=depth, res=res, offset=offset)
    kw = dict(G=G, sf2=1.0, ell=ell)
    ref = bgk_heavy.bgk_heavy_plain(*(a[k] for k in (
        "entries", "labels", "ids", "gslot", "row_block", "row_start", "row_count",
        "centers", "all_nodes")), **kw)
    got = _k1_skipping(a, G, 1.0, ell)
    assert torch.equal(got, ref)
    assert int((ref[..., G:] > 0).sum()) > 100


@pytest.mark.parametrize("sf2", [0.1, 1.0])
def test_sparse_kernel_is_zero_from_r_c_on(sf2):
    """r_c: every f32 r in [R_CULL, 2) gives exactly 0 (the card's own
    sparse_kernel_r is scanned the same way in tests/test_torch_cuda.py)."""
    r = torch.arange(0x3F800000, 0x40000000, dtype=torch.int32).view(torch.float32)
    assert float(r[0]) == bgk_heavy.R_CULL
    k = bgk_heavy.sparse_kernel_scan(r, sf2)
    assert int(torch.count_nonzero(k)) == 0
    assert (bgk_heavy.sparse_kernel_scan(torch.tensor([0.5, 0.9]), sf2) > 0).all()


@pytest.mark.parametrize("depth", [1, 2, 3, 5, 6])
def test_node_order_is_a_compact_permutation(depth):
    nodes = torch.from_numpy(geo.all_level_nodes(0.2, depth)[0])
    Vall = len(nodes)
    order = bgk_heavy.node_order(Vall)
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order.long())[0], torch.arange(Vall))
    wpb = (Vall + 31) // 32

    def width(o):
        pts = torch.nn.functional.pad(nodes[o], (0, 0, 0, wpb * 32 - Vall))
        live = (torch.arange(wpb * 32) < Vall).view(wpb, 32)
        lo, hi = km.warp_box(pts.view(wpb, 32, 3), live, 0.0)
        return float((hi - lo).sum(-1).mean())

    # a warp's box is on average no wider than one of 32 table-order nodes
    # (narrower from block_depth 5 on, where a raster row of leaves is 16+)
    assert width(order.long()) <= width(torch.arange(Vall))
    assert depth < 5 or width(order.long()) < 0.7 * width(torch.arange(Vall))
    # a table of another size keeps its order
    assert torch.equal(bgk_heavy.node_order(Vall + 1), torch.arange(Vall + 1,
                                                                  dtype=torch.int32))


# ------------------------------------------------------------------- K1′

#: K1′'s test cases: (block_depth, res, ℓ, G, T, U, spread) — the demo's
#: 0.4 m blocks and the large map's 3.2 m blocks (4681 nodes)
K1P_CASES = {3: (0.1, 0.2, 60, 40, 0.3), 5: (0.2, 0.6, 3, 5, 2.4)}


def _k1p_case(seed, depth, G, segments, **kw):
    res, ell, T, U, spread = K1P_CASES[depth]
    a = aligned_heavy_inputs(seed, G=G, U=U, T=T, segments=segments, depth=depth, res=res,
                             spread=spread, **kw)
    return a, ell


def _k1p_args(a):
    return tuple(a[k] for k in ("ent_rel", "labels", "ustart", "ucount", "tb_u", "ext_nodes"))


def _k1p_cull(a, G, ell, **kw):
    """``bgk_aligned_heavy_cull`` on the case ``a``."""
    ent, _, us, uc, tb, ext = _k1p_args(a)
    return kah.bgk_aligned_heavy_cull(ent, us, uc, tb, ext, G=G, ell=ell, **kw)


def _k1p_terms(a, G, sf2, ell, sel):
    """The steps ``sel`` of K1′'s walk (``aligned_steps``): the plain kernel
    values [n, Vall, STEP] between the step's slot nodes, in
    ``node_order``, and its entries; their labels and valid mask [n, STEP]."""
    ent, lab, us, _, tb, ext = _k1p_args(a)
    Vall = ext.shape[0] // G
    pair, off, cnt = (x[sel] for x in kah.aligned_steps(a["ucount"], tb))
    j = torch.arange(kah.STEP)
    valid = j < cnt[:, None]
    idx = torch.where(valid, (us[tb.reshape(-1)[pair]] + off)[:, None] + j, 0)
    order = bgk_heavy.node_order(Vall).long()
    nodes = ext.view(G, Vall, 3)[:, order][pair % G]                        # [n,Vall,3]
    cov = km.cov_sparse_segment if ent.shape[1] == 6 else km.cov_sparse
    K = torch.where(valid[:, None, :], cov(nodes, ent[idx], sf2, ell), 0.0)
    return K, torch.where(valid, lab[idx], 0.0), valid


def _k1p_cull_and_nonzero(a, G, ell, sf2=0.1, chunk=32):
    """K1′'s cull [S, wpb, STEP] and, per (step, warp, entry), whether the
    plain kernel is non-zero at any of the warp's nodes."""
    cull = _k1p_cull(a, G, ell)
    S, wpb = cull.shape[:2]
    nonzero = torch.zeros_like(cull)
    for s0 in range(0, S, chunk):
        sel = torch.arange(s0, min(S, s0 + chunk))
        K = _k1p_terms(a, G, sf2, ell, sel)[0]
        K = torch.nn.functional.pad(K, (0, 0, 0, wpb * 32 - K.shape[1]))
        nonzero[sel] = (K.view(len(sel), wpb, 32, kah.STEP) != 0).any(2)
    return cull, nonzero


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("depth,G", [(3, 7), (3, 27), (5, 7), (5, 27)])
def test_k1p_cull_never_skips_a_nonzero_pair(depth, G, segments):
    """K1′'s predicate on random runs (0..149 entries, degenerate, short and
    axis-aligned segments among them) at block_depth 3 and 5."""
    a, ell = _k1p_case(70 + depth + G, depth, G, segments)
    cull, nonzero = _k1p_cull_and_nonzero(a, G, ell)
    assert not (cull & nonzero).any()
    _, _, cnt = kah.aligned_steps(a["ucount"], a["tb_u"])
    n_pairs = int(cnt.sum()) * cull.shape[1]
    # it does skip pairs: about half at depth 3 (ℓ is half a block there),
    # most at depth 5
    assert int(cull.sum()) > (0.2 if depth == 3 else 0.6) * n_pairs
    assert int(nonzero.sum()) > 0
    valid = torch.arange(kah.STEP) < cnt[:, None]
    assert not (cull & ~valid[:, None, :]).any()
    # the per-warp count, chunked, is the predicate's
    per = _k1p_cull(a, G, ell, per_warp=True, chunk=5000)
    assert torch.equal(per, cull.sum((0, 2)))


def _k1p_skipping(a, G, sf2, ell):
    """K1′'s sums as its kernel takes them: each (t, g) pair's steps in
    order, the survivors of a step (the pairs ``bgk_aligned_heavy_cull``
    keeps) in entry order into the Wa-row sum, flushed into the slot's total
    when a survivor opens another row; the culled entries skipped.
    Returns acc [T, Vall, 2G]."""
    _, _, _, ucount, tb, ext = _k1p_args(a)
    T, Vall = tb.shape[0], ext.shape[0] // G
    cull = _k1p_cull(a, G, ell)
    keep_w = torch.repeat_interleave(~cull, 32, dim=1)[:, :Vall]             # [S,Vall,STEP]
    pair, off, _ = kah.aligned_steps(ucount, tb)
    tot = torch.zeros((2, T * G, Vall))                                      # yb, kb
    part = torch.zeros((2, T * G, Vall))                                     # ry, rk
    row = torch.zeros((T * G, Vall), dtype=torch.int64)
    k_of = off // kah.STEP
    for k in range(int(k_of.max()) + 1 if len(k_of) else 0):
        sel = torch.nonzero(k_of == k).reshape(-1)
        p = pair[sel]                                     # distinct pairs
        K, lab, valid = _k1p_terms(a, G, sf2, ell, sel)
        keep = keep_w[sel] & valid[:, None, :]
        y, r_, rw = tot[:, p], part[:, p], row[p]
        for j in range(kah.STEP):
            m = keep[:, :, j]
            r = ((off[sel] + j) // kah.WA)[:, None]
            flush = m & (r != rw)
            y = torch.where(flush, y + r_, y)
            r_ = torch.where(flush, 0.0, r_)
            rw = torch.where(flush, r, rw)
            kj = K[:, :, j]
            r_ = torch.where(m, r_ + torch.stack([kj * lab[:, None, j], kj]), r_)
        tot[:, p], part[:, p], row[p] = y, r_, rw
    tot = tot + part
    out = torch.zeros((2, T * G, Vall))
    out[:, :, bgk_heavy.node_order(Vall).long()] = tot
    return out.view(2, T, G, Vall).permute(1, 3, 0, 2).reshape(T, Vall, 2 * G)


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("depth,G", [(3, 7), (3, 27), (5, 27)])
def test_k1p_skipping_the_culled_pairs_is_bit_exact(depth, G, segments):
    """K1′'s plain version, and its sums taken the kernel's way with the
    culled pairs skipped (never added), are equal bit for bit: a skipped
    entry adds exactly +0 in the Wa = 8 row order."""
    a, ell = _k1p_case(80 + depth + G, depth, G, segments)
    sf2 = 0.1 if segments else 1.0
    ref = kah.bgk_aligned_heavy_plain(*_k1p_args(a), G=G, sf2=sf2, ell=ell)
    got = _k1p_skipping(a, G, sf2, ell)
    assert torch.equal(got, ref)
    assert int((ref[..., G:] > 0).sum()) > 100


@pytest.mark.parametrize("sf2", [0.1, 1.0])
def test_sparse_kernel_of_sqrt_d2_is_zero_from_one_on(sf2):
    """K1′'s point branch evaluates sqrt(d2): every f32 d2 in [1, 4) gives
    r = sqrt(d2) ≥ 1 and a kernel of exactly 0 (d2 ≥ 4: r ≥ 2, where the
    formula is negative)."""
    d2 = torch.arange(0x3F800000, 0x40800000, dtype=torch.int32).view(torch.float32)
    assert float(d2[0]) == 1.0 and float(d2[-1]) < 4.0
    r = torch.sqrt(d2)
    assert bool((r >= bgk_heavy.R_CULL).all())
    assert int(torch.count_nonzero(km.sparse_kernel(r, sf2))) == 0


@st.composite
def _k1p_entries(draw):
    """K1′ entries where its culling decides in the last ulps: points and
    segment ends on a warp's padded box faces (a few ulps either side) and
    entries at about r_c·ℓ from one of the warp's nodes, in one slot of one
    test block."""
    depth = draw(st.sampled_from([3, 5]))
    G = draw(st.sampled_from([7, 27]))
    res, ell = K1P_CASES[depth][:2]
    segments = draw(st.booleans())
    a = aligned_heavy_inputs(0, G=G, U=1, T=1, depth=depth, res=res, counts=[0])
    ext = a["ext_nodes"]
    Vall = ext.shape[0] // G
    wpb = (Vall + 31) // 32
    g = draw(st.integers(0, G - 1))
    w = draw(st.integers(0, wpb - 1))
    order = bgk_heavy.node_order(Vall).long()
    lanes = order[32 * w:32 * w + 32]
    pts = ext.view(G, Vall, 3)[g][lanes]
    plo, phi = km.warp_box(pts[None], torch.ones((1, len(lanes)), dtype=torch.bool),
                           bgk_heavy.cull_reach(ell))
    plo, phi = plo[0].numpy(), phi[0].numpy()
    n = draw(st.integers(1, 40))
    ents = []
    for _ in range(n):
        if draw(st.booleans()):                          # on a padded face
            p = np.array([draw(st.floats(float(plo[i]), float(phi[i]), width=32))
                          for i in range(3)], F32)
            ax = draw(st.integers(0, 2))
            p[ax] = (plo if draw(st.booleans()) else phi)[ax]
            for _ in range(draw(st.integers(0, 3))):
                p[ax] = np.nextafter(p[ax], F32(draw(st.sampled_from([-np.inf, np.inf]))))
        else:                                            # at the support of a node
            v = pts[draw(st.integers(0, len(lanes) - 1))].numpy()
            off = np.array([draw(st.floats(-1, 1, width=32)) for _ in range(3)], np.float64)
            if not np.any(off):
                off[0] = 1.0
            off /= np.linalg.norm(off)
            r = bgk_heavy.R_CULL * ell * (1 + draw(st.integers(-8, 8)) * 2.0 ** -23)
            p = (v + off * r).astype(F32)
        if segments:
            d = np.array([draw(st.floats(-1, 1, width=32)) for _ in range(3)], F32)
            length = F32(draw(st.sampled_from([0.0, 5e-5, 0.3, 2.0])))
            q = (p + d * length).astype(F32)
            ents.append(np.concatenate([q, p] if draw(st.booleans()) else [p, q]))
        else:
            ents.append(p)
    ent = np.stack(ents).astype(F32)
    tb = np.full((1, G), 1, np.int64)
    tb[0, g] = 0
    case = dict(ent_rel=torch.from_numpy(ent), labels=torch.ones(n),
                ustart=torch.zeros(1, dtype=torch.int64),
                ucount=torch.tensor([n], dtype=torch.int64), tb_u=torch.from_numpy(tb),
                ext_nodes=ext)
    return case, G, ell


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_k1p_entries())
def test_k1p_cull_never_skips_a_nonzero_pair_on_the_box_faces(case):
    a, G, ell = case
    cull, nonzero = _k1p_cull_and_nonzero(a, G, ell)
    assert not (cull & nonzero).any()


def _segment_hits_box_f64(a, b, lo, hi):
    """Exact-ish reference: does the segment a → b meet [lo, hi] (f64)?"""
    t0, t1 = 0.0, 1.0
    for ax in range(3):
        u = b[ax] - a[ax]
        if u == 0:
            if not lo[ax] <= a[ax] <= hi[ax]:
                return False
            continue
        s0, s1 = (lo[ax] - a[ax]) / u, (hi[ax] - a[ax]) / u
        t0, t1 = max(t0, min(s0, s1)), min(t1, max(s0, s1))
    return t0 <= t1


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(-30, 30, width=32), min_size=12, max_size=12),
       st.floats(0.0, 1.0, width=32))
def test_segment_misses_box_never_misses_a_touching_segment(xs, reach):
    """Where a segment meets the unpadded box (in f64), the padded f32
    predicate never reports a miss, whatever the rounding."""
    a, b = np.array(xs[0:3], F32), np.array(xs[3:6], F32)
    lo, hi = np.minimum(xs[6:9], xs[9:12]).astype(F32), np.maximum(xs[6:9], xs[9:12]).astype(F32)
    # segments that end on the box's faces
    for e in (b, np.clip(b, lo, hi).astype(F32)):
        touches = _segment_hits_box_f64(a.astype(np.float64), e.astype(np.float64),
                                        lo.astype(np.float64) - reach,
                                        hi.astype(np.float64) + reach)
        plo, phi = km.pad_box(torch.from_numpy(lo), torch.from_numpy(hi), reach)
        miss = km.segment_misses_box(torch.from_numpy(a), torch.from_numpy(e - a), plo, phi)
        assert not (touches and bool(miss))


def _plan_numpy(rt, slots, pos, tpb, Vt):
    T, R = len(slots), len(rt)
    tile_rows = np.array([np.sum(rt < t) for t in range(T + 1)])
    key = slots.astype(np.int64) * tpb + pos
    mr = max(1, lv_rows.SCRATCH_BYTES // (8 * Vt))
    bounds, t0 = [], 0
    while t0 < T:           # greedy: as many whole tiles as fit in mr rows
        t1 = t0 + 1
        while t1 < T and (R <= mr or tile_rows[t1 + 1] - tile_rows[t0] <= mr):
            t1 += 1
        bounds.append((t0, t1, tile_rows[t0], tile_rows[t1]))
        t0 = t1
    return tile_rows, [(t0, t1, r0, r1, np.lexsort((np.arange(t1 - t0), key[t0:t1])))
                       for t0, t1, r0, r1 in bounds]


@pytest.mark.parametrize("max_rows", [None, 1, 5, 13])
@pytest.mark.parametrize("depth", [3, 5])
def test_lv_rows_plan_matches_a_direct_count(depth, max_rows, monkeypatch):
    """The plan under the default scratch cap (one chunk) and under caps of
    ``max_rows`` rows, set through SCRATCH_BYTES."""
    a = lv_rows_inputs(50 + depth, depth=depth, n_scans=12, tiles_per_scan=6)
    vbt, rt, slots, pos = a[4], a[8], a[11], a[12]
    tpb, Vt = vbt.shape[:2]
    if max_rows is not None:
        monkeypatch.setattr(lv_rows, "SCRATCH_BYTES", max_rows * 8 * Vt)
    tile_rows, chunks = lv_rows.lv_rows_plan(rt, slots, pos, tpb=tpb, Vt=Vt)
    tr, want = _plan_numpy(rt.numpy(), slots.numpy(), pos.numpy(), tpb, Vt)
    np.testing.assert_array_equal(tile_rows.numpy(), tr)
    assert [c[:4] for c in chunks] == [c[:4] for c in want]
    assert len(chunks) == (1 if max_rows is None else len(want)) and len(want) > (
        max_rows is not None)
    key = slots.long() * tpb + pos.long()
    units = 0
    for (t0, t1, r0, r1, apply), w in zip(chunks, want):
        np.testing.assert_array_equal(apply.numpy(), w[4])
        # a chunk holds at most max_rows rows, unless one tile alone has more
        assert max_rows is None or r1 - r0 <= max_rows or t1 - t0 == 1
        units += (r1 - r0) * ((Vt + 31) // 32)
        # within a chunk, each pool row's run of tiles goes in scan order
        k = key[t0:t1][apply]
        for row in torch.unique(k):
            tiles = apply[k == row]
            assert torch.equal(tiles, torch.sort(tiles)[0])
    assert units == len(rt) * ((Vt + 31) // 32)


def test_lv_rows_plan_a_pool_row_reached_by_every_scan(monkeypatch):
    """A pool row that all 12 scans of a dispatch reach: its 12 (scan, tile)
    sums are gated and added in scan order, and across chunks too."""
    a = lv_rows_inputs(61, depth=5, n_scans=12, tiles_per_scan=5)
    vbt, rt, slots, pos = a[4], a[8], a[11].clone(), a[12].clone()
    tpb, Vt = vbt.shape[:2]
    T = len(slots)
    first = torch.arange(0, T - 1, 5)                       # one tile of each scan
    slots[first], pos[first] = 2, 3
    for mr in (None, 9):
        if mr is not None:
            monkeypatch.setattr(lv_rows, "SCRATCH_BYTES", mr * 8 * Vt)
        _, chunks = lv_rows.lv_rows_plan(rt, slots, pos, tpb=tpb, Vt=Vt)
        assert len(chunks) > (mr is not None)
        seen = []
        for t0, t1, _, _, apply in chunks:
            k = (slots.long() * tpb + pos.long())[t0:t1][apply]
            seen += (apply[k == 2 * tpb + 3] + t0).tolist()
        assert seen == first.tolist()
