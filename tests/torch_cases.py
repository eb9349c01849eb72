"""Seeded inputs for the port's kernel tests (numpy and torch only, so the
card-side tests can use them on a machine without JAX)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from la3dm_tpu_torch.geometry import blocks as geo
from la3dm_tpu_torch.kernels.group_prune import (BGK_NEAR_VALUES, GP_NEAR_VALUES,
                                                 near_collapsible_rows, near_pool_values)
from la3dm_tpu_torch.models import posterior as po


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run PyTorch on one CPU thread for the test (autouse where imported):
    on several threads the first elementwise pass of a worker process was
    seen to return one thread's share perturbed by about 3e-4, enough to
    move the 1e-4 comparisons; on one thread every result is reproducible."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def segments_near(rng, starts):
    """Segments [N,6] from ``starts`` [N,3]: free rays of 0.05–0.8 m in
    random directions, with every 7th degenerate (a hit, end = start), every
    11th shorter than the 1e-4 threshold and every 13th along the z axis."""
    N = len(starts)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    length = rng.uniform(0.05, 0.8, (N, 1))
    i = np.arange(N)
    length[i % 11 == 5] = 5e-5
    d[i % 13 == 3] = [0.0, 0.0, 1.0]
    ends = starts + d * length
    ends[i % 7 == 0] = starts[i % 7 == 0]
    return np.concatenate([starts, ends], axis=1).astype(np.float32)


def heavy_inputs(seed, G=7, n_blocks=5, ell=0.2, dev="cpu", segments=False, depth=3,
                 res=0.1, counts=None, offset=0.0):
    """A small dispatch: entries round each test block (points, or segments
    [N,6] from :func:`segments_near`) within one block size of its centre,
    ragged rows of ≤ 64 merged entries per block, row_block non-decreasing;
    the all-level nodes of a block of ``depth`` at ``res``.  ``counts``
    gives each block's entries (else 0..149 at random), ``offset`` moves
    every block centre (and its entries) that far along each axis."""
    rng = np.random.default_rng(seed)
    nodes, _ = geo.all_level_nodes(res, depth)
    bs = res * 2 ** (depth - 1)
    if counts is not None:
        n_blocks = len(counts)
    centers = (rng.uniform(-1, 1, (n_blocks, 3)) + offset).astype(np.float32)
    per_block = rng.integers(0, 150, n_blocks) if counts is None else counts
    ent, lab, ids, gs, rb, rs, rn = [], [], [], [], [], [], []
    for b, cnt in enumerate(per_block):
        base = sum(len(e) for e in ent)
        e = (centers[b] + rng.uniform(-bs, bs, (cnt, 3))).astype(np.float32)
        ent.append(segments_near(rng, e) if segments else e)
        lab.append((rng.uniform(size=cnt) > 0.5).astype(np.float32))
        start = len(ids)
        ids.extend(base + rng.permutation(cnt))
        gs.extend(rng.integers(0, G, cnt))
        for r0 in range(0, cnt, 64):
            rb.append(b)
            rs.append(start + r0)
            rn.append(min(64, cnt - r0))
    out = dict(entries=np.concatenate(ent).reshape(-1, 6 if segments else 3).astype(np.float32),
               labels=np.concatenate(lab).astype(np.float32),
               ids=np.array(ids, np.int32), gslot=np.array(gs, np.int8),
               row_block=np.array(rb, np.int32), row_start=np.array(rs, np.int32),
               row_count=np.array(rn, np.int32), centers=centers, all_nodes=nodes)
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def light_inputs(seed, G=7, T=12, cap=32, dev="cpu", depth=3):
    rng = np.random.default_rng(seed)
    _, node_idx = geo.all_level_nodes(0.1, depth)
    V, Vall = node_idx.shape[1], int(node_idx.max()) + 1
    kbar = rng.uniform(-0.1, 3.0, (T, Vall, G)).astype(np.float32)
    kbar[rng.uniform(size=kbar.shape) < 0.4] = 0.0
    ybar = kbar * (rng.uniform(size=kbar.shape) > 0.3)
    acc = np.concatenate([ybar, kbar], axis=-1).astype(np.float32)
    for t in range(T // 2):  # uniform blocks, alternately occupied and free
        acc[t] = 0.0
        acc[t, :, G] = 1.0 + t
        acc[t, :, 0] = (t % 2) * (1.0 + t)
    slots = rng.permutation(cap)[:T].astype(np.int32)
    slots[-1] = cap                      # a padding slot
    A = np.full((cap, V), 0.001, np.float32)
    B = np.full((cap, V), 0.001, np.float32)
    touched = np.zeros((cap, V), bool)
    eff = np.zeros((cap, V), np.int8)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return t(acc), t(A), t(B), t(touched), t(eff), t(node_idx), t(slots)


#: (f0, f1) templates of :func:`collapsible_raster_pool`: Beta (A, B)
#: occupied and free, GP (m_ivar, ivar) occupied and free, far enough from
#: every threshold that a few scans' updates do not move a voxel's state
BETA_TEMPLATES = ((1000.0, 0.001), (0.001, 1000.0))
GP_TEMPLATES = ((1e4, 500.0), (-1e4, 500.0))


def collapsible_raster_pool(n, S, templates, seed=0):
    """Pool rows [S, n³] (raster, x fastest) that collapse at every level,
    the levels across 8³ tiles included: row i holds one (f0, f1) template
    per cube of edge (n, 8, 4, 2)[i % 4], with ±5 % noise so that collapse
    copies show, every voxel touched at eff 0; edge-2 rows also get 3 %
    stray voxels, so that their groups are not all uniform.  Returns
    (f0, f1, touched, eff) as numpy arrays."""
    rng = np.random.default_rng(seed)
    tmpl = np.asarray(templates, np.float32)
    vox = np.empty((S, n ** 3), np.int64)
    for i in range(S):
        edge = min((n, 8, 4, 2)[i % 4], n)
        g = n // edge
        t = rng.integers(0, len(tmpl), (g, g, g))
        vox[i] = t.repeat(edge, 0).repeat(edge, 1).repeat(edge, 2).reshape(-1)
        if edge == 2:
            stray = rng.uniform(size=n ** 3) < 0.03
            vox[i] = np.where(stray, rng.integers(0, len(tmpl), n ** 3), vox[i])
    f = tmpl[vox] * rng.uniform(0.95, 1.05, (S, n ** 3, 2)).astype(np.float32)
    return (np.ascontiguousarray(f[..., 0]), np.ascontiguousarray(f[..., 1]),
            np.ones((S, n ** 3), bool), np.zeros((S, n ** 3), np.int8))


#: LV state parameters of the prune cases: the three (A, B) templates below
#: classify OCCUPIED, FREE and UNCERTAIN, untouched voxels UNKNOWN
LV_STATE = dict(min_W=0.001, var_thresh=0.2, free_thresh=0.3, occupied_thresh=0.7)


def lv_prune_inputs(seed, n=16, B=20, cap=28, dev="cpu"):
    """A tile-major pool [cap, n³] whose blocks collapse at every level:
    kind 0 blocks hold one (A, B) template, kind 1 one per 16³ group, kind 2
    one per 8³ tile (the first tile already collapsed to level 3), kind 3
    one per 4³ group, kind 4 one per 2³ group with 3 % stray voxels and
    untouched ones.  Values carry
    ±5 % noise so that collapse copies are visible.  Returns (A, B,
    touched, eff, slots) with a padding slot (== cap) last."""
    rng = np.random.default_rng(seed)
    tmpl = np.array([[5.0, 0.5], [0.5, 5.0], [1.0, 1.0]], np.float32)
    te = min(8, n)

    def per_cube(edge):            # one template per edge³ cube, raster z,y,x
        g = max(n // edge, 1)
        t = rng.integers(0, 3, (g, g, g))
        k = n // g
        return t.repeat(k, 0).repeat(k, 1).repeat(k, 2)

    kind = np.arange(B) % 5
    vox = np.stack([per_cube({0: n, 1: 16, 2: te, 3: 4, 4: 2}[k]) for k in kind])
    vox = vox.reshape(B, -1)
    stray = (rng.uniform(size=vox.shape) < 0.03) & (kind == 4)[:, None]
    vox = np.where(stray, rng.integers(0, 3, vox.shape), vox)
    AB = tmpl[vox] * rng.uniform(0.95, 1.05, (B, n ** 3, 2)).astype(np.float32)
    touched = (rng.uniform(size=vox.shape) > 0.05) | (kind != 4)[:, None]
    eff = np.zeros(vox.shape, np.int8)
    if n >= 8:                     # kind 2: the first tile already collapsed
        tile0 = np.zeros((n, n, n), bool)
        tile0[:8, :8, :8] = True
        tile0 = tile0.reshape(-1)
        for b in range(2, B, 5):
            AB[b, tile0] = AB[b, 0]
            eff[b, tile0] = 3
    perm = geo.tile_vox_map(n).reshape(-1)          # raster → stored columns
    V = n ** 3
    A = np.full((cap, V), 0.001, np.float32)
    Bv = np.full((cap, V), 0.001, np.float32)
    T = np.zeros((cap, V), bool)
    E = np.zeros((cap, V), np.int8)
    slots = rng.permutation(cap)[:B].astype(np.int32)
    A[slots] = AB[..., 0][:, perm]
    Bv[slots] = AB[..., 1][:, perm]
    T[slots] = touched[:, perm]
    E[slots] = eff[:, perm]
    slots = np.concatenate([slots, [cap]]).astype(np.int32)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return t(A), t(Bv), t(T), t(E), t(slots)


#: LV templates of the near-collapsible pools under :data:`LV_STATE`:
#: state → (A, B, touched); UNKNOWN voxels are untouched
LV_NEAR_VALUES = {po.OCCUPIED: (5.0, 0.5, True), po.FREE: (0.5, 5.0, True),
                  po.UNCERTAIN: (1.0, 1.0, True), po.UNKNOWN: (5.0, 0.5, False)}


def near_lv_prune_inputs(seed, n=16, B=20, cap=28, dev="cpu"):
    """:func:`lv_prune_inputs` with near-collapsible blocks
    (:func:`near_collapsible_rows`, OCCUPIED, FREE and UNCERTAIN groups):
    returns (A, B, touched, eff, slots), tile-major, a padding slot last."""
    rng = np.random.default_rng(seed)
    st, eff = near_collapsible_rows(n, B, (po.FREE, po.OCCUPIED, po.UNCERTAIN),
                                    seed=seed)
    A0, B0, T0 = near_pool_values(st, LV_NEAR_VALUES, seed=seed + 1)
    perm = geo.tile_vox_map(n).reshape(-1)          # raster → stored columns
    V = n ** 3
    A = np.full((cap, V), 0.001, np.float32)
    Bv = np.full((cap, V), 0.001, np.float32)
    T = np.zeros((cap, V), bool)
    E = np.zeros((cap, V), np.int8)
    slots = rng.permutation(cap)[:B].astype(np.int32)
    A[slots], Bv[slots], T[slots], E[slots] = (x[:, perm] for x in (A0, B0, T0, eff))
    slots = np.concatenate([slots, [cap]]).astype(np.int32)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return t(A), t(Bv), t(T), t(E), t(slots)


def lv_rows_inputs(seed, depth=5, n_scans=3, tiles_per_scan=5, cap=6, res=0.1,
                   ell=0.2, dev="cpu"):
    """One multi-scan row-engine dispatch in the map's argument order:
    per scan a tile list in pool-row order (some pool tiles reached by
    several scans), each tile's own entries — hits (degenerate segments)
    and free rays from a far origin ending near it, one of them along an
    axis — plus a few of the scan's other entries, cut into rows of ≤ 64;
    a padding tile (slot == cap) last.  Pool A/B near the prior, a few
    voxels at eff > 0."""
    rng = np.random.default_rng(seed)
    n = 2 ** (depth - 1)
    te = min(8, n)
    Vt, tpb = te ** 3, (n // te) ** 3
    V = n ** 3
    vbt = geo.voxel_offsets(res, depth)[geo.tile_vox_map(n)]       # [tpb,Vt,3]
    coords = np.stack([np.arange(cap), rng.integers(-2, 3, cap),
                       rng.integers(-2, 3, cap)], 1)
    ctr_of = geo.block_center(coords, res * n)
    pool_tiles = [(int(s), int(p)) for s, p in zip(rng.integers(0, cap, 3 * tiles_per_scan),
                                                   rng.integers(0, tpb, 3 * tiles_per_scan))]
    pool_tiles = sorted(set(pool_tiles))
    ent, lab, ids, rt, rs, rn, slots, pos, ctr = [], [], [], [], [], [], [], [], []
    for _ in range(n_scans):
        pick = sorted(rng.choice(len(pool_tiles), tiles_per_scan, replace=False))
        scan_ids = []
        for i in pick:
            s, p = pool_tiles[i]
            vox = ctr_of[s] + vbt[p]
            lo, hi = vox.min(0) - ell, vox.max(0) + ell
            nh, nr = rng.integers(0, 40), rng.integers(0, 90)
            h = rng.uniform(lo, hi, (nh, 3))
            end = rng.uniform(lo, hi, (nr, 3))
            d = rng.normal(size=(nr, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            start = end - d * rng.uniform(0.5, 3.0, (nr, 1))
            if nr:
                start[0, :2] = end[0, :2]           # a ray along the z axis
            e = np.concatenate([np.concatenate([h, h], 1),
                                np.concatenate([start, end], 1)]).astype(np.float32)
            base = sum(len(x) for x in ent)
            ent.append(e)
            lab.append(np.concatenate([np.ones(nh), np.zeros(nr)]).astype(np.float32))
            own = base + rng.permutation(len(e))
            other = rng.choice(scan_ids, min(len(scan_ids), 5), replace=False) \
                if scan_ids else np.zeros(0, np.int64)
            tid = np.concatenate([own, other]).astype(np.int64)
            scan_ids.extend(own.tolist())
            start_f = len(ids)
            ids.extend(tid.tolist())
            t = len(slots)
            for r0 in range(0, len(tid), 64):
                rt.append(t)
                rs.append(start_f + r0)
                rn.append(min(64, len(tid) - r0))
            slots.append(s)
            pos.append(p)
            ctr.append(ctr_of[s])
    # a padding tile with one row
    rt.append(len(slots))
    rs.append(0)
    rn.append(min(64, len(ids)))
    slots.append(cap)
    pos.append(0)
    ctr.append(np.zeros(3, np.float32))
    A = (0.001 + rng.uniform(0, 0.5, (cap, V)) * (rng.uniform(size=(cap, V)) < 0.3))
    Bv = (0.001 + rng.uniform(0, 0.5, (cap, V)) * (rng.uniform(size=(cap, V)) < 0.3))
    touched = rng.uniform(size=(cap, V)) < 0.2
    eff = (rng.uniform(size=(cap, V)) < 0.05).astype(np.int8) * 2
    arrs = (A.astype(np.float32), Bv.astype(np.float32), touched, eff,
            vbt.astype(np.float32), np.concatenate(ent), np.concatenate(lab),
            np.array(ids, np.int32), np.array(rt, np.int32), np.array(rs, np.int32),
            np.array(rn, np.int32), np.array(slots, np.int32), np.array(pos, np.int32),
            np.array(ctr, np.float32))
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrs)


#: the statics of lv_rows_inputs' dispatch
LV_ROWS_STATICS = dict(sf2=0.1, ell=0.2, free_res=0.1, gate=0.001)


#: GP parameters of the K4/K5 cases (gpoctomap.yaml): sf2, ell, noise and
#: the BCM / state constants min_known_ivar = 1/max_known_var, max_ivar =
#: 1/min_var
GP_STATICS = dict(sf2=1.0, ell=1.0, noise=0.01)
GP_BCM = dict(sf2=1.0, min_known_ivar=50.0, max_ivar=1000.0)
GP_STATE = dict(l=100.0, max_ivar=1000.0, min_known_ivar=50.0, free_thresh=0.3,
                occupied_thresh=0.7)


def gp_heavy_inputs(seed, depth=3, S=128, n_models=12, G=7, dev="cpu", counts=None):
    """One size tier of a GP heavy dispatch: ``n_models`` block models with
    counts in (S/2, S] (one of them a single point), or ``counts``; points
    round each model's block, labels ±1, sorted by model; a test-block list of
    2·n_models blocks near the models, each model serving a distinct row
    at every slot (a few slots serve none: row == Tp).  Returns the
    wrapper's arguments as a dict, with fresh tables (mean 0, var 1,
    present False) and a zero ``failed`` counter."""
    rng = np.random.default_rng(seed)
    res = 0.1 if depth == 3 else 0.2
    n = 2 ** (depth - 1)
    nodes, _ = geo.all_level_nodes(res, depth)
    bs = res * n
    if counts is None:
        counts = rng.integers(S // 2 + 1, S + 1, n_models)
        counts[0] = 1
    counts = np.asarray(counts)
    n_models = len(counts)
    mc = rng.integers(-3, 4, (n_models, 3)) * bs
    pts = np.concatenate([mc[m] + rng.uniform(-bs / 2, bs / 2, (c, 3))
                          for m, c in enumerate(counts)]).astype(np.float32)
    lab = np.where(rng.uniform(size=len(pts)) < 0.4, 1.0, -1.0).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    Tp = 2 * n_models
    centers = (mc[rng.integers(0, n_models, Tp)]
               + rng.integers(-1, 2, (Tp, 3)) * bs).astype(np.float32)
    nb = np.stack([rng.permutation(Tp)[:n_models] for _ in range(G)], 1)
    nb[rng.uniform(size=nb.shape) < 0.1] = Tp
    out = dict(pts=pts, lab=lab, starts=starts.astype(np.int32),
               counts=counts.astype(np.int32), nb_rows=nb.astype(np.int32),
               centers=centers, all_nodes=nodes,
               acc_mean=np.zeros((Tp * G, len(nodes)), np.float32),
               acc_var=np.ones((Tp * G, len(nodes)), np.float32),
               present=np.zeros(Tp * G, bool), failed=np.zeros(1, np.int32))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in out.items()}


def gp_light_inputs(seed, depth=3, T=12, cap=32, G=7, dev="cpu"):
    """Prediction tables of T test blocks and a pool at the prior (m_ivar 0,
    ivar 1/max_var): the first T/2 blocks see confident predictions (mean
    ±1, var 0.01) from every slot, one sign per block, per 2³ group or per
    voxel (of the level-0 nodes), so that they collapse to the block root,
    to level 1 (and beyond where groups agree) or not at all; the rest see
    random means and
    variances (some exactly 0, the padded-row guard) from random slots, and
    one of them from none.  A padding slot (== cap) is last.  Returns
    (acc_mean, acc_var, present, m_ivar, ivar, touched, eff, node_idx,
    slots)."""
    rng = np.random.default_rng(seed)
    _, node_idx = geo.all_level_nodes(0.1, depth)
    V, Vall = node_idx.shape[1], int(node_idx.max()) + 1
    mean = rng.uniform(-1.0, 1.0, (T, G, Vall)).astype(np.float32)
    var = rng.uniform(0.005, 1.0, (T, G, Vall)).astype(np.float32)
    var[rng.uniform(size=var.shape) < 0.02] = 0.0
    present = rng.uniform(size=(T, G)) < 0.6
    n = 2 ** (depth - 1)
    v = np.arange(V)
    x, y, z = v % n, (v // n) % n, v // (n * n)
    for t in range(T // 2):
        kind = t % 3
        sign = {0: np.full(V, (-1) ** (t // 3)), 1: (-1) ** (x // 2 + y // 2 + z // 2),
                2: (-1) ** (x + y + z)}[kind]
        mean[t] = sign[0]
        mean[t][:, :V] = sign            # the level-0 nodes are the voxels
        var[t] = 0.01
        present[t] = True
    present[T // 2] = False
    slots = rng.permutation(cap)[:T].astype(np.int32)
    slots[-1] = cap
    m_ivar = np.zeros((cap, V), np.float32)
    ivar = np.full((cap, V), 1.0 / 1000.0, np.float32)
    touched = np.zeros((cap, V), bool)
    eff = np.zeros((cap, V), np.int8)
    arrs = (mean.reshape(T * G, Vall), var.reshape(T * G, Vall), present.reshape(-1),
            m_ivar, ivar, touched, eff, node_idx, slots)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrs)


def near_gp_light_inputs(seed, depth=3, T=24, cap=32, G=7, dev="cpu"):
    """:func:`gp_light_inputs` with near-collapsible blocks
    (:func:`near_collapsible_rows`, OCCUPIED and FREE groups) and tables
    that move no state: means in [-1, 1] and variances in [1, 2] (some 0,
    the padded-row guard) from random slots, one block from none, so that
    each voxel's m_ivar moves by at most G and its ivar falls by at most
    G/2.  Returns the same tuple."""
    rng = np.random.default_rng(seed)
    _, node_idx = geo.all_level_nodes(0.1, depth)
    V, Vall = node_idx.shape[1], int(node_idx.max()) + 1
    n = 2 ** (depth - 1)
    mean = rng.uniform(-1.0, 1.0, (T, G, Vall)).astype(np.float32)
    var = rng.uniform(1.0, 2.0, (T, G, Vall)).astype(np.float32)
    var[rng.uniform(size=var.shape) < 0.02] = 0.0
    present = rng.uniform(size=(T, G)) < 0.6
    present[T // 2] = False
    st, eff0 = near_collapsible_rows(n, T - 1, (po.FREE, po.OCCUPIED), seed=seed)
    mi0, iv0, t0 = near_pool_values(st, GP_NEAR_VALUES, seed=seed + 1)
    slots = rng.permutation(cap)[:T].astype(np.int32)
    slots[-1] = cap
    m_ivar = np.zeros((cap, V), np.float32)
    ivar = np.full((cap, V), 1.0 / 1000.0, np.float32)
    touched = np.zeros((cap, V), bool)
    eff = np.zeros((cap, V), np.int8)
    sl = slots[:-1]
    m_ivar[sl], ivar[sl], touched[sl], eff[sl] = mi0, iv0, t0, eff0
    arrs = (mean.reshape(T * G, Vall), var.reshape(T * G, Vall), present.reshape(-1),
            m_ivar, ivar, touched, eff, node_idx, slots)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrs)


def near_bgk_light_inputs(seed, depth=3, T=24, cap=32, G=7, gated=False, dev="cpu"):
    """:func:`light_inputs` with near-collapsible blocks
    (:func:`near_collapsible_rows`, OCCUPIED and FREE groups, the templates
    of ``BGK_NEAR_VALUES``) and an accumulator that moves no state: ȳ and
    k̄ multiples of 1/8 in [0, 1] (some k̄ 0 or negative, which the gate at
    0 leaves out), so that every order of summing the slots is exact and
    each voxel's A and B move by at most G; with ``gated`` every k̄ is at or
    below 0, so that no slot passes the gate and the generator's states
    reach the prune as made.  Returns (acc, A, B, touched, eff, node_idx,
    slots)."""
    rng = np.random.default_rng(seed)
    _, node_idx = geo.all_level_nodes(0.1, depth)
    V, Vall = node_idx.shape[1], int(node_idx.max()) + 1
    n = 2 ** (depth - 1)
    kbar = rng.integers(0, 9, (T, Vall, G)).astype(np.float32) / 8
    kbar[rng.uniform(size=kbar.shape) < 0.2] = -0.125
    if gated:
        kbar = -np.abs(kbar) * (rng.uniform(size=kbar.shape) < 0.5)
    ybar = np.minimum(kbar, rng.integers(0, 9, kbar.shape) / 8).astype(np.float32)
    acc = np.concatenate([ybar, kbar], axis=-1).astype(np.float32)
    st, eff0 = near_collapsible_rows(n, T - 1, (po.FREE, po.OCCUPIED), seed=seed)
    A0, B0, t0 = near_pool_values(st, BGK_NEAR_VALUES, seed=seed + 1)
    slots = rng.permutation(cap)[:T].astype(np.int32)
    slots[-1] = cap                      # a padding slot
    A = np.full((cap, V), 0.001, np.float32)
    B = np.full((cap, V), 0.001, np.float32)
    touched = np.zeros((cap, V), bool)
    eff = np.zeros((cap, V), np.int8)
    sl = slots[:-1]
    A[sl], B[sl], touched[sl], eff[sl] = A0, B0, t0, eff0
    arrs = (acc, A, B, touched, eff, node_idx, slots)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrs)


def member_entries(seed, E=1500, corners=False, dev="cpu"):
    """Entries for K7c (0.4 m blocks, 3 scans): each strictly inside a block
    or on one, two or three of its face planes (1, 2, 4 or 8 memberships;
    with ``corners`` three in four on a corner), valid but for two runs of
    600 and 100 invalid entries (the first spans a 512-entry tile edge) and
    a tenth at random.  Returns (ent [E,3] f32, scan [E] int32, evalid [E],
    anchors [3,3] int32)."""
    rng = np.random.default_rng(seed)
    bs = np.float32(0.4)
    c = rng.integers(-6, 7, (E, 3))
    faces = rng.integers(0, 4, E) if not corners else np.where(
        rng.uniform(size=E) < 0.75, 3, rng.integers(0, 3, E))
    on = np.argsort(rng.uniform(size=(E, 3)), axis=1) < faces[:, None]
    inside = rng.uniform(-0.15, 0.15, (E, 3)).astype(np.float32)
    face = np.where(rng.uniform(size=(E, 3)) < 0.5, np.float32(0.2), np.float32(-0.2))
    ent = (c.astype(np.float32) * bs + np.where(on, face, inside)).astype(np.float32)
    valid = rng.uniform(size=E) > 0.1
    valid[100:700] = False
    valid[1000:1100] = False
    scan = rng.integers(0, 3, E).astype(np.int32)
    anchors = rng.integers(-3, 4, (3, 3)).astype(np.int32)
    arrs = (ent, scan, valid, anchors)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrs)


#: device-ingest parameters of ingest_scene (the BGK demo's leaves, an 8 m
#: range, 0.4 m blocks)
INGEST = dict(ds=0.1, fr=0.5, mr=8.0, block_size=0.4)


def ingest_scene(seed, n_scans=3, n=400, dev="cpu"):
    """Raw clouds of ``n_scans`` scans, concatenated as the map hands them to
    device ingest: per scan a noisy box room round an origin (the first
    origin on a block face, y = −0.2, with 30 copies of itself in its cloud),
    one far outlier and a few points beyond the range.  Returns (pts [N,3],
    scan [N] int32, origins [K,3], cell anchors, block anchors)."""
    from la3dm_tpu_torch.geometry import device_ingest

    rng = np.random.default_rng(seed)
    pts, scan, origins = [], [], []
    for s in range(n_scans):
        o = np.array([0.1 + 0.3 * s, -0.2, 0.3], np.float32)
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        t = np.min(np.abs(np.where(d > 0, 4.0, -3.0) / np.where(d == 0, 1e-9, d)), axis=1)
        c = o + d * (t + rng.normal(0, 0.01, n))[:, None]
        extra = [np.repeat(o[None], 30 if s == 0 else 0, 0),
                 np.float32([[-200.0, -200.0, -200.0]]),
                 o + rng.uniform(9.0, 12.0, (5, 3))]
        c = np.concatenate([c, *extra]).astype(np.float32)
        pts.append(c)
        scan.append(np.full(len(c), s, np.int32))
        origins.append(o)
    origins = np.stack(origins)
    arrs = (np.concatenate(pts), np.concatenate(scan), origins,
            device_ingest.anchors(origins, INGEST["ds"]),
            device_ingest.anchors(origins, INGEST["block_size"]))
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrs)


def beam_kwargs(fr=INGEST["fr"], mr=INGEST["mr"], ds=INGEST["ds"]) -> dict:
    """K7a's beam arguments (kf, mr, fr, inv_leaf) in f32, as ingest_batch
    passes them."""
    from la3dm_tpu_torch.geometry import device_ingest

    f32 = np.float32
    return dict(kf=device_ingest.beam_slots(ds, fr, mr, INGEST["block_size"]),
                mr=float(f32(mr)), fr=float(f32(fr)), inv_leaf=float(f32(1.0 / ds)))


def beam_edge_hits(fr, mr=INGEST["mr"], dev="cpu"):
    """Hits of one scan at K7a's boundaries, along +x from an origin on a
    cell face (x = 0, so each hit's range is its offset exactly and the
    samples at multiples of fr sit on cell faces): beyond mr, at the origin,
    within fr, at fr, at 6·fr in f32 and one ulp either side, at mr.
    Returns (hits [8,3], their keys, origins [1,3], cell anchors, names,
    the samples each keeps)."""
    from la3dm_tpu_torch.geometry import device_ingest
    from la3dm_tpu_torch.kernels import ingest_beams

    f32 = np.float32
    d6 = float(f32(6) * f32(fr))
    kf = int(np.floor(mr / fr)) + 1
    last = sum(float(f32(k + 1) * f32(fr)) < float(f32(mr)) for k in range(kf))

    def ulp(x, toward):
        return float(np.nextafter(f32(x), f32(toward)))

    cases = [("beyond mr", ulp(mr, 2 * mr), 0), ("at the origin", 0.0, 0),
             ("within fr", 0.5 * fr, 1), ("at fr", float(f32(fr)), 1),
             ("at 6 fr", d6, 5 + 2), ("below 6 fr", ulp(d6, 0), 5 + 2),
             ("above 6 fr", ulp(d6, 10), 6 + 2), ("at mr", float(f32(mr)), last + 2)]
    origins = torch.tensor([[0.0, -0.05, 0.33]], dtype=torch.float32)
    hits = (origins + torch.tensor([[x, 0.0, 0.0] for _, x, _ in cases])).contiguous()
    anchors = torch.from_numpy(device_ingest.anchors(origins.numpy(), INGEST["ds"]))
    keys = ingest_beams.point_keys_plain(hits, torch.zeros(len(hits), dtype=torch.int32),
                                         origins, anchors,
                                         inv_leaf=beam_kwargs()["inv_leaf"], lim=float("inf"))
    return (*(x.to(dev) for x in (hits, keys, origins, anchors)), [c for c, _, _ in cases],
            [k for _, _, k in cases])


def bucket_inputs(seed, G=7, D=3, long_run=0, dev="cpu"):
    """K7t's arguments (as ``device_ingest._bucket`` passes them, the sorts
    by their plain versions) on memberships of random blocks round one scan's
    anchor: a full 3×3×3 cube of blocks (its centre a test block fed at all
    G slots), 300 blocks at random, each run 1-40 memberships, one of
    ``long_run``; entries [E,D] (D = 6: segments), a tenth of them unused.
    Returns (args, kwargs) of ``ingest_bucket.bucket``."""
    from la3dm_tpu_torch.kernels import ingest_keys, ingest_sort

    rng = np.random.default_rng(seed)
    anchors = torch.from_numpy(rng.integers(-50, 50, (1, 3)).astype(np.int32))
    cube = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"), -1).reshape(-1, 3)
    blocks = np.concatenate([cube, rng.integers(-12, 13, (300, 3))]) + anchors.numpy()
    counts = rng.integers(1, 41, len(blocks))
    counts[5] = max(counts[5], long_run)
    coords = torch.from_numpy(np.repeat(blocks, counts, 0))
    mkey = ingest_keys.pack(torch.zeros(len(coords), dtype=torch.int32), coords, anchors)
    mkey = mkey[torch.from_numpy(rng.permutation(len(mkey)))]
    E = int(len(mkey) * 1.1)
    mrow = torch.from_numpy(rng.permutation(E)[:len(mkey)].astype(np.int32))
    ent = torch.from_numpy(rng.normal(0, 5, (E, D)).astype(np.float32))
    lab = torch.from_numpy(rng.random(E).astype(np.float32))
    window = ingest_sort.block_window(8.0, 0.1, 0.4, 1)
    runs = ingest_sort.sort_runs_plain(mkey, window, want_rid=True)
    offsets = geo.FACE_NEIGHBOR_OFFSETS if G == 7 else geo.full_neighbor_offsets()
    off = torch.from_numpy(ingest_keys.pack_offsets(offsets))
    cand = ingest_sort.sort_runs_plain((runs.ukey[:, None] + off[None, :]).reshape(-1),
                                       window.wider(1))
    args = (runs.perm, runs.rid, mrow, ent, lab, runs.ukey, cand.ukey, cand.perm,
            cand.starts, cand.counts, off, anchors)
    return tuple(x.to(dev) for x in args), {"block_size": 0.4}


def aligned_heavy_inputs(seed, G=7, U=40, T=60, dev="cpu", segments=False, depth=3, res=0.1,
                         spread=0.3, counts=None):
    """K1′'s arguments on random tables: U entry blocks of 0..150 entries
    (or of ``counts``; relative coordinates within ±``spread`` m — points,
    or segments [M,6] from :func:`segments_near` —, labels 0/1) stored back
    to back, T test blocks whose slots name an entry block or none (U), and
    the shifted node tables of a block of ``depth`` at ``res`` (the default:
    the depth-3 demo's 0.4 m blocks).  Returns a dict of the wrapper's
    arguments."""
    rng = np.random.default_rng(seed)
    nodes, _ = geo.all_level_nodes(res, depth)
    bs = np.float32(res * 2 ** (depth - 1))
    offs = geo.FACE_NEIGHBOR_OFFSETS if G == 7 else geo.full_neighbor_offsets()
    ext = (nodes[None] - offs[:, None, :].astype(np.float32) * bs).reshape(-1, 3)
    ucount = rng.integers(0, 150, U)
    if counts is not None:
        ucount = np.asarray(counts)
        U = len(ucount)
    ustart = np.concatenate([[0], np.cumsum(ucount)[:-1]])
    M = int(ucount.sum()) + 3
    ent_rel = rng.uniform(-spread, spread, (M, 3)).astype(np.float32)
    if segments:
        ent_rel = segments_near(rng, ent_rel)
    labels = (rng.uniform(size=M) > 0.5).astype(np.float32)
    tb_u = rng.integers(0, U + 1, (T, G))
    out = dict(ent_rel=ent_rel, labels=labels, ustart=ustart.astype(np.int64),
               ucount=ucount.astype(np.int64), tb_u=tb_u.astype(np.int64),
               ext_nodes=ext.astype(np.float32))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in out.items()}


def ray_inputs(seed, dev="cpu"):
    """K7d's arguments: the downsampled hits of :func:`ingest_scene` (3 scans,
    the first origin on a block face) with their keys, the origins and the
    block anchors, and the statics of :data:`INGEST` (Kf = 17)."""
    from la3dm_tpu_torch.geometry import device_ingest
    from la3dm_tpu_torch.kernels import ingest_beams

    pts, scan, origins, ca, ba = ingest_scene(seed, dev=dev)
    ds, fr, mr, bs = INGEST["ds"], INGEST["fr"], INGEST["mr"], INGEST["block_size"]
    keys = ingest_beams.point_keys_plain(pts, scan, origins, ca,
                                         inv_leaf=float(np.float32(1 / ds)),
                                         lim=float(np.float32((mr + np.sqrt(3.0) * ds) ** 2)))
    hkey, hits = device_ingest._downsample(pts, keys, ca, float(np.float32(ds)))
    kw = dict(kf=device_ingest.beam_slots(ds, fr, mr, bs), mr=float(np.float32(mr)),
              fr=float(np.float32(fr)), block_size=bs)
    return (hits, hkey, origins, ba), kw


#: (max_range, free_resolution, block size): the BGKL demo (S = 28), the
#: BGKL large map (S = 6) and the demo's blocks at fr 0.1 (S = 82)
RAY_CONFIGS = {"demo": (8.0, 0.3, 0.4), "large_map": (30.0, 6.5, 3.2), "fine": (8.0, 0.1, 0.4)}
F32 = np.float32


def ray_slots(mr: float, fr: float) -> int:
    """Kf, the backward samples a beam (``device_ingest.beam_slots``)."""
    return int(np.floor(mr / fr)) + 1


def face(c: int, bs: float) -> np.float32:
    """The f32 coordinate of the upper face of block c, as the closed-box
    test computes it: ctr + half."""
    return F32(F32(c) * F32(bs)) + F32(bs / 2.0)


def ray_args(origins, scan, dirs, lengths, bs, dev="cpu"):
    """K7d's arguments for rays from ``origins[scan]`` along ``dirs`` of
    ``lengths`` (f32 hits = origin + dir·length)."""
    from la3dm_tpu_torch.geometry import device_ingest

    origins = np.asarray(origins, F32)
    hits = (origins[scan] + np.asarray(dirs, F32) * np.asarray(lengths, F32)[:, None]).astype(F32)
    keys = np.asarray(scan, np.int64) << 48
    anchors = device_ingest.anchors(origins, bs)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (hits, keys, origins, anchors))


def edge_rays(config: str, seed: int = 0, n_random: int = 300, dev="cpu"):
    """(args, kw) of rays that stress the rule: from origins whose other two
    coordinates sit on block faces (each ray along an axis then runs on a
    block edge, and its length is exact), along ±x, ±y, ±z with lengths k·fr
    and one ulp either side, the range and one ulp either side, longer than
    the range and zero; diagonals in the face planes; random rays from an
    origin on three faces and from a generic one."""
    mr, fr, bs = RAY_CONFIGS[config]
    kf = ray_slots(mr, fr)
    rng = np.random.default_rng(seed)
    f = [face(c, bs) for c in (-2, 1, 3)]
    origins = [[F32(0), f[0], f[1]], [f[2], F32(0), f[0]], [f[1], f[2], F32(0)],
               [f[0], f[1], f[2]], [F32(0.137), F32(-0.291), F32(0.053)]]
    lens = []
    for k in sorted({1, 2, kf // 2, kf - 1, kf}):
        if k >= 1:
            x = F32(F32(k) * F32(fr))
            lens += [x, np.nextafter(x, F32(0)), np.nextafter(x, F32(np.inf))]
    m = F32(mr)
    lens += [m, np.nextafter(m, F32(0)), np.nextafter(m, F32(np.inf)), F32(mr + 1.0), F32(0),
             F32(bs * 3), F32(mr * 0.77)]
    scan, dirs, lengths = [], [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            d = np.zeros(3, F32)
            d[axis] = sign
            for x in lens:
                scan.append(axis)
                dirs.append(d)
                lengths.append(x)
    for a, b in ((0, 1), (1, 2), (0, 2)):     # diagonals in a face plane
        for sa, sb in ((1, 1), (1, -1), (-1, -1)):
            d = np.zeros(3, F32)
            d[a], d[b] = sa * F32(np.sqrt(0.5)), sb * F32(np.sqrt(0.5))
            for x in lens:
                scan.append(3)
                dirs.append(d)
                lengths.append(x)
    d = rng.normal(size=(n_random, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    scan += list(rng.integers(3, 5, n_random))
    dirs += list(d.astype(F32))
    lengths += list(rng.uniform(0, 1.1 * mr, n_random).astype(F32))
    args = ray_args(origins, np.asarray(scan), np.stack(dirs), np.asarray(lengths, F32), bs,
                    dev)
    return args, dict(kf=kf, mr=float(F32(mr)), fr=float(F32(fr)), block_size=bs)


def raycast_inputs(seed, n_rays=3000, depth=3, res=0.1, dev="cpu"):
    """K6's arguments over a synthetic map: a 7 × 7 × 3 slab of blocks (a
    tenth of them absent) round the origin, each voxel FREE, OCCUPIED (4 %)
    or UNKNOWN (10 %), the pool slots shuffled, and its block hash; rays
    from random origins inside the slab (some in absent blocks), every 10th
    along an axis (|d| < 1e-12 on the others), 8 m range.  Returns
    (args, kw) for ``kernels.raycast.raycast``."""
    from la3dm_tpu_torch.models import raycast as rc

    rng = np.random.default_rng(seed)
    n = 2 ** (depth - 1)
    bs, V = res * n, n ** 3
    g = np.stack(np.meshgrid(np.arange(-3, 4), np.arange(-3, 4), np.arange(-1, 2),
                             indexing="ij"), -1).reshape(-1, 3)
    coords = g[rng.uniform(size=len(g)) > 0.1]
    cap = len(coords) + 5
    slots = rng.permutation(cap)[:len(coords)].astype(np.int32)
    state = rng.choice([0, 1, 2], size=(cap, V), p=[0.86, 0.04, 0.10]).astype(np.int8)
    state = np.concatenate([state, np.full((1, V), 2, np.int8)])
    hi, lo, sl, H, maxp = rc._build_block_hash(coords, slots, cap)
    origins = rng.uniform(-3 * bs, 3 * bs, (n_rays, 3)).astype(np.float32)
    origins[:, 2] *= 0.3
    d = rng.normal(size=(n_rays, 3))
    axis = np.arange(n_rays) % 10 == 0
    d[axis] = np.eye(3)[rng.integers(0, 3, int(axis.sum()))] * rng.choice([-1, 1], (int(
        axis.sum()), 1))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    args = (t(state), t(hi), t(lo), t(sl), t(origins), t(d))
    kw = dict(res=res, bs=bs, n=n, max_steps=int(np.ceil(8.0 / res) * 3 + 8), target=1,
              max_range=8.0, max_probes=max(4, 1 << int(np.ceil(np.log2(maxp)))))
    return args, kw


def raycast_chain_inputs(dev="cpu", res=0.1, depth=3, n_blocks=16):
    """K6's arguments over a column of ``n_blocks`` blocks along +y from the
    origin: the block hash leaves y out of the probe start below 2^20
    entries, so the column is one probe chain of ``n_blocks`` = max_probes
    entries (the last block's lookup takes max_probes probes; the absent
    block after it, at the same start, takes max_probes probes and finds
    nothing).  Every voxel FREE but those of the last block (OCCUPIED).
    Rays: from below the column along +y (hit in the last block), from
    inside the last block (hit at step 0), from past the column along +y
    (never hit), each with a slight tilt and straight along the axis.
    Returns (args, kw) for ``kernels.raycast.raycast``."""
    from la3dm_tpu_torch.models import raycast as rc

    n = 2 ** (depth - 1)
    bs, V = res * n, n ** 3
    coords = np.stack([np.zeros(n_blocks), np.arange(n_blocks), np.zeros(n_blocks)],
                      1).astype(np.int64)
    cap = n_blocks + 3
    slots = np.random.default_rng(0).permutation(cap)[:n_blocks].astype(np.int32)
    state = np.zeros((cap + 1, V), np.int8)
    state[slots[-1]] = 1
    state[cap] = 2
    hi, lo, sl, H, maxp = rc._build_block_hash(coords, slots, cap)
    assert maxp == n_blocks
    ys = [-bs, (n_blocks - 1) * bs, (n_blocks + 1) * bs]
    o, d = [], []
    for y in ys:
        for tilt in (0.0, 0.01, -0.02):
            o.append([0.01, y + 0.013, -0.02])
            d.append([tilt, 1.0, 0.5 * tilt])
    d = np.array(d, np.float64)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    args = (t(state), t(hi), t(lo), t(sl), t(np.array(o, np.float32)), t(d))
    kw = dict(res=res, bs=bs, n=n, max_steps=int(np.ceil(8.0 / res) * 3 + 8), target=1,
              max_range=8.0, max_probes=max(4, 1 << int(np.ceil(np.log2(maxp)))))
    return args, kw


# ------------------------------------------------------------ K7v's clouds

def jax_voxel_downsample(points: np.ndarray, leaf: float) -> np.ndarray:
    """The JAX package's ``voxel_downsample`` (``la3dm_tpu/geometry/
    preprocess.py``, plain numpy), the reference K7v is held to.  Its file is
    loaded alone: the package's ``__init__`` imports JAX, which a machine
    with a card may lack."""
    name = "la3dm_tpu_preprocess_reference"
    if name not in sys.modules:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(root, "la3dm_tpu", "geometry", "preprocess.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name].voxel_downsample(points, leaf)


def keyable(cloud: np.ndarray, origin, leaf: float, radius: int = 512) -> np.ndarray:
    """[N] bool: the points whose cell floor(p · float32(1/leaf)) is finite
    and within ``radius`` cells of the origin's on every axis, the points
    K7v keys (numpy, apart from the kernel's code)."""
    inv = np.float32(1.0 / leaf)
    with np.errstate(invalid="ignore"):
        c = np.floor(cloud * inv).astype(np.float64)
        a = np.floor(np.asarray(origin, np.float64) * float(inv))
        return (np.abs(c - a) <= radius).all(-1)

def vlp16_cloud(seed: int, r_max: float = 60.0, origin=(3.3, -7.1, 1.8)):
    """A VLP-16-shaped cloud [28800, 3] f32 (16 rings over ±15°, 1,800
    azimuths, ranges uniform in 2 m … ``r_max``) round ``origin``, and the
    origin [3] f32."""
    rng = np.random.default_rng(seed)
    az = np.linspace(0.0, 2 * np.pi, 1800, endpoint=False)
    el = np.deg2rad(np.linspace(-15.0, 15.0, 16))
    r = rng.uniform(2.0, r_max, (16, 1800))
    d = np.stack(np.broadcast_arrays(np.cos(el)[:, None] * np.cos(az),
                                     np.cos(el)[:, None] * np.sin(az), np.sin(el)[:, None]), -1)
    o = np.asarray(origin, np.float32)
    return (o + d * r[..., None]).reshape(-1, 3).astype(np.float32), o


def sum_order_cells(n_points=(4, 64, 1024), seed: int = 0):
    """A cloud of cells at leaf 0.5 whose centroids show numpy's sum order in
    their float32 bits.  A cell of n (a power of two) points holds on x
    0.25, then 2^-26, then n − 2 values of 2^-55: numpy's reduceat adds the
    first point to the pairwise sum of the rest, which keeps the 2^-55s
    (0.25 + 2^-26 + (n − 2)·2^-55, exact); a running sum from the first
    point rounds each of them away (half an ulp of 0.25, to even), and its
    mean (0.25 + 2^-26) / n is a float32 tie, which rounds the other way.
    Cell k lies at y in [2k, 2k + 0.5), y and z spread in it; one more cell
    (x in [1, 1.5)) holds three points with y = z = -0.0.  The cells are merged in a random
    order, each keeping its own (its first point first)."""
    rng = np.random.default_rng(seed)
    cells = []
    for k, n in enumerate(n_points):
        c = np.empty((n, 3), np.float32)
        c[:, 0] = 2.0 ** -55
        c[:2, 0] = (0.25, 2.0 ** -26)
        c[:, 1:] = rng.uniform(0.0, 0.5, (n, 2))
        c[:, 1] += np.float32(2 * k)
        cells.append(c)
    zeros = np.full((3, 3), -0.0, np.float32)
    zeros[:, 0] = (1.3, 1.2, 1.1)
    cells.append(zeros)
    label = rng.permutation(np.repeat(np.arange(len(cells)), [len(c) for c in cells]))
    pts = np.empty((len(label), 3), np.float32)
    for k, c in enumerate(cells):
        pts[label == k] = c
    return pts
