"""GPOctoMap (upstream ``src/gpoctomap``) in plain PyTorch: the map a scan
sequence gives, worked out from the raw clouds and origins.

Per scan: the hits (voxel-grid downsample at ``ds``) labelled +1, and the
free samples of every in-range beam (at fr, 2fr, … below its range, at
l − fr, and the origin; ``bgkoctomap.cpp:404, 433-458``), downsampled at
``ds`` and labelled −1 (``gpoctomap.cpp:399``).  Each block with points is
one exact GP on the points its closed box holds: Matérn-3/2 with the
upstream's scale 1.73205/ℓ, K + noise·I, mean Ksᵀ K⁻¹y and variance sf2 −
Ksᵀ K⁻¹ Ks (``gpregressor.h``), predicted at every octree node of the test
blocks u − off_g it serves.  Then scan by scan, in order, each voxel of the
scan's test blocks reads its leaf's node and fuses the slots that hold a
model, one by one in slot order, by the BCM update ivar += 1/σ² − sf2,
m_ivar += μ/σ², ivar chopped to max_ivar once it reaches min_known_ivar
(``gpoctree_node.cpp:36-49``), and the blocks are pruned.

The ingest is float32 in the order of the program's own plain statement of
it; the GP itself is solved in float64 from the float32 points and query
positions, so the reference carries no float32 rounding of the solve.
``tf32=True`` rounds the points and query positions to TF32 first;
``solve=torch.float32`` solves in the program's own precision (a witness
of what float32 alone does to a map, not a control).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ingest, pool as rpool
from benchmark.reference.bgkl import tf32_round
from benchmark.reference.geometry import FACE_OFFSETS, block_size, node_tables
from benchmark.reference.ingest import SENT, f32


def entries(pts, scan, origins, *, ds: float, fr: float, mr: float, bs: float):
    """(points [M, 3] f32, labels [M], Buckets) of a batch of scans."""
    hkey, hit = ingest.hits(pts, scan, origins, ds=ds, mr=mr)
    hscan = hkey >> 48
    o, ndir, l, inr = ingest.ranges(hit, hscan, origins, mr)
    R, kf = hit.shape[0], ingest.beam_slots(mr, fr)
    S = kf + 2
    dev = pts.device
    karr = torch.arange(1, kf + 1, dtype=torch.float32, device=dev) * f32(fr)
    d = torch.cat([karr.expand(R, kf), (l - f32(fr))[:, None],
                   torch.zeros((R, 1), device=dev)], dim=1)
    keep = torch.cat([karr[None, :] < l[:, None], (l > f32(fr))[:, None],
                      torch.ones((R, 1), dtype=torch.bool, device=dev)], dim=1) & inr[:, None]
    fpts = (o[:, None, :] + ndir[:, None, :] * d[:, :, None]).reshape(-1, 3)
    fkey, frees = ingest.downsample(
        fpts, ingest.cell_keys(fpts, hscan.repeat_interleave(S), keep.reshape(-1), ds), ds)
    ent = torch.cat([hit, frees])
    lab = torch.cat([torch.ones(R, device=dev), torch.full((frees.shape[0],), -1.0, device=dev)])
    escan = torch.cat([hkey, fkey]) >> 48
    valid = torch.cat([inr, torch.ones(frees.shape[0], dtype=torch.bool, device=dev)])
    blk, mem = ingest.closed_box(ent, valid, bs)
    mkey = torch.where(mem.reshape(-1),
                       ingest.pack(escan.repeat_interleave(8), blk.reshape(-1, 3)), SENT)
    mrow = torch.arange(ent.shape[0], device=dev).repeat_interleave(8)
    return ent, lab, ingest.Buckets(mkey, mrow)


def _matern(a: torch.Tensor, b: torch.Tensor, s: float, sf2: float) -> torch.Tensor:
    """Matérn-3/2 [c, P, Q] between a [c, P, 3] and b [c, Q, 3], in their type."""
    d = torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist") * s
    return (1.0 + d) * torch.exp(-d) * sf2


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors [c, W, W] of SPD matrices K, a column at a
    time over the whole batch (NaN where a pivot is not positive)."""
    L = torch.zeros_like(K)
    for j in range(K.shape[-1]):
        Lj = L[:, j, :j]
        d = K[:, j, j] - (Lj * Lj).sum(-1)
        col = K[:, j + 1:, j] - torch.bmm(L[:, j + 1:, :j], Lj[:, :, None])[..., 0]
        ljj = torch.sqrt(d)
        L[:, j, j] = ljj
        L[:, j + 1:, j] = col / ljj[:, None]
    return L


def lower_inverse(L: torch.Tensor) -> torch.Tensor:
    """Inverses [c, W, W] of lower-triangular L, a row at a time."""
    X = torch.zeros_like(L)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    for i in range(L.shape[-1]):
        r = eye[i] - torch.bmm(L[:, i:i + 1, :i], X[:, :i, :])[:, 0]
        X[:, i, :] = r / L[:, i, i][:, None]
    return X


def heavy(ent, lab, bk, nodes: torch.Tensor, *, sf2: float, ell: float, noise: float,
          bs: float, tf32: bool, solve: torch.dtype = torch.float64, budget: int = 1 << 27):
    """(mean, var) [T, G, Vall] f32 and present [T, G] of every test block and
    slot; the models' sizes and the (block, slot) rows each serves."""
    G, Vall = FACE_OFFSETS.shape[0], nodes.shape[0]
    dev = ent.device
    T, U = bk.tkey.shape[0], bk.ukey.shape[0]
    mean = torch.zeros((T, G, Vall), device=dev)
    var = torch.ones((T, G, Vall), device=dev)
    present = torch.zeros((T, G), dtype=torch.bool, device=dev)
    # each test block's centre as the map computes it: coord·bs in double,
    # rounded to float32; its nodes at centre + offset in float32
    ctr = (bk.block_t.double() * f32(bs)).to(torch.float32)
    q_all = ctr[:, None, :] + nodes[None]                              # [T, Vall, 3]
    pts = ent
    if tf32:
        pts, q_all = tf32_round(ent), tf32_round(q_all)
    s, sf2, noise = 1.73205 / ell, float(sf2), float(noise)
    order = torch.argsort(bk.count, descending=True, stable=True)
    cnt_h = bk.count[order].cpu().numpy()
    c0 = 0
    while c0 < U:
        W = int(cnt_h[c0])
        c1 = min(U, c0 + max(1, budget // (W * (W + G * Vall))))
        u = order[c0:c1]
        c = u.shape[0]
        col = torch.arange(W, device=dev)
        valid = col[None, :] < bk.count[u][:, None]                   # [c, W]
        idx = bk.order[torch.where(valid, bk.start[u][:, None] + col, 0)]
        x = pts[idx].to(solve)
        y = torch.where(valid, lab[idx], 0.0).to(solve)
        vv = valid[:, :, None] & valid[:, None, :]
        eye = torch.eye(W, dtype=solve, device=dev)
        K = torch.where(vv, _matern(x, x, s, sf2), 0.0) + eye * torch.where(
            valid, noise, 1.0).to(solve)[:, None, :]
        Linv = lower_inverse(cholesky(K))
        alpha = Linv.mT @ (Linv @ y[..., None])                       # [c, W, 1]
        t = bk.test_of[u]                                             # [c, G]
        q = q_all[t].reshape(c, G * Vall, 3).to(solve)
        Ks = torch.where(valid[:, :, None], _matern(x, q, s, sf2), 0.0)   # [c, W, G·Vall]
        mu = (Ks.mT @ alpha)[..., 0]
        v = Linv @ Ks
        sig = sf2 - (v * v).sum(1)
        gi = torch.arange(G, device=dev)
        mean[t, gi] = mu.view(c, G, Vall).to(torch.float32)
        var[t, gi] = sig.view(c, G, Vall).to(torch.float32)
        present[t, gi] = True
        c0 = c1
    return mean, var, present


def state(values: dict, method: dict) -> torch.Tensor:
    """The voxels' states from m_ivar, ivar and touched (float)."""
    return rpool.gp_state(values, method["l"], 1.0 / float(method["min_var"]),
                          1.0 / float(method["max_known_var"]), method["free_thresh"],
                          method["occupied_thresh"])


def run(clouds, origins, method: dict, *, max_range: float, device, tf32: bool = False,
        solve: torch.dtype = torch.float64, batch: int | None = None,
        ds: float | None = None) -> dict:
    """The GP map of the scan sequence: ``coords`` [B, 3], ``fields`` (m_ivar,
    ivar), ``touched``, ``eff``, and the heavy pass's work (``models``, the
    models' point counts; ``served``, the (block, slot) rows each serves).
    ``ds`` is the downsampling leaf of hits and free samples (``resolution``
    unless named); ``batch`` as BGK-L's."""
    res, depth = float(method["resolution"]), int(method["block_depth"])
    ds = res if ds is None else float(ds)
    bs = block_size(res, depth)
    n = 1 << (depth - 1)
    nodes_np, node_idx_np = node_tables(res, depth)
    nodes = torch.as_tensor(nodes_np, device=device)
    node_idx = torch.as_tensor(node_idx_np, device=device)
    V = n ** 3
    vcol = torch.arange(V, device=device)
    sf2 = float(method["sf2"])
    min_ivar, max_ivar = 1.0 / float(method["max_var"]), 1.0 / float(method["min_var"])
    min_known = 1.0 / float(method["max_known_var"])
    pool = rpool.Pool({"m_ivar": 0.0, "ivar": min_ivar}, V, device)

    counts = []
    batch = batch or len(clouds)
    for b0 in range(0, len(clouds), batch):
        cl = clouds[b0:b0 + batch]
        pts = torch.as_tensor(np.concatenate(cl), device=device)
        scan = torch.as_tensor(np.repeat(np.arange(len(cl)), [len(c) for c in cl]),
                               device=device)
        org = torch.as_tensor(np.stack(origins[b0:b0 + batch]), device=device)
        ent, lab, bk = entries(pts, scan, org, ds=ds, fr=float(method["free_resolution"]),
                               mr=max_range, bs=bs)
        mean, var, present = heavy(ent, lab, bk, nodes, sf2=sf2, ell=float(method["ell"]),
                                   noise=float(method["noise"]), bs=bs, tf32=tf32, solve=solve)
        counts.append(bk.count.cpu().numpy())
        G = mean.shape[1]
        for s in range(len(cl)):
            t = torch.nonzero(bk.scan_t == s).reshape(-1)
            if t.numel() == 0:
                continue
            rows = pool.rows(bk.block_t[t])
            nidx = node_idx[pool.eff[rows], vcol][:, None, :].expand(-1, G, -1)
            mu = torch.gather(mean[t], 2, nidx)                       # [Ts, G, V]
            sg = torch.gather(var[t], 2, nidx)
            sg = torch.where(sg == 0.0, 1.0, sg)
            ok = present[t]                                           # [Ts, G]
            mi, iv = pool.fields["m_ivar"][rows], pool.fields["ivar"][rows]
            for g in range(G):
                iv_new = iv + 1.0 / sg[:, g] - f32(sf2)
                mi_new = mi + mu[:, g] / sg[:, g]
                iv_new = torch.where(iv_new >= f32(min_known), torch.clamp_max(iv_new, f32(max_ivar)),
                                     iv_new)
                mi = torch.where(ok[:, g, None], mi_new, mi)
                iv = torch.where(ok[:, g, None], iv_new, iv)
            tch = ok.any(-1)[:, None].expand(-1, V)
            rpool.apply_scan(pool, rows, {"m_ivar": mi, "ivar": iv}, tch, n=n, levels=depth,
                             state_fn=lambda v: state(v, method))
    return {"coords": pool.coords, "fields": pool.fields, "touched": pool.touched,
            "eff": pool.eff, "work": {"models": np.concatenate(counts) if counts else
                                      np.zeros(0, np.int64), "served": FACE_OFFSETS.shape[0]}}
