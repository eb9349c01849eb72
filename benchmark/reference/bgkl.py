"""BGK-L (BGKOctoMap-L, upstream ``src/bgkloctomap``) in plain PyTorch: the
map a scan sequence gives, worked out from the raw clouds and origins.

Per scan: the hits (voxel-grid downsample at ``ds``) in range; each hit a
degenerate segment [occ, occ] with label 1 in every block whose closed box
holds it, and its free ray (origin, origin + n·(l − fr)) with label 0 once
in every block that holds one of its proxy samples (the origin and the
points at l − k·fr, k ≥ 1, while positive; ``bgkloctomap.cpp:145-172``).
Every block u with an entry serves the test blocks u − off_g of its
ExtendedBlock (self and the six faces): at each octree node of a test
block, k̄_g = Σ k(node, segment) and ȳ_g = Σ label·k over block t + off_g's
entries, k the sparse kernel of the point-to-segment distance over ℓ
(``bgklinference.h``).  Then scan by scan, in order, each voxel of the
scan's test blocks reads its leaf's node and adds ȳ_g to A and k̄_g − ȳ_g to
B for every slot with k̄_g > 0.001 (``bgkloctomap.cpp:231``), and the
blocks are pruned.

The sums over a block's entries run in rows of 8 entries, each row summed in
entry order and the rows added in order, the order in which the program
states that it sums them; every other expression is float32 in the order
of the program's own plain statement of it.  ``tf32=True`` rounds the
coordinates the kernel reads to TF32 (10 mantissa bits), the lower
precision a tensor-core heavy pass would use.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ingest, pool as rpool
from benchmark.reference.geometry import FACE_OFFSETS, block_size, node_tables
from benchmark.reference.ingest import SENT, f32

TWO_PI = f32(2.0 * 3.1415926)       # upstream's 3.1415926f
SEG_EPSILON = f32(1e-4)             # degenerate-segment threshold (bgklinference.h)
ROW = 8                             # entries summed together before the rows are added
GATE = 0.001


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32 (10 mantissa bits, to nearest)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _sq3(x, y, z):
    return x * x + y * y + z * z


def segment_distance(p: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Distances [c, N, W] from points p [N, 3] to segments seg [c, W, 6]
    (upstream ``bgklinference.h:106-141``): the start if the segment is
    shorter than ε or the projection falls before it, the end if past it,
    else the foot of the perpendicular."""
    p0, p1 = seg[:, None, :, 0:3], seg[:, None, :, 3:6]
    u = p1 - p0
    pp = p[None, :, None, :]
    diff0, diff1 = pp - p0, pp - p1
    d0 = torch.sqrt(_sq3(diff0[..., 0], diff0[..., 1], diff0[..., 2]))
    d1 = torch.sqrt(_sq3(diff1[..., 0], diff1[..., 1], diff1[..., 2]))
    c1 = diff0[..., 0] * u[..., 0] + diff0[..., 1] * u[..., 1] + diff0[..., 2] * u[..., 2]
    c2 = _sq3(u[..., 0], u[..., 1], u[..., 2])
    b = c1 / torch.clamp_min(c2, 1e-30)
    dm = pp - (p0 + u * b[..., None])
    dmid = torch.sqrt(_sq3(dm[..., 0], dm[..., 1], dm[..., 2]))
    d = torch.where(c1 <= 0.0, d0, torch.where(c2 <= c1, d1, dmid))
    return torch.where(torch.sqrt(c2) < SEG_EPSILON, d0, d)


def sparse_kernel(r: torch.Tensor, sf2: float) -> torch.Tensor:
    """sf2·[(2 + cos 2πr)(1 − r)/3 + sin(2πr)/2π], negatives clamped to 0
    (upstream ``bgkinference.h:113-126``)."""
    k = (_div((2.0 + torch.cos(TWO_PI * r)) * (1.0 - r), 3.0)
         + _div(torch.sin(TWO_PI * r), TWO_PI)) * f32(sf2)
    return torch.clamp_min(k, 0.0)


def entries(pts, scan, origins, *, ds: float, fr: float, mr: float, bs: float):
    """(entries [M, 6] f32, labels [M], Buckets) of a batch of scans."""
    hkey, hit = ingest.hits(pts, scan, origins, ds=ds, mr=mr)
    hscan = hkey >> 48
    o, ndir, l, inr = ingest.ranges(hit, hscan, origins, mr)
    occ = o + ndir * l[:, None]
    seg = torch.cat([o, o + ndir * (l - f32(fr))[:, None]], dim=1)
    R, kf = hit.shape[0], ingest.beam_slots(mr, fr)
    S = kf + 1
    karr = torch.arange(1, kf + 1, dtype=torch.float32, device=pts.device) * f32(fr)
    d = l[:, None] - karr[None, :]
    samples = torch.cat([o[:, None, :], o[:, None, :] + ndir[:, None, :] * d[:, :, None]], 1)
    smask = torch.cat([inr[:, None], (d > 0.0) & inr[:, None]], dim=1)
    blk, mem = ingest.closed_box(samples.reshape(-1, 3), smask.reshape(-1), bs)
    keys = ingest.pack(hscan.repeat_interleave(S * 8), blk.reshape(-1, 3))
    keys = torch.where(mem.reshape(-1), keys, SENT).view(R, S * 8)
    skey = torch.sort(keys, dim=1).values                      # each ray's blocks, once
    first = torch.cat([skey[:, :1] != SENT,
                       (skey[:, 1:] != skey[:, :-1]) & (skey[:, 1:] != SENT)], dim=1)
    ray, col = torch.nonzero(first, as_tuple=True)
    hblk, hmem = ingest.closed_box(occ, inr, bs)
    hkeys = torch.where(hmem.reshape(-1),
                        ingest.pack(hscan.repeat_interleave(8), hblk.reshape(-1, 3)), SENT)
    # per block: the hits in hit order, then the rays in ray order
    mkey = torch.cat([hkeys, skey[ray, col]])
    mrow = torch.cat([torch.arange(R, device=pts.device).repeat_interleave(8), R + ray])
    ent = torch.cat([torch.cat([occ, occ], dim=1), seg])
    lab = torch.cat([torch.ones(R, device=pts.device), torch.zeros(R, device=pts.device)])
    return ent, lab, ingest.Buckets(mkey, mrow)


def heavy(ent, lab, bk, nodes: torch.Tensor, *, sf2: float, ell: float, bs: float,
          tf32: bool, budget: int = 1 << 25):
    """(ȳ, k̄) [T, G, Vall] of every test block and slot, and the (segment,
    node) pairs inside the kernel's support.  Entry blocks go longest run
    first, a chunk of them at a time, a row of 8 entries at a time over the
    blocks whose runs are that long."""
    G, Vall = FACE_OFFSETS.shape[0], nodes.shape[0]
    dev = ent.device
    T, U = bk.tkey.shape[0], bk.ukey.shape[0]
    ybar = torch.zeros((T, G, Vall), device=dev)
    kbar = torch.zeros((T, G, Vall), device=dev)
    shifts = -FACE_OFFSETS.astype(np.float32) * np.float32(bs)
    ext = torch.as_tensor((nodes.cpu().numpy()[None] + shifts[:, None, :]).reshape(-1, 3),
                          device=dev)                                 # [G·Vall, 3], u's frame
    ctr = (bk.block_u.to(torch.float32) * f32(bs)).repeat(1, 2)       # [U, 6]
    if tf32:
        ext = tf32_round(ext)
    order = torch.argsort(bk.count, descending=True, stable=True)
    cnt_h = bk.count[order].cpu().numpy()
    gi = torch.arange(G, device=dev)
    col = torch.arange(ROW, device=dev)
    chunk = max(1, budget // (G * Vall * ROW))
    support = 0
    for c0 in range(0, U, chunk):
        u = order[c0:c0 + chunk]
        cnt, start = bk.count[u], bk.start[u]
        neg = -cnt_h[c0:c0 + chunk]                   # ascending
        sy = sk = None
        for r in range(-(-int(-neg[0]) // ROW)):
            live = int(np.searchsorted(neg, -ROW * r))    # the runs longer than 8r
            pos = ROW * r + col
            valid = pos[None, :] < cnt[:live, None]                   # [live, 8]
            idx = bk.order[torch.where(valid, start[:live, None] + pos, 0)]
            rel = ent[idx] - ctr[u[:live]][:, None, :]
            if tf32:
                rel = tf32_round(rel)
            K = sparse_kernel(_div(segment_distance(ext, rel), f32(ell)), sf2)  # [live, G·Vall, 8]
            K = torch.where(valid[:, None, :], K, 0.0)
            support += int((K > 0).sum())
            y = torch.where(valid, lab[idx], 0.0)[:, None, :]
            ry, rk = K[..., 0] * y[..., 0], K[..., 0]
            for w in range(1, ROW):
                ry = ry + K[..., w] * y[..., w]
                rk = rk + K[..., w]
            if sy is None:
                sy, sk = ry, rk
            else:
                sy[:live] = sy[:live] + ry
                sk[:live] = sk[:live] + rk
        t = bk.test_of[u]                                             # [c, G]
        ybar[t, gi] = sy.view(-1, G, Vall)
        kbar[t, gi] = sk.view(-1, G, Vall)
    return ybar, kbar, support


def state(values: dict, method: dict) -> torch.Tensor:
    """The voxels' states from A, B and touched (float)."""
    return rpool.beta_state(values, method["var_thresh"], method["free_thresh"],
                            method["occupied_thresh"])


def run(clouds, origins, method: dict, *, max_range: float, device, tf32: bool = False,
        batch: int | None = None, ds: float | None = None) -> dict:
    """The BGK-L map of the scan sequence: ``coords`` [B, 3], ``fields`` (A,
    B), ``touched``, ``eff``, and the heavy pass's work (``support_pairs``,
    ``entries``, ``test_blocks``).  ``ds`` is the hits' downsampling leaf
    (``resolution`` unless named, the static nodes' convention); ``batch``
    scans go through the heavy pass together (all of them unless named),
    which leaves every number of the map as it is."""
    res, depth = float(method["resolution"]), int(method["block_depth"])
    ds = res if ds is None else float(ds)
    bs = block_size(res, depth)
    n = 1 << (depth - 1)
    nodes_np, node_idx_np = node_tables(res, depth)
    nodes = torch.as_tensor(nodes_np, device=device)
    node_idx = torch.as_tensor(node_idx_np, device=device)
    V = n ** 3
    vcol = torch.arange(V, device=device)
    pool = rpool.Pool({"A": float(method["prior_A"]), "B": float(method["prior_B"])}, V, device)

    work = {"support_pairs": 0, "entries": 0, "test_blocks": 0}
    batch = batch or len(clouds)
    for b0 in range(0, len(clouds), batch):
        cl = clouds[b0:b0 + batch]
        pts = torch.as_tensor(np.concatenate(cl), device=device)
        scan = torch.as_tensor(np.repeat(np.arange(len(cl)), [len(c) for c in cl]),
                               device=device)
        org = torch.as_tensor(np.stack(origins[b0:b0 + batch]), device=device)
        ent, lab, bk = entries(pts, scan, org, ds=ds, fr=float(method["free_resolution"]),
                               mr=max_range, bs=bs)
        ybar, kbar, sup = heavy(ent, lab, bk, nodes, sf2=float(method["sf2"]),
                                ell=float(method["ell"]), bs=bs, tf32=tf32)
        work["support_pairs"] += sup
        work["entries"] += int(bk.count.sum())
        work["test_blocks"] += int(bk.tkey.shape[0])
        for s in range(len(cl)):
            t = torch.nonzero(bk.scan_t == s).reshape(-1)
            if t.numel() == 0:
                continue
            rows = pool.rows(bk.block_t[t])
            nidx = node_idx[pool.eff[rows], vcol][:, None, :].expand(-1, ybar.shape[1], -1)
            y = torch.gather(ybar[t], 2, nidx)                        # [Ts, G, V]
            k = torch.gather(kbar[t], 2, nidx)
            dA = torch.zeros_like(y[:, 0])
            dB = torch.zeros_like(dA)
            tch = torch.zeros(dA.shape, dtype=torch.bool, device=device)
            for g in range(y.shape[1]):
                on = k[:, g] > GATE
                dA = dA + torch.where(on, y[:, g], 0.0)
                dB = dB + torch.where(on, k[:, g] - y[:, g], 0.0)
                tch = tch | on
            rpool.apply_scan(pool, rows, {"A": pool.fields["A"][rows] + dA,
                                          "B": pool.fields["B"][rows] + dB}, tch,
                             n=n, levels=depth,
                             state_fn=lambda v: state(v, method))
    return {"coords": pool.coords, "fields": pool.fields, "touched": pool.touched,
            "eff": pool.eff, "work": work}
