"""Training data of a scan sequence, worked out again from the raw clouds
and origins, in plain PyTorch: the reference's half of the offline cells'
ingest (upstream ``bgkoctomap.cpp:383-458`` for the point family,
``bgkloctomap.cpp:285-344`` for BGK-L).

Float32 throughout, each expression in the order the device-ingest path
states for itself: point-to-origin distances summed x, y, z; voxel cells
floor(p · (1/leaf)); centroids ``corner + Σ(p − corner)/count`` with the
sum taken member by member in sorted order; the closed-box block test
``ctr − half ≤ e ≤ ctr + half``.  Keys pack (scan, z, y, x), so sorting them
gives each scan's z-major order, and a stable sort keeps the order of equal
keys.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.geometry import FACE_OFFSETS

#: sorts after every key; marks a row that holds none
SENT = int(np.iinfo(np.int64).max)
_BIAS = 32768


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def pack(scan: torch.Tensor, ijk: torch.Tensor) -> torch.Tensor:
    """Keys [N] int64 of integer cells (or blocks) ``ijk`` [N, 3] of scans
    ``scan`` [N]."""
    f = ijk.long() + _BIAS
    return (scan.long() << 48) | (f[:, 2] << 32) | (f[:, 1] << 16) | f[:, 0]


def unpack(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(scan [N], cells [N, 3]) int64 of valid keys."""
    f = torch.stack([keys & 0xFFFF, (keys >> 16) & 0xFFFF, (keys >> 32) & 0xFFFF], -1)
    return keys >> 48, f - _BIAS


def cell_keys(pts: torch.Tensor, scan: torch.Tensor, keep: torch.Tensor, leaf: float):
    """Keys of the cells floor(p · (1/leaf)) of the kept points, SENT for the
    others."""
    ijk = torch.floor(pts * f32(1.0 / leaf))
    ijk = torch.where(keep[:, None], ijk, 0.0).to(torch.int64)
    return torch.where(keep, pack(scan, ijk), SENT)


def runs(keys: torch.Tensor):
    """Stable sort of ``keys`` and its runs over the valid keys: (perm,
    run keys [R], starts [R], counts [R])."""
    skeys, perm = torch.sort(keys, stable=True)
    n = int((skeys != SENT).sum())
    ukey, counts = torch.unique_consecutive(skeys[:n], return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    return perm, ukey, starts, counts


def downsample(pts: torch.Tensor, keys: torch.Tensor, leaf: float):
    """Voxel-grid downsample: (cell keys [R], centroids [R, 3] f32), the
    cells in key order, each centroid ``corner + Σ(p − corner)/count``
    summed in sorted order."""
    perm, ukey, starts, counts = runs(keys)
    corner = unpack(ukey)[1].to(torch.float32) * f32(leaf)
    R = ukey.shape[0]
    if R == 0:
        return ukey, corner
    order = torch.argsort(counts, descending=True, stable=True)
    cnt, st, cor = counts[order], starts[order], corner[order]
    neg = -cnt.cpu().numpy()                      # ascending
    s = torch.zeros((R, 3), dtype=torch.float32, device=pts.device)
    for j in range(int(-neg[0])):
        live = int(np.searchsorted(neg, -j))      # the runs longer than j
        p = perm[st[:live] + j]
        s[:live] = s[:live] + (pts[p] - cor[:live])
    out = torch.empty_like(s)
    out[order] = cor + s / cnt.to(torch.float32)[:, None]
    return ukey, out


def hits(pts, scan, origins, *, ds: float, mr: float):
    """The downsampled hits of the raw points ``pts`` [N, 3] of scans
    ``scan`` [N]: points farther than mr + √3·ds from their origin cannot
    have a centroid in range and are dropped first.  Returns (hit keys,
    centroids)."""
    d = pts - origins[scan]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    keep = d2 <= f32((mr + math.sqrt(3.0) * ds) ** 2)
    return downsample(pts, cell_keys(pts, scan, keep, ds), ds)


def ranges(hit, scan, origins, mr: float):
    """(origin [R, 3], unit direction [R, 3], range [R], in range [R]) of
    each hit: range in float32, in range where 0 < l ≤ max_range."""
    o = origins[scan]
    diff = hit - o
    l = torch.sqrt(diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] + diff[:, 2] * diff[:, 2])
    inr = (l <= f32(mr)) & (l > 0)
    return o, diff / torch.clamp_min(l, 1e-30)[:, None], l, inr


def beam_slots(mr: float, fr: float) -> int:
    """Free samples a beam may have: ⌊max_range / free_resolution⌋ + 1."""
    return int(math.floor(mr / fr)) + 1


def closed_box(ent: torch.Tensor, valid: torch.Tensor, bs: float):
    """(blocks [E, 8, 3] int64, member [E, 8]): the ≤ 8 blocks whose closed
    box holds each entry — the nearest block centre per axis, and per axis
    the neighbour whose box also holds it — as the upstream R-tree's box
    query decides (a point on a face belongs to both blocks)."""
    bs32, half = f32(bs), f32(bs / 2.0)
    base = torch.floor(ent / torch.full((), bs32, device=ent.device) + 0.5).to(torch.int64)

    def inside(coord):
        ctr = coord.to(torch.float32) * bs32
        return (ctr - half <= ent) & (ent <= ctr + half)

    base_ok, hi_ok, lo_ok = inside(base), inside(base + 1), inside(base - 1)
    sec = torch.where(hi_ok, 1, -1)
    bits = torch.tensor([[(j >> 2) & 1, (j >> 1) & 1, j & 1] for j in range(8)],
                        device=ent.device)
    blocks = base[:, None, :] + bits[None] * sec[:, None, :]
    member = torch.where(bits[None].bool(), (hi_ok | lo_ok)[:, None, :],
                         base_ok[:, None, :]).all(-1) & valid[:, None]
    return blocks, member


class Buckets:
    """The entry blocks of a batch of scans and the test blocks they serve.

    ``ukey`` [U] the entry blocks' keys (scan, block), ``start``/``count`` [U]
    their runs in ``order`` (entry ids, per block in the order the stable
    sort leaves them), ``tkey`` [T] the test blocks (every u + off_g),
    ``test_of`` [U, G] the test block that entry block u serves at slot g
    (u − off_g, so that slot g of a test block t reads block t + off_g).
    """

    def __init__(self, mkey: torch.Tensor, mrow: torch.Tensor):
        perm, self.ukey, self.start, self.count = runs(mkey)
        self.order = mrow[perm]
        dev = mkey.device
        off = torch.as_tensor(FACE_OFFSETS, device=dev)
        scan, blk = unpack(self.ukey)
        U, G = self.ukey.shape[0], off.shape[0]
        cand = pack(scan.repeat_interleave(G), (blk[:, None, :] - off[None]).reshape(-1, 3))
        self.tkey = torch.unique(cand)
        self.test_of = torch.searchsorted(self.tkey, cand).view(U, G)
        self.scan_u, self.block_u = scan, blk
        self.scan_t, self.block_t = unpack(self.tkey)
