"""Device-side scan ingest: raw point clouds → block-sorted entry tables, on
the map's device.

The port of ``la3dm_tpu/geometry/device_ingest.py`` for the point family
(BGK, GP; reference ``src/bgkoctomap/bgkoctomap.cpp:383-458``), K7:

  clouds ──► outlier mask + ds-voxel keys            (K7a, ``point_keys``)
         ──► stable sort, runs, compensated centroids (K7b)  = hits
         ──► range filter + Kf + 2 beam samples       (K7a, ``beam_samples``)
         ──► stable sort, runs, compensated centroids (K7b)  = frees
         ──► entries: hits (label 1) then frees (free label), z-major
         ──► ≤ 8 closed-box memberships an entry      (K7c)
         ──► stable sort by block key → per-block runs, test blocks and
             the slot maps ``nb_row`` / ``tb_u``      (torch.sort / unique /
                                                       searchsorted)

What decides results is the JAX function's: f32 arithmetic throughout (its
declared deviations from the host path, centroids and ranges in f32), the
z-major voxel order, hits before frees, the stable sort by block key, and
``ent_rel = ent − coord·bs`` in f32.  What answered TPU costs is not carried
over: the static pads and their overflow ladder (every table here takes its
exact size, so no chunk overflows or falls back for its size), one-hot
equality matmuls (``searchsorted``), log-shift segmented scans (run
boundaries of a stable sort), payload sorts (argsort and gather) and the
Wa = 8 alignment pads (K1′ sums rows of 8 from each run's start without
them).

Keys are scan-local (``kernels/ingest_keys.py``), anchored at each scan's
origin cell or block; a dispatch's K scans share one sort.  Configs whose
reach the JAX package's 1024-cell windows cannot bound take the host path in
both packages (:func:`beam_slots`).  Each data-dependent size is a host
sync: four per dispatch here (the runs of the two downsamples, the
memberships and the test blocks).
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import (ingest_beams, ingest_downsample, ingest_keys,
                                     ingest_members)

#: cells (or blocks) per axis of the JAX package's scan-local windows
_WIN = 1024


def beam_slots(ds: float, fr: float, mr: float, block_size: float) -> int | None:
    """Free-sample slots per beam (⌊mr/fr⌋ + 1), or None where the JAX
    package's ``spec_for`` bounds reject the config: no max range, or a reach
    the 1024-cell windows cannot hold (such configs take the host path)."""
    if mr is None or mr <= 0:
        return None
    if 2.0 * mr / ds + 8 > _WIN or 2.0 * mr / block_size + 8 > _WIN:
        return None
    return int(np.floor(mr / fr)) + 1


def anchors(origins: np.ndarray, size: float) -> np.ndarray:
    """Each scan's anchor [K,3] int32: the cell of size ``size`` holding its
    origin."""
    return np.floor(np.asarray(origins, np.float64) / size).astype(np.int32)


def _runs(keys: torch.Tensor):
    """Stable sort of ``keys`` and its runs of valid keys: (sorted keys,
    sort index, run keys [R], starts [R], counts [R]).  A sentinel appended
    to the keys makes the last run always the sentinel's, which is
    dropped."""
    sent = torch.full((1,), ingest_keys.SENT, dtype=torch.int64, device=keys.device)
    skey, perm = torch.sort(torch.cat([keys, sent]), stable=True)
    ukey, counts = torch.unique_consecutive(skey, return_counts=True)
    ukey, counts = ukey[:-1], counts[:-1]
    return skey, perm, ukey, torch.cumsum(counts, 0) - counts, counts


def _downsample(pts, keys, cell_anchor, leaf: float):
    """Voxel keys → (voxel keys [R], centroids [R,3]), z-major within each
    scan (``_downsample`` of the JAX package)."""
    _, perm, ukey, starts, counts = _runs(keys)
    return ukey, ingest_downsample.centroids(pts, perm, starts, counts, ukey, cell_anchor,
                                             leaf=leaf)


def ingest_batch(pts, scan, origins, cell_anchor, block_anchor, off_keys, *, ds: float,
                 fr: float, mr: float, kf: int, block_size: float,
                 free_label: float) -> dict | None:
    """K scans' raw points (``pts`` [N,3] f32, ``scan`` [N] int32, ``origins``
    [K,3] f32, the anchors of :func:`anchors` at ``ds`` and at
    ``block_size``) → the block tables, or None without entries:

    ent / ent_rel / lab [M]: entries sorted by (scan, block key), stable
      (per block: hits, then frees), absolute and relative to their block's
      centre; rows past the valid memberships are padding.
    ukey / ustart / ucount [U]: each entry block's key and run.
    tkey [T]: the test blocks (every block with an entry block among its
      neighbours ``off_keys``), sorted.
    nb_row [U,G]: the test block entry block u serves at slot g (u − off_g).
    tb_u [T,G]: the entry block feeding test block t at slot g (t + off_g),
      U where there is none.
    """
    inv = float(np.float32(1.0 / ds))
    lim = float(np.float32((mr + np.sqrt(3.0) * ds) ** 2))
    fr32, mr32 = float(np.float32(fr)), float(np.float32(mr))
    keys = ingest_beams.point_keys(pts, scan, origins, cell_anchor, inv_leaf=inv, lim=lim)
    hkey, hits = _downsample(pts, keys, cell_anchor, float(np.float32(ds)))
    fpts, fkeys, inr = ingest_beams.beam_samples(hits, hkey, origins, cell_anchor, kf=kf,
                                                 mr=mr32, fr=fr32, inv_leaf=inv)
    fkey, frees = _downsample(fpts, fkeys, cell_anchor, float(np.float32(ds)))
    dev = pts.device
    ent = torch.cat([hits, frees])
    lab = torch.cat([torch.ones(len(hits), dtype=torch.float32, device=dev),
                     torch.full((len(frees),), float(free_label), dtype=torch.float32,
                                device=dev)])
    escan = (torch.cat([hkey, fkey]) >> 48).to(torch.int32)
    evalid = torch.cat([inr, torch.ones(len(frees), dtype=torch.bool, device=dev)])
    mkey = ingest_members.memberships(ent, escan, evalid, block_anchor, block_size=block_size)
    return _bucket(mkey, ent, lab, block_anchor, off_keys, block_size)


def _bucket(mkey, ent, lab, block_anchor, off_keys, block_size: float) -> dict | None:
    """Membership keys [E·8] → the block tables of :func:`ingest_batch`."""
    skey, perm, ukey, ustart, ucount = _runs(mkey)
    U = ukey.shape[0]
    if U == 0:
        return None
    eidx = torch.clamp_max(perm // 8, ent.shape[0] - 1)
    ent_s, lab_s = ent[eidx], lab[eidx]
    # centre of each membership's block, (coord in f32)·bs as the JAX
    # function computes it; sentinel rows (past the runs) are padding
    valid = skey != ingest_keys.SENT
    ctr = ingest_keys.unpack(torch.where(valid, skey, 0), block_anchor).to(torch.float32) \
        * float(np.float32(block_size))
    ent_rel = torch.where(valid[:, None], ent_s - ctr, 0.0)
    off = torch.as_tensor(off_keys, dtype=torch.int64, device=ent.device)
    tkey = torch.unique((ukey[:, None] + off[None, :]).reshape(-1))
    nb_row = torch.searchsorted(tkey, ukey[:, None] - off[None, :])
    want = tkey[:, None] + off[None, :]
    pos = torch.searchsorted(ukey, want)
    found = ukey[torch.clamp_max(pos, U - 1)] == want
    tb_u = torch.where(found, pos, U)
    return {"ent": ent_s, "ent_rel": ent_rel, "lab": lab_s, "ukey": ukey,
            "ustart": ustart, "ucount": ucount, "tkey": tkey, "nb_row": nb_row,
            "tb_u": tb_u}
