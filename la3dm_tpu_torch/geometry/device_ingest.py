"""Device-side scan ingest: raw point clouds → block-sorted entry tables, on
the map's device.

The port of ``la3dm_tpu/geometry/device_ingest.py``: the point family
(BGK, GP; reference ``src/bgkoctomap/bgkoctomap.cpp:383-458``), K7,
:func:`ingest_batch`:

  clouds ──► outlier mask + ds-voxel keys            (K7a, ``point_keys``)
         ──► stable sort, runs (K7s), compensated centroids (K7b)  = hits
         ──► range filter + the Kf + 2 beam samples
             that exist, in order, their count on
             the card                                 (K7a, ``beam_samples``)
         ──► stable sort of those, runs (K7s), compensated centroids (K7b)
                                                      = frees
         ──► entries: hits (label 1) then frees (free label), z-major
         ──► ≤ 8 closed-box memberships an entry, only
             those that exist, in order, their count on
             the card                                 (K7c)
         ──► stable sort by block key → per-block runs (K7s); the test
             blocks, the runs of the candidates u + off_g (K7s); the rows in
             block order and the slot maps ``nb_row`` / ``tb_u``, read off
             the candidate runs                       (K7t)

and the BGKL segment family (``bgkloctomap.cpp:285-344``),
:func:`ingest_batch_bgkl`:

  clouds ──► outlier mask + ds-voxel keys, downsample  (K7a, K7s, K7b)  = hits
         ──► range filter, occ, free ray, Kf + 1 proxy samples, their
             closed-box block keys and each ray's distinct keys  (K7d)
         ──► hits' memberships, 8 slots a hit          (K7c, on occ)
         ──► entries [·,6]: hits as [occ, occ] (label 1), then rays
             (label 0) once per distinct block; the stable sort by block
             key leaves per block the hits first, then the rays by id
             (K7s, K7t as above)

What decides results is the JAX function's: f32 arithmetic throughout (its
declared deviations from the host path, centroids and ranges in f32), the
z-major voxel order, hits before frees, the stable sort by block key, and
``ent_rel = ent − coord·bs`` in f32.  What answered TPU costs is not carried
over: the static pads and their overflow ladder (every table here takes its
exact size, so no chunk overflows or falls back for its size), one-hot
equality matmuls (the candidate sort's runs: run t holds every (u, g′) with
u + off_g′ = test block t, and the offsets are symmetric, so each member
gives nb_row[u, mirror(g′)] = t and tb_u[t, mirror(g′)] = u), log-shift
segmented scans (run boundaries of a stable sort), payload sorts (a sort
index and gathers) and the Wa = 8 alignment pads (K1′ sums rows of 8 from
each run's start without them).  The entry tables hold the valid
memberships only: K1′ and GP's models read rows by ``ustart`` /
``ucount``, never past the last run.

Keys are scan-local (``kernels/ingest_keys.py``), anchored at each scan's
origin cell or block; a dispatch's K scans share one sort, whose window
(``kernels/ingest_sort.py``) the statics bound.  Configs whose reach the JAX
package's 1024-cell windows cannot bound take the host path in both packages
(:func:`beam_slots`).  Each data-dependent size is a host sync, one a sort:
four per dispatch here (the runs of the two downsamples, the memberships
and the test blocks; BGKL has one downsample and the size of the ray-block
pair list instead), and the map's one copy of its slot resolution
(``models/ingest.py``) makes five: not the test-block keys ``tkey``, which
stay on the card, but the status of K7w's world-key sort, its run-key row
(sized for the T test blocks; the host reads the first D, the distinct
blocks), the per-scan counts of test blocks and ``ucount``.  The counts of
K7a's beam samples and K7c's memberships stay on the card, where the sorts
that follow read them.
JAX keeps the first ``Rmax`` distinct blocks of a ray and regrows Rmax or
takes the host path when a ray has more
(``la3dm_tpu/models/ingest.py:150-175``), so what it integrates is never
cut; the pair list here takes its exact size and cuts nothing either.
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import (ingest_beams, ingest_bucket, ingest_downsample,
                                     ingest_members, ingest_rays, ingest_sort)

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


def _downsample(pts, keys, cell_anchor, leaf: float, window=None, count=None):
    """Voxel keys → (voxel keys [R], centroids [R,3]), z-major within each
    scan (``_downsample`` of the JAX package); ``window`` bounds the valid
    keys (by default the widest that device ingest accepts); ``count`` (on
    the keys' device): only the first ``count`` keys are read."""
    if window is None:
        window = ingest_sort.widest_window(cell_anchor.shape[0])
    runs = ingest_sort.sort_runs(keys, window, count=count)
    return runs.ukey, ingest_downsample.centroids(pts, runs.perm, runs.starts, runs.counts,
                                                  runs.ukey, cell_anchor, leaf=leaf)


def _windows(mr: float, ds: float, block_size: float, scans: int):
    """(cell window, block window) of a dispatch's keys."""
    return (ingest_sort.cell_window(mr, ds, scans),
            ingest_sort.block_window(mr, ds, block_size, scans))


def ingest_batch(pts, scan, origins, cell_anchor, block_anchor, off_keys, *, ds: float,
                 fr: float, mr: float, kf: int, block_size: float, free_label: float,
                 mirror=None) -> dict | None:
    """K scans' raw points (``pts`` [N,3] f32, ``scan`` [N] int32, ``origins``
    [K,3] f32, the anchors of :func:`anchors` at ``ds`` and at
    ``block_size``) → the block tables, or None without entries:

    ent / ent_rel / lab [M]: the M memberships sorted by (scan, block key),
      stable (per block: hits, then frees), absolute and relative to their
      block's centre.
    ukey / ustart / ucount [U]: each entry block's key and run.
    tkey [T]: the test blocks (every block with an entry block among its
      neighbours ``off_keys``), sorted.
    nb_row [U,G]: the test block entry block u serves at slot g (u − off_g).
    tb_u [T,G]: the entry block feeding test block t at slot g (t + off_g),
      U where there is none.

    ``mirror`` [G] int32 on the device: ``ingest_bucket.mirror_slots`` of
    the offsets, which the caller works out on the host; None derives it
    from ``off_keys`` (on a card a host read).
    """
    inv = float(np.float32(1.0 / ds))
    lim = float(np.float32((mr + np.sqrt(3.0) * ds) ** 2))
    fr32, mr32 = float(np.float32(fr)), float(np.float32(mr))
    keys = ingest_beams.point_keys(pts, scan, origins, cell_anchor, inv_leaf=inv, lim=lim)
    cwin, bwin = _windows(mr, ds, block_size, origins.shape[0])
    hkey, hits = _downsample(pts, keys, cell_anchor, float(np.float32(ds)), cwin)
    fpts, fkeys, inr, fcount = ingest_beams.beam_samples(hits, hkey, origins, cell_anchor,
                                                         kf=kf, mr=mr32, fr=fr32, inv_leaf=inv)
    fkey, frees = _downsample(fpts, fkeys, cell_anchor, float(np.float32(ds)), cwin,
                              count=fcount)
    dev = pts.device
    ent = torch.cat([hits, frees])
    lab = torch.cat([torch.ones(len(hits), dtype=torch.float32, device=dev),
                     torch.full((len(frees),), float(free_label), dtype=torch.float32,
                                device=dev)])
    escan = (torch.cat([hkey, fkey]) >> 48).to(torch.int32)
    evalid = torch.cat([inr, torch.ones(len(frees), dtype=torch.bool, device=dev)])
    mkey, mrow, count = ingest_members.memberships(ent, escan, evalid, block_anchor,
                                                   block_size=block_size)
    return _bucket(mkey, mrow, ent, lab, block_anchor, off_keys, block_size, bwin,
                   count=count, mirror=mirror)


def ingest_batch_bgkl(pts, scan, origins, cell_anchor, block_anchor, off_keys, *, ds: float,
                      fr: float, mr: float, kf: int, block_size: float,
                      mirror=None) -> dict | None:
    """BGKL (``_ingest_scan_bgkl`` of the JAX package): the arguments and
    tables of :func:`ingest_batch`, with segment entries ``ent`` /
    ``ent_rel`` [M,6] (start, end; relative: both minus the block's centre).
    Hits enter their closed-box blocks as degenerate segments [occ, occ]
    with label 1; each ray (origin, origin + ndir·(l − fr)) enters every
    block that holds one of its proxy samples once, with label 0."""
    inv = float(np.float32(1.0 / ds))
    lim = float(np.float32((mr + np.sqrt(3.0) * ds) ** 2))
    fr32, mr32 = float(np.float32(fr)), float(np.float32(mr))
    keys = ingest_beams.point_keys(pts, scan, origins, cell_anchor, inv_leaf=inv, lim=lim)
    cwin, bwin = _windows(mr, ds, block_size, origins.shape[0])
    hkey, hits = _downsample(pts, keys, cell_anchor, float(np.float32(ds)), cwin)
    occ, seg, inr, pray, pkey, _ = ingest_rays.ray_pairs(
        hits, hkey, origins, block_anchor, kf=kf, mr=mr32, fr=fr32, block_size=block_size)
    dev, R = pts.device, hits.shape[0]
    # the hits' dense layout (8 slots a hit): the ray pairs follow it in one
    # key array whose size the host knows, so no count sits between them
    hmkey, hrow, _ = ingest_members.memberships(occ, (hkey >> 48).to(torch.int32), inr,
                                                block_anchor, block_size=block_size,
                                                dense=True)
    ent = torch.cat([torch.cat([occ, occ], dim=1), seg])
    lab = torch.cat([torch.ones(R, dtype=torch.float32, device=dev),
                     torch.zeros(R, dtype=torch.float32, device=dev)])
    # hits first, in hit order, then the rays in ray order: the stable sort
    # keeps that order inside each block (the JAX step's mkey = [hkey…,
    # ukeys_r…])
    mkey = torch.cat([hmkey, pkey])
    mrow = torch.cat([hrow, (R + pray).to(torch.int32)])
    return _bucket(mkey, mrow, ent, lab, block_anchor, off_keys, block_size, bwin,
                   mirror=mirror)


def _bucket(mkey, mrow, ent, lab, block_anchor, off_keys, block_size: float,
            window, count=None, mirror=None) -> dict | None:
    """Membership keys [E'] in ``window`` and the entry row of each
    (``mrow`` int32) → the block tables of :func:`ingest_batch`; ``count``
    (K7c's, on the keys' device): only the first ``count`` keys hold
    memberships.  The test blocks are the runs of the candidate keys u +
    off_g, whose window is one block wider (the neighbour offsets reach one
    block an axis); K7t reads the slot maps off those runs."""
    runs = ingest_sort.sort_runs(mkey, window, want_rid=True, count=count)
    ukey = runs.ukey
    if ukey.shape[0] == 0:
        return None
    cand = ingest_sort.sort_runs((ukey[:, None] + off_keys[None, :]).reshape(-1),
                                 window.wider(1))
    tkey = cand.ukey
    ent_s, ent_rel, lab_s, nb_row, tb_u = ingest_bucket.bucket(
        runs.perm, runs.rid, mrow, ent, lab, ukey, tkey, cand.perm, cand.starts, cand.counts,
        off_keys, block_anchor, block_size=block_size, mirror=mirror)
    return {"ent": ent_s, "ent_rel": ent_rel, "lab": lab_s, "ukey": ukey,
            "ustart": runs.starts, "ucount": runs.counts, "tkey": tkey, "nb_row": nb_row,
            "tb_u": tb_u}
