"""K7a — the per-point passes of device scan ingest: wrappers, plain
versions and launch counter.

Replaces the elementwise parts of ``la3dm_tpu/geometry/device_ingest.py::
_ingest_scan``: the outlier mask (``_outlier_mask``, lines 390-405) and each
raw point's ds-voxel key (``_downsample``, line 209) — :func:`point_keys`;
then, per downsampled hit voxel, the range filter and the Kf + 2 free-space
beam samples with their masks and voxel keys (lines 420-443) —
:func:`beam_samples`.  Keys are those of :mod:`ingest_keys`.

The beam samples are compact: only the samples that exist, in the dense
layout's (hit, slot) order, with their count (:func:`beam_samples`);
:func:`beam_samples_plain` is the dense layout, the JAX step's, whose kept
rows :func:`compact_beam_samples_plain` takes.

On CUDA tensors both launch the hand-written kernels of
``csrc/ingest_beams.cu`` (the raw points a thread each; the beams a CTA a
tile of :func:`tile_hits` hits, each hit's work and kept count once, the
tile's place by a decoupled look-back, the samples staged and written as
coalesced slabs, their count left on the card; a programmatic dependent
launch); on CPU tensors they run the plain versions.  What bounds the
kernels is bytes.
"""

from __future__ import annotations

import torch

from la3dm_tpu_torch.kernels import _build, ingest_keys, ingest_members

#: kernel launches since the counter was last reset (two per dispatch: the
#: raw points, then the beams)
launches = 0


def tile_hits(kf: int) -> int:
    """Hits a tile of the beam kernel for ``kf`` + 2 slots a hit: 64, or 32
    for beams of more than 32 slots, whose many samples a hit want more,
    smaller tiles (on an H100: BGK's 19 slots fastest at 64, GP's 83 at 32;
    PERF.md §6, PR 15)."""
    return 64 if kf + 2 <= 32 else 32


def _check(name: str, want: dict) -> torch.device:
    dev = next(iter(want.values()))[0].device
    for k, (x, dt) in want.items():
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: {k} must be a contiguous {dt} tensor on {dev}")
    return dev


def point_keys(pts, scan, origins, anchors, *, inv_leaf: float, lim: float):
    """Keys [N] int64 of the raw points ``pts`` [N,3] of scans ``scan`` [N]
    int32: the sentinel where |p − origin|² > ``lim``, else the key of the
    cell floor(p · inv_leaf) (``anchors`` [K,3] int32 per scan)."""
    if pts.device.type == "cpu":
        return point_keys_plain(pts, scan, origins, anchors, inv_leaf=inv_leaf, lim=lim)
    if pts.device.type != "cuda":
        raise ValueError(f"point_keys: unsupported device {pts.device}")
    global launches
    _check("point_keys", {"pts": (pts, torch.float32), "scan": (scan, torch.int32),
                          "origins": (origins, torch.float32),
                          "anchors": (anchors, torch.int32)})
    N = pts.shape[0]
    if pts.shape[1:] != (3,) or scan.shape != (N,) or origins.shape[1:] != (3,) \
            or anchors.shape != origins.shape:
        raise ValueError("point_keys: inconsistent shapes")
    keys = torch.empty(N, dtype=torch.int64, device=pts.device)
    if N == 0:
        return keys
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    code = _build.lib().la3dm_ingest_points(
        pts.data_ptr(), scan.data_ptr(), origins.data_ptr(), anchors.data_ptr(), N,
        float(inv_leaf), float(lim), keys.data_ptr(), stream)
    _build.check(code, "ingest_points")
    launches += 1
    return keys


def point_keys_plain(pts, scan, origins, anchors, *, inv_leaf: float, lim: float):
    """The plain PyTorch :func:`point_keys`."""
    d = pts - origins[scan.long()]
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    ijk = torch.floor(pts * inv_leaf)
    keep = d2 <= lim
    ijk = torch.where(keep[:, None], ijk, 0.0).to(torch.int32)
    return torch.where(keep, ingest_keys.pack(scan, ijk, anchors), ingest_keys.SENT)


def beam_samples(hits, hit_keys, origins, anchors, *, kf: int, mr: float, fr: float,
                 inv_leaf: float):
    """Free-space samples of the hit voxels ``hits`` [R,3] (their keys
    ``hit_keys`` [R] give the scan): returns (samples [·,3], their keys [·],
    in range [R] bool, count [1] int32): the samples that exist, in (hit,
    slot) order, on the first ``count`` rows (exactly ``count`` rows on the
    CPU, R·(kf+2) on the card, the count left there: no host sync).  Per
    hit in range, slot k < kf at distance (k+1)·fr while that is below the
    range l, slot kf at l − fr while l > fr, slot kf+1 at the origin
    (``bgkoctomap.cpp:433-458``, ``:404``)."""
    if hits.device.type == "cpu":
        return compact_beam_samples_plain(hits, hit_keys, origins, anchors, kf=kf, mr=mr,
                                          fr=fr, inv_leaf=inv_leaf)
    if hits.device.type != "cuda":
        raise ValueError(f"beam_samples: unsupported device {hits.device}")
    global launches
    _check("beam_samples", {"hits": (hits, torch.float32),
                            "hit_keys": (hit_keys, torch.int64),
                            "origins": (origins, torch.float32),
                            "anchors": (anchors, torch.int32)})
    R, S = hits.shape[0], kf + 2
    if hits.shape[1:] != (3,) or hit_keys.shape != (R,) or anchors.shape != origins.shape \
            or kf < 0 or origins.shape[0] == 0:
        raise ValueError("beam_samples: inconsistent shapes")
    if R * S >= 2 ** 30:
        raise ValueError(f"beam_samples: {R} hits x {S} slots (fewer than 2^30 taken)")
    dev = hits.device
    # one allocation: keys [R·S] int64, samples [R·S,3] f32, the count, in range [R]
    n = 20 * R * S
    buf = torch.empty(n + 4 + R, dtype=torch.uint8, device=dev)
    fkeys = buf[:8 * R * S].view(torch.int64)
    fpts = buf[8 * R * S:n].view(torch.float32).view(R * S, 3)
    count = buf[n:n + 4].view(torch.int32)
    inr = buf[n + 4:].view(torch.bool)
    if R == 0:
        count.zero_()
        return fpts, fkeys, inr, count
    stream = torch.cuda.current_stream(dev).cuda_stream
    th = tile_hits(kf)
    words, epoch = ingest_members.look_back_words(dev, stream, -(-R // th))
    code = _build.lib().la3dm_ingest_beams(
        hits.data_ptr(), hit_keys.data_ptr(), origins.data_ptr(), anchors.data_ptr(), R,
        origins.shape[0], int(kf), float(mr), float(fr), float(inv_leaf), th,
        fpts.data_ptr(), fkeys.data_ptr(), inr.data_ptr(), count.data_ptr(),
        words.data_ptr() + 8, epoch, stream)
    _build.check(code, "ingest_beams")
    launches += 1
    return fpts, fkeys, inr, count


def beam_samples_plain(hits, hit_keys, origins, anchors, *, kf: int, mr: float, fr: float,
                       inv_leaf: float):
    """The dense layout, the JAX step's expressions: (samples [R·(kf+2), 3],
    their keys [R·(kf+2)] — the sentinel where masked —, in range [R]
    bool), hit j's slot k at row j·(kf+2) + k."""
    R, dev = hits.shape[0], hits.device
    scan = hit_keys >> 48
    o = origins[scan]
    diff = hits - o
    l = torch.sqrt(diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] + diff[:, 2] * diff[:, 2])
    inr = (l <= mr) & (l > 0)
    ndir = diff / torch.clamp_min(l, 1e-30)[:, None]
    karr = torch.arange(1, kf + 1, dtype=torch.float32, device=dev) * fr
    d = torch.cat([karr.expand(R, kf), (l - fr)[:, None],
                   torch.zeros((R, 1), dtype=torch.float32, device=dev)], dim=1)
    keep = torch.cat([karr[None, :] < l[:, None], (l > fr)[:, None],
                      torch.ones((R, 1), dtype=torch.bool, device=dev)], dim=1) & inr[:, None]
    fpts = (o[:, None, :] + ndir[:, None, :] * d[:, :, None]).reshape(-1, 3)
    keep = keep.reshape(-1)
    ijk = torch.where(keep[:, None], torch.floor(fpts * inv_leaf), 0.0).to(torch.int32)
    keys = ingest_keys.pack(scan.repeat_interleave(kf + 2), ijk, anchors)
    return fpts, torch.where(keep, keys, ingest_keys.SENT), inr


def compact_beam_samples_plain(hits, hit_keys, origins, anchors, *, kf: int, mr: float,
                               fr: float, inv_leaf: float):
    """The plain PyTorch :func:`beam_samples`: the dense layout's kept rows,
    in order, and their count."""
    fpts, keys, inr = beam_samples_plain(hits, hit_keys, origins, anchors, kf=kf, mr=mr, fr=fr,
                                         inv_leaf=inv_leaf)
    keep = keys != ingest_keys.SENT
    return (fpts[keep], keys[keep], inr,
            torch.tensor([int(keep.sum())], dtype=torch.int32, device=hits.device))
