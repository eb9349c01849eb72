"""K7d — the BGKL ray pass of device scan ingest: wrapper, plain version and
launch counter.

Replaces the per-ray part of ``la3dm_tpu/geometry/device_ingest.py::
_ingest_scan_bgkl`` (lines 497-574): for each downsampled hit, the range
filter, the f32 endpoint recompute ``occ = origin + ndir·l``, the free ray
(origin, origin + ndir·(l − fr)), the Kf + 1 proxy samples (the origin, then
origin + ndir·(l − k·fr) for k = 1..Kf while positive), their ≤ 8
closed-box block memberships (K7c's rule) and block keys
(:mod:`ingest_keys`), and the ray's set of distinct keys — the
per-(block, ray) dedup of ``bgkloctomap.cpp:145-172``.  The result is the
list of (ray, block key) pairs in ray order, each ray's keys ascending.
JAX keeps the first ``Rmax`` keys of a ray and retries with a larger Rmax
when a ray has more; this list is sized exactly and cuts nothing.

On CUDA tensors :func:`ray_pairs` launches ``csrc/ingest_rays.cu`` twice
(a count pass, which leaves each sample's first occurrences in a
workspace, then a write pass that ranks and scatters them, with one wait
for the list's size between them); on CPU tensors it runs :func:`ray_pairs_plain`, which sorts
each ray's row with ``torch.sort`` as the JAX step does.  The kernel finds
each ray's distinct keys by contiguity along the ray, with no sort:
:func:`first_in_ray_plain` is that rule in plain PyTorch (the tests hold it
to :func:`ray_pairs_plain`).
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import _build, ingest_keys, ingest_members
from la3dm_tpu_torch.utils import profiling

#: kernel launches since the counter was last reset (two per dispatch: the
#: count pass, then the write pass)
launches = 0
#: the most candidate keys a ray may have (8 a sample): the write pass stages
#: a ray's distinct keys, at most this many, in shared memory
MAX_ROW = 16384


def lanes_per_ray(kf: int) -> int:
    """The lanes the kernel gives a ray: one a sample, the power of two ≥
    kf + 1 up to a warp (rays of more samples run in chunks of 32)."""
    return min(32, 1 << int(np.ceil(np.log2(kf + 1))))


#: a pinned host copy of the two sizes per device (the list's size, the
#: longest row), reused by every call (each waits for its copy first)
_HOST_SIZES: dict = {}


def ray_pairs(hits, hit_keys, origins, anchors, *, kf: int, mr: float, fr: float,
              block_size: float, want_samples: bool = False):
    """Per hit ``hits`` [R,3] (its scan from ``hit_keys`` [R], origins
    [K,3], block anchors [K,3] int32): (occ [R,3], seg [R,6], inr [R],
    pair_ray [P] int64, pair_key [P] int64, samples [R, kf+1, 3] or None).
    ``mr`` and ``fr`` are f32 values; ``samples`` only if ``want_samples``
    (the main path does not read them).  On the card the wrapper waits once,
    between its two launches, for the list's size."""
    if hits.device.type == "cpu":
        return ray_pairs_plain(hits, hit_keys, origins, anchors, kf=kf, mr=mr, fr=fr,
                               block_size=block_size, want_samples=want_samples)
    if hits.device.type != "cuda":
        raise ValueError(f"ray_pairs: unsupported device {hits.device}")
    global launches
    want = {"hits": (hits, torch.float32), "hit_keys": (hit_keys, torch.int64),
            "origins": (origins, torch.float32), "anchors": (anchors, torch.int32)}
    for k, (x, dt) in want.items():
        if x.device != hits.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"ray_pairs: {k} must be a contiguous {dt} tensor on "
                             f"{hits.device}")
    R, S = hits.shape[0], kf + 1
    if hits.shape[1:] != (3,) or hit_keys.shape != (R,) or anchors.shape != origins.shape \
            or kf < 0:
        raise ValueError("ray_pairs: inconsistent shapes")
    if 8 * S > MAX_ROW:
        raise ValueError(f"ray_pairs: {8 * S} candidates a ray exceed the kernel's "
                         f"{MAX_ROW}-key row")
    dev = hits.device
    occ = torch.empty((R, 3), dtype=torch.float32, device=dev)
    seg = torch.empty((R, 6), dtype=torch.float32, device=dev)
    inr = torch.empty(R, dtype=torch.bool, device=dev)
    samples = torch.empty((R, S, 3), dtype=torch.float32, device=dev) if want_samples \
        else None
    if R == 0:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return occ, seg, inr, empty, empty, samples
    bs, half = ingest_members._sizes(block_size)
    stream = torch.cuda.current_stream(dev)
    lib = _build.lib()
    n_work = lib.la3dm_ingest_rays_workspace(R, int(kf))
    work = torch.empty(n_work, dtype=torch.uint8, device=dev)
    if dev not in _HOST_SIZES:
        _HOST_SIZES[dev] = torch.empty(2, dtype=torch.int64, pin_memory=True)
    host = _HOST_SIZES[dev]
    common = (hits.data_ptr(), hit_keys.data_ptr(), origins.data_ptr(), anchors.data_ptr(),
              R, int(kf), float(mr), float(fr), bs, half, work.data_ptr(), n_work)
    code = lib.la3dm_ingest_rays_count(*common, host.data_ptr(), occ.data_ptr(),
                                       seg.data_ptr(), inr.data_ptr(),
                                       samples.data_ptr() if want_samples else None,
                                       stream.cuda_stream)
    _build.check(code, "ingest_rays (count)")
    launches += 1
    with profiling.span("la3dm.sync.ray_pairs"):
        stream.synchronize()                      # a host sync: the list's size
        total, cap = host.tolist()
    profiling.count("host_syncs")
    pair_ray = torch.empty(total, dtype=torch.int64, device=dev)
    pair_key = torch.empty(total, dtype=torch.int64, device=dev)
    code = lib.la3dm_ingest_rays_write(*common, cap, total, pair_ray.data_ptr(),
                                       pair_key.data_ptr(), stream.cuda_stream)
    _build.check(code, "ingest_rays (write)")
    launches += 1
    return occ, seg, inr, pair_ray, pair_key, samples


def _rays_plain(hits, hit_keys, origins, *, kf: int, mr: float, fr: float,
                block_size: float):
    """The plain ray pass up to the memberships: (scan, occ, seg, inr,
    samples [R,S,3], their mask [R,S] (in range, d > 0), their block
    coordinates [R·S,8,3] and membership flags [R·S,8])."""
    dev = hits.device
    scan = hit_keys >> 48
    o = origins[scan]
    diff = hits - o
    l = torch.sqrt(diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] + diff[:, 2] * diff[:, 2])
    inr = (l <= mr) & (l > 0)
    ndir = diff / torch.clamp_min(l, 1e-30)[:, None]
    occ = o + ndir * l[:, None]
    seg = torch.cat([o, o + ndir * (l - fr)[:, None]], dim=1)
    karr = torch.arange(1, kf + 1, dtype=torch.float32, device=dev) * fr
    d = l[:, None] - karr[None, :]                                       # [R,kf]
    samples = torch.cat([o[:, None, :], o[:, None, :] + ndir[:, None, :] * d[:, :, None]],
                        dim=1)                                           # [R,S,3]
    smask = torch.cat([inr[:, None], (d > 0.0) & inr[:, None]], dim=1)   # [R,S]
    mcoord, mok = ingest_members.closed_box_memberships(samples.reshape(-1, 3),
                                                        smask.reshape(-1), block_size)
    return scan, occ, seg, inr, samples, smask, mcoord, mok


def ray_keys_plain(hits, hit_keys, origins, anchors, *, kf: int, mr: float, fr: float,
                   block_size: float):
    """(occ, seg, inr, samples [R,S,3], keys [R,S,8] int64, kept [R,S]): each
    proxy sample's closed-box membership keys (the sentinel where none;
    sample 0 the origin, then k = 1..kf) and whether it is kept (in range,
    d > 0)."""
    R, S = hits.shape[0], kf + 1
    scan, occ, seg, inr, samples, smask, mcoord, mok = _rays_plain(
        hits, hit_keys, origins, kf=kf, mr=mr, fr=fr, block_size=block_size)
    keys = ingest_keys.pack(scan.repeat_interleave(S * 8), mcoord.reshape(-1, 3), anchors)
    keys = torch.where(mok.reshape(-1), keys, ingest_keys.SENT).reshape(R, S, 8)
    return occ, seg, inr, samples, keys, smask


def ray_pairs_plain(hits, hit_keys, origins, anchors, *, kf: int, mr: float, fr: float,
                    block_size: float, want_samples: bool = False):
    """The plain PyTorch :func:`ray_pairs`: the JAX step's expressions, the
    memberships of :func:`ingest_members.closed_box_memberships`, and a
    ``torch.sort`` of each ray's row with first-in-run flags."""
    R = hits.shape[0]
    occ, seg, inr, samples, keys, _ = ray_keys_plain(
        hits, hit_keys, origins, anchors, kf=kf, mr=mr, fr=fr, block_size=block_size)
    skey = torch.sort(keys.reshape(R, -1), dim=1).values
    first = torch.cat([skey[:, :1] != ingest_keys.SENT,
                       (skey[:, 1:] != skey[:, :-1]) & (skey[:, 1:] != ingest_keys.SENT)],
                      dim=1)
    ray, col = torch.nonzero(first, as_tuple=True)                       # row-major
    return occ, seg, inr, ray, skey[ray, col], samples if want_samples else None


def d_order(kf: int) -> torch.Tensor:
    """The order in which the kernel walks a ray's samples: k = 1..kf (d =
    l − k·fr falling), then the origin (d = 0)."""
    return torch.cat([torch.arange(1, kf + 1), torch.zeros(1, dtype=torch.int64)])


def first_in_ray_plain(keys, kept, order):
    """K7d's dedup rule in plain PyTorch: the samples of each ray walked in
    ``order`` [S] (``keys`` [R,S,8] and ``kept`` [R,S] of
    :func:`ray_keys_plain`); a membership of a kept sample is kept where it
    is not a membership of the kept sample before it.  Returns the kept
    (pair_ray, pair_key), in ray order and each ray's keys ascending.

    In d-order (:func:`d_order`) these are each ray's distinct keys.  A line
    meets a closed box in one interval of its parameter, and the f32 samples
    keep that: d = l − k·fr is non-increasing in k (a rounded product or sum
    is monotone in each argument), the origin is the sample at d = 0, and on
    each axis p = o + n·d, floor(p/bs + 0.5) and each closed-box test are
    monotone in d; so the kept samples holding a block form one run in
    d-order, and a membership is its block's first occurrence exactly when
    the kept sample before it does not hold that block."""
    keys, kept = keys[:, order], kept[:, order]
    R, S, _ = keys.shape
    idx = torch.arange(S, device=keys.device).expand(R, S)
    last = torch.where(kept, idx, -1).cummax(dim=1).values               # last kept ≤ i
    prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], dim=1)
    pkeys = torch.gather(keys, 1, prev.clamp_min(0)[:, :, None].expand(R, S, 8))
    seen = (keys[:, :, :, None] == pkeys[:, :, None, :]).any(-1) & (prev >= 0)[:, :, None]
    first = (keys != ingest_keys.SENT) & kept[:, :, None] & ~seen
    row = torch.sort(torch.where(first, keys, ingest_keys.SENT).reshape(R, -1), dim=1).values
    ray, col = torch.nonzero(row != ingest_keys.SENT, as_tuple=True)
    return ray, row[ray, col]


def ray_work(hits, hit_keys, origins, *, kf: int, mr: float, fr: float,
             block_size: float):
    """(samples [R], memberships [R]) int64: each ray's proxy samples (in
    range, d > 0) and their closed-box block memberships, the work the
    ray pass needs for these hits (the count of K7d's bound)."""
    *_, smask, _, mok = _rays_plain(hits, hit_keys, origins, kf=kf, mr=mr, fr=fr,
                                    block_size=block_size)
    return smask.sum(1), mok.reshape(hits.shape[0], -1).sum(1)
