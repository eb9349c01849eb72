"""K7b — the segmented centroid reduction of device scan ingest: wrapper,
plain version and launch counter.

Replaces the reduction of ``la3dm_tpu/geometry/device_ingest.py::
_downsample`` (lines 192-246).  The caller stable-sorts the voxel keys and
cuts the runs (K7s); :func:`centroids` gives each run's compensated centroid
``corner + Σ(p − corner) / count``, the corner decoded from the run's key
(``cell · leaf``), the sum taken in sorted order.  It serves the hit and the
free-sample downsample alike.

On CUDA tensors it launches ``csrc/ingest_downsample.cu`` (one lane a run
of at most :data:`LONG_RUN` members, the whole warp a longer one, the sums
in the same order); on CPU tensors it runs :func:`centroids_plain`.  What
bounds the kernel is bytes.
"""

from __future__ import annotations

import torch

from la3dm_tpu_torch.kernels import _build, ingest_keys

#: kernel launches since the counter was last reset (two per dispatch: the
#: hits, then the free samples)
launches = 0
#: runs of more members are summed by a whole warp (``kLong`` in the source)
LONG_RUN = 64


def centroids(pts, perm, starts, counts, run_keys, anchors, *, leaf: float):
    """Centroids [R,3] f32 of the runs (``starts``/``counts`` [R] int64 into
    the sort index ``perm``, over points ``pts`` [N,3]; ``run_keys`` [R] the
    runs' voxel keys, ``anchors`` [K,3] int32)."""
    if pts.device.type == "cpu":
        return centroids_plain(pts, perm, starts, counts, run_keys, anchors, leaf=leaf)
    if pts.device.type != "cuda":
        raise ValueError(f"centroids: unsupported device {pts.device}")
    global launches
    want = {"pts": (pts, torch.float32), "perm": (perm, torch.int64),
            "starts": (starts, torch.int64), "counts": (counts, torch.int64),
            "run_keys": (run_keys, torch.int64), "anchors": (anchors, torch.int32)}
    for k, (x, dt) in want.items():
        if x.device != pts.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"centroids: {k} must be a contiguous {dt} tensor on "
                             f"{pts.device}")
    R = counts.shape[0]
    if pts.shape[1:] != (3,) or starts.shape != (R,) or run_keys.shape != (R,) \
            or anchors.shape[1:] != (3,):
        raise ValueError("centroids: inconsistent shapes")
    cent = torch.empty((R, 3), dtype=torch.float32, device=pts.device)
    if R == 0:
        return cent
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    code = _build.lib().la3dm_ingest_downsample(
        pts.data_ptr(), perm.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        run_keys.data_ptr(), anchors.data_ptr(), R, float(leaf), cent.data_ptr(), stream)
    _build.check(code, "ingest_downsample")
    launches += 1
    return cent


def centroids_plain(pts, perm, starts, counts, run_keys, anchors, *, leaf: float):
    """The plain PyTorch :func:`centroids`: each run summed in sorted order,
    as the kernel sums it.  Runs go longest first, so that step j adds the
    j-th member of a prefix of them (one host read of the counts)."""
    R, dev = counts.shape[0], pts.device
    corner = ingest_keys.unpack(run_keys, anchors).to(torch.float32) * leaf
    if R == 0:
        return corner
    order = torch.argsort(counts, descending=True, stable=True)
    cnt = counts[order]
    st, cor = starts[order], corner[order]
    cnt_h = cnt.cpu()
    # runs with more than j members: -cnt is ascending, count its entries < -j
    active = torch.searchsorted(-cnt_h, -torch.arange(int(cnt_h[0]), dtype=torch.int64))
    s = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    for j, n in enumerate(active.tolist()):
        p = perm[st[:n] + j]
        s[:n] = s[:n] + (pts[p] - cor[:n])
    out = torch.empty_like(s)
    out[order] = cor + s / cnt.to(torch.float32)[:, None]
    return out
