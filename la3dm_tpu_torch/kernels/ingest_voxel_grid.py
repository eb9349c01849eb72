"""K7v — the server's pre-downsample (PCL's VoxelGrid) on the card: wrapper,
plain version and launch counter.

Replaces no JAX kernel: the JAX ``OnlineIntegrator`` downsamples each raw
cloud on the host (``la3dm_tpu/pipeline.py``, ``geometry/preprocess.py::
voxel_downsample``), and so did the port.  :func:`voxel_grid` gives what
``preprocess.voxel_downsample`` gives, bit for bit, on the cloud's device:
each point's cell ``floor(p · float32(1/leaf))`` in float32, the cells
z-major (x fastest) as ``np.lexsort`` orders them, each cell's points
summed in float64 as ``np.add.reduceat`` sums them — the first point plus
numpy's pairwise sum of the rest (:func:`pairwise_sum_plain`) — and the
centroid ``float32(sum / count)``.

The cells are K7s keys (``ingest_keys``' layout, scan 0) round the cell of
``center``, in the widest one-scan window device ingest accepts
(:data:`WINDOW`, 512 cells an axis each way: 256 m at the large map's 0.5 m
leaf).  A point that is not finite, or whose cell lies outside the window,
is left out (its key is the sentinel), and with it its cell: the centroids
are numpy's without the cells of those points.  Where the window reaches
past ``max_range + √3·leaf`` (:func:`covers`, true wherever device ingest
takes the config), device ingest drops those cells' centroids by range
(``ingest_beams.point_keys``: ``|c − origin|² <= lim``, which a NaN
fails too), so a map fed either builds the same pool.

On CUDA tensors :func:`launch` queues ``csrc/ingest_voxel_grid.cu``'s key
kernel, one K7s sort (``ingest_sort.launch``) and the reduce kernel without
a wait, and :func:`voxel_grid` waits once, for K7s's status (the span
``la3dm.sync.server_ds``, one ``host_syncs``); on CPU tensors it runs
:func:`voxel_grid_plain`.  What bounds the kernels is bytes, under a
microsecond at a VLP-16 cloud; their launches set their time.
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import _build, ingest_keys, ingest_sort
from la3dm_tpu_torch.utils import profiling

#: kernel launches since the counter was last reset (two a cloud on the
#: card: the keys, the reduce; the sort between them counts in ingest_sort)
launches = 0

#: the cells' window round the anchor cell: the widest that K7s sorts in
#: one 31-bit code
WINDOW = ingest_sort.widest_window(1)

#: numpy's ``PW_BLOCKSIZE``: the most values of a pairwise leaf
PAIRWISE_LEAF = 128


def _anchor(center, inv: float) -> np.ndarray | None:
    """The cell [3] int64 of ``center`` [3], or None where it is not finite
    or beyond 2^31 cells."""
    a = np.floor(np.asarray(center, np.float64).reshape(3) * inv)
    return a.astype(np.int64) if (np.abs(a) < 2.0 ** 31).all() else None


def _inv(leaf: float) -> float:
    """float32(1 / leaf), the quotient taken in float64 as numpy takes it."""
    return float(np.float32(1.0 / leaf))


def covers(leaf: float, max_range: float) -> bool:
    """Whether every cell outside :data:`WINDOW` lies past ``max_range +
    √3·leaf`` of the origin, where device ingest drops points by range (a
    passthrough, ``leaf < 0``, leaves nothing out)."""
    return leaf < 0 or WINDOW.radius * leaf > max_range + np.sqrt(3.0) * leaf


def launch(pts: torch.Tensor, leaf: float, center) -> tuple[torch.Tensor, torch.Tensor]:
    """Queue K7v on the current stream and return without waiting:
    (centroids [N,3] f32, valid on their first R rows; K7s's status [4]
    int32 on the card — valid keys, runs R, the out-of-window flag).
    ``pts`` [N,3] f32 on a CUDA device, N ≥ 1; ``center``'s cell finite
    and within 2^31 cells of 0."""
    global launches
    if pts.device.type != "cuda":
        raise ValueError(f"ingest_voxel_grid.launch: unsupported device {pts.device}")
    if pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[1] != 3 \
            or not pts.is_contiguous():
        raise ValueError("ingest_voxel_grid: pts must be a contiguous [N,3] float32 tensor")
    N = pts.shape[0]
    if not 1 <= N < 2 ** 30:
        raise ValueError(f"ingest_voxel_grid: {N} points (1 to 2^30 - 1 taken)")
    inv = _inv(leaf)
    a = _anchor(center, inv)
    if a is None:
        raise ValueError(f"ingest_voxel_grid: the cell of {center} is not finite within 2^31")
    dev = pts.device
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    keys = torch.empty(N, dtype=torch.int64, device=dev)
    code = lib.la3dm_ingest_voxel_grid_keys(pts.data_ptr(), N, inv, *(int(v) for v in a),
                                            WINDOW.radius, keys.data_ptr(), stream)
    _build.check(code, "ingest_voxel_grid_keys")
    out, _, status = ingest_sort.launch(keys, WINDOW)
    cent = torch.empty((N, 3), dtype=torch.float32, device=dev)
    code = lib.la3dm_ingest_voxel_grid_reduce(pts.data_ptr(), out[0].data_ptr(),
                                              out[2].data_ptr(), out[3].data_ptr(),
                                              status.data_ptr(), N, cent.data_ptr(), stream)
    _build.check(code, "ingest_voxel_grid_reduce")
    launches += 2
    return cent, status


def voxel_grid(pts: torch.Tensor, leaf: float, center) -> torch.Tensor:
    """The centroids [R,3] f32 of the cells of ``pts`` [N,3] f32 at
    ``leaf`` that lie in :data:`WINDOW` round the cell of ``center`` [3],
    on ``pts``' device, bit-equal to ``preprocess.voxel_downsample``'s
    centroids of those cells; the cells of points that are not finite are
    left out too, and all cells where ``center`` has no cell (not finite, or
    past 2^31 cells); ``pts`` itself where ``leaf < 0`` (a passthrough, as
    numpy's)."""
    if pts.device.type == "cpu":
        return voxel_grid_plain(pts, leaf, center)
    if leaf < 0 or pts.shape[0] == 0:
        return pts
    if _anchor(center, _inv(leaf)) is None:
        return pts[:0]
    cent, status = launch(pts, leaf, center)
    dev = pts.device
    with profiling.span("la3dm.sync.server_ds"):
        host = ingest_sort.host_status(dev)
        host.copy_(status, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        V, R, flag, _ = host.tolist()
    profiling.count("host_syncs")
    if flag:
        raise RuntimeError("ingest_voxel_grid: K7s flagged a key its window cannot hold")
    return cent[:R]


def voxel_grid_plain(pts: torch.Tensor, leaf: float, center) -> torch.Tensor:
    """The plain PyTorch :func:`voxel_grid`: the points the kernel keys,
    their keys and window, ``ingest_sort.sort_runs_plain``, each run summed
    by :func:`pairwise_sum_plain` (the runs of one length at once)."""
    if leaf < 0 or pts.shape[0] == 0:
        return pts
    inv = _inv(leaf)
    a = _anchor(center, inv)
    if a is None:
        return pts[:0]
    dev = pts.device
    c = torch.floor(pts * torch.tensor(inv, dtype=torch.float32))
    ok = (c.abs() < 2.0 ** 31).all(-1)
    anchor = torch.as_tensor(a, device=dev)
    ijk = torch.where(ok[:, None], c, 0.0).long()
    ok &= ((ijk - anchor).abs() <= WINDOW.radius).all(-1)
    pts, ijk = pts[ok], ijk[ok]
    N = pts.shape[0]
    keys = ingest_keys.pack(torch.zeros(N, dtype=torch.int64, device=dev), ijk, anchor[None])
    runs = ingest_sort.sort_runs_plain(keys, WINDOW)
    vals = pts[runs.perm].double()
    sums = torch.empty((runs.counts.shape[0], 3), dtype=torch.float64, device=dev)
    for n in torch.unique(runs.counts).tolist():
        sel = torch.nonzero(runs.counts == n).squeeze(1)
        x = vals[runs.starts[sel, None] + torch.arange(n, device=dev)]    # [k, n, 3]
        sums[sel] = x[:, 0] + pairwise_sum_plain(x[:, 1:])
    return (sums / runs.counts.double()[:, None]).float()


def pairwise_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """numpy's ``pairwise_sum`` (``loops_utils.h``) of ``x`` [k, n, 3] over
    its second axis: under 8 values a running sum from -0.0; up to
    :data:`PAIRWISE_LEAF` eight running sums a stride of 8 apart, combined
    as ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then the tail;
    above, the sums of two halves, the first n / 2 rounded down to a
    multiple of 8."""
    n = x.shape[1]
    if n < 8:
        s = torch.full((x.shape[0], x.shape[2]), -0.0, dtype=x.dtype, device=x.device)
        for i in range(n):
            s = s + x[:, i]
        return s
    if n <= PAIRWISE_LEAF:
        full = n - n % 8
        r = x[:, :8]
        for i in range(8, full, 8):
            r = r + x[:, i:i + 8]
        s = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + ((r[:, 4] + r[:, 5])
                                                           + (r[:, 6] + r[:, 7]))
        for i in range(full, n):
            s = s + x[:, i]
        return s
    n2 = n // 2
    n2 -= n2 % 8
    return pairwise_sum_plain(x[:, :n2]) + pairwise_sum_plain(x[:, n2:])
