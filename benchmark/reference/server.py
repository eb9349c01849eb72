"""The server's pre-downsample, worked out again from a raw cloud: the
upstream server node (``bgkoctomap_server.cpp:70-82``) runs each cloud
through a ``pcl::VoxelGrid`` at ``ds_resolution`` before it reaches
``insert_pointcloud``.

PCL's semantics: a point's cell is floor(p · (1/leaf)) per axis, in float32
as PCL computes it; each occupied cell gives the centroid of its points,
summed in float64 and cast to float32; the centroids come out in the cells'
z-major order (x fastest).  The sums run over each cell's points in their
order in the cloud.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ingest


def voxel_grid(cloud: np.ndarray, leaf: float, device) -> np.ndarray:
    """The centroids [R, 3] float32 of the cells of ``cloud`` [N, 3]."""
    pts = torch.as_tensor(np.asarray(cloud, np.float32), device=device)
    if pts.shape[0] == 0:
        return np.zeros((0, 3), np.float32)
    zero = torch.zeros(pts.shape[0], dtype=torch.int64, device=device)
    keys = ingest.cell_keys(pts, zero, torch.ones_like(zero, dtype=torch.bool), leaf)
    perm, _, starts, counts = ingest.runs(keys)
    R = counts.shape[0]
    order = torch.argsort(counts, descending=True, stable=True)
    cnt, st = counts[order], starts[order]
    neg = -cnt.cpu().numpy()                      # ascending
    s = torch.zeros((R, 3), dtype=torch.float64, device=device)
    for j in range(int(-neg[0])):
        live = int(np.searchsorted(neg, -j))      # the cells with more than j points
        s[:live] = s[:live] + pts[perm[st[:live] + j]].double()
    out = torch.empty_like(s)
    out[order] = s / cnt.double()[:, None]
    return out.to(torch.float32).cpu().numpy()
