"""Map export: colored voxel sets as PLY / NPZ / JSON marker groups.

The serving-side replacement for the reference's RViz MarkerArray publishing
(static_node.cpp:101-140): occupied leaves height-colored, free leaves
probability-colored, cubes grouped by size depth.  (The port's own copy of
``la3dm_tpu/viz/markers.py``: the same bytes for the same leaves.)
"""

from __future__ import annotations

import json

import numpy as np

from la3dm_tpu_torch.viz import colormap


def marker_groups(leaves: dict, resolution: float, min_z: float, max_z: float) -> dict:
    """Build the 10-group CUBE_LIST structure of MarkerArrayPub.

    ``leaves`` is the dict from ``OccupancyMapBase.leaves()`` filtered to one
    state class.  Returns {depth: {positions, sizes, colors}}.
    """
    depth = colormap.marker_depth(leaves["size"], resolution)
    out = {}
    for d in np.unique(depth):
        sel = depth == d
        out[int(d)] = {
            "positions": np.stack([leaves["x"][sel], leaves["y"][sel], leaves["z"][sel]], -1),
            "size": float(resolution * (2 ** int(d))),
            "prob": leaves["prob"][sel],
        }
    return out


def export_ply(path: str, leaves: dict, mode: str, resolution: float,
               min_z: float, max_z: float) -> int:
    """Write voxel centers as a colored PLY point cloud.

    mode="occupied" → height coloring; mode="free" → probability coloring.
    Returns the number of points written.
    """
    xyz = np.stack([leaves["x"], leaves["y"], leaves["z"]], -1).astype(np.float32)
    if mode == "occupied":
        rgb = colormap.occupied_colors(leaves["z"], min_z, max_z)
    else:
        rgb = colormap.free_colors(leaves["prob"])
    rgb8 = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    n = len(xyz)
    with open(path, "wb") as f:
        f.write((
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n").encode())
        rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
        rec["xyz"] = xyz
        rec["rgb"] = rgb8
        f.write(rec.tobytes())
    return n


def export_csv(path: str, leaves: dict) -> int:
    """x,y,z,size rows — the format of the reference's evaluation artifact
    data/sim_structured/sim_structured_octomap.csv."""
    arr = np.stack([leaves["x"], leaves["y"], leaves["z"], leaves["size"]], -1)
    np.savetxt(path, arr, delimiter=",", fmt="%.6f")
    return len(arr)


def export_npz(path: str, leaves: dict) -> None:
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in leaves.items()})
