"""Minimal PCD v0.7 reader/writer (ascii + binary) with VIEWPOINT origin.

Replaces the reference's pcl::io::loadPCDFile usage
(``src/bgkoctomap/bgkoctomap_static_node.cpp:7-16``): the static pipeline
reads ``dir/prefix_i.pcd`` and takes the sensor origin from the VIEWPOINT
header field.
"""

from __future__ import annotations

import numpy as np

_SIZES = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
          ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def load_pcd(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a PCD file → (points [N,3] float32, origin [3] float32)."""
    with open(path, "rb") as f:
        raw = f.read()

    header_lines = []
    off = 0
    while True:
        nl = raw.index(b"\n", off)
        line = raw[off:nl].decode("ascii", "replace").strip()
        off = nl + 1
        if line and not line.startswith("#"):
            header_lines.append(line)
        if line.startswith("DATA"):
            break

    meta = {}
    for line in header_lines:
        k, _, v = line.partition(" ")
        meta[k] = v.split()

    fields = meta["FIELDS"]
    sizes = [int(s) for s in meta["SIZE"]]
    types = meta["TYPE"]
    counts = [int(c) for c in meta.get("COUNT", ["1"] * len(fields))]
    npoints = int(meta["POINTS"][0])
    origin = np.array([float(x) for x in meta.get("VIEWPOINT", ["0", "0", "0"])[:3]], np.float32)
    mode = meta["DATA"][0]

    dtype = []
    for name, sz, ty, ct in zip(fields, sizes, types, counts):
        base = _SIZES[(ty, sz)]
        dtype.append((name, base, (ct,)) if ct > 1 else (name, base))
    dt = np.dtype(dtype)

    if mode == "binary":
        data = np.frombuffer(raw, dtype=dt, count=npoints, offset=off)
    elif mode == "ascii":
        rows = np.loadtxt(raw[off:].decode().splitlines(), dtype=np.float64, ndmin=2)
        data = np.zeros(npoints, dt)
        col = 0
        for name, ct in zip(fields, counts):
            data[name] = rows[:, col] if ct == 1 else rows[:, col:col + ct]
            col += ct
    else:
        raise ValueError(f"unsupported PCD DATA mode {mode!r}")

    pts = np.stack([data["x"], data["y"], data["z"]], axis=-1).astype(np.float32)
    finite = np.isfinite(pts).all(axis=1)
    return pts[finite], origin


def load_pcd_full(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Like :func:`load_pcd`, plus the VIEWPOINT orientation.

    Returns (points [N,3], origin [3], quat [4] xyzw).  The PCD VIEWPOINT
    field is ``tx ty tz qw qx qy qz``; reordered here to xyzw to match the
    rosbag pose convention (io/rosbag.py) for the server motion gate.
    """
    pts, origin = load_pcd(path)
    with open(path, "rb") as f:
        head = f.read(4096)
    quat = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    for line in head.split(b"\n"):
        if line.startswith(b"VIEWPOINT"):
            vals = [float(x) for x in line.split()[1:]]
            if len(vals) >= 7:
                w, x, y, z = vals[3:7]
                quat = np.array([x, y, z, w], np.float32)
            break
    return pts, origin, quat


def save_pcd(path: str, points: np.ndarray, origin=(0.0, 0.0, 0.0)) -> None:
    points = np.asarray(points, np.float32).reshape(-1, 3)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {len(points)}\nHEIGHT 1\n"
        f"VIEWPOINT {origin[0]} {origin[1]} {origin[2]} 1 0 0 0\n"
        f"POINTS {len(points)}\nDATA binary\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(points.astype("<f4").tobytes())


def load_scan_sequence(directory: str, prefix: str, scan_num: int):
    """Yield (points, origin) for dir/prefix_1.pcd … prefix_N.pcd
    (bgkoctomap_static_node.cpp:89-93)."""
    for i in range(1, scan_num + 1):
        yield load_pcd(f"{directory}/{prefix}_{i}.pcd")
