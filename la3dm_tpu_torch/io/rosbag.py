"""Minimal ROS1 bag (v2.0) reader — PointCloud2 + Pose topics, stdlib only.

The reference's online nodes consume ``sensor_msgs/PointCloud2`` from bags
like ``data/sim_structured.bag`` (topics ``/selected_pc2_map`` +
``/robot_pose``).  This reader handles uncompressed and bz2 chunks, enough
to replay those bags through the server pipeline without ROS.  (The port's
own copy of ``la3dm_tpu/io/rosbag.py``.)
"""

from __future__ import annotations

import bz2
import struct

import numpy as np

_OP_CHUNK = 0x05
_OP_CONNECTION = 0x07
_OP_MSG_DATA = 0x02


def _parse_fields(data: bytes, start: int, end: int) -> dict:
    """Parse a rosbag header-field region [start, end) → {name: bytes}."""
    fields = {}
    off = start
    while off < end:
        flen = struct.unpack_from("<I", data, off)[0]
        off += 4
        item = data[off:off + flen]
        off += flen
        k, _, v = item.partition(b"=")
        fields[k.decode()] = v
    return fields


def _records(data: bytes):
    """Yield (header_fields, payload) for each record in a byte region."""
    off = 0
    n = len(data)
    while off + 4 <= n:
        hlen = struct.unpack_from("<I", data, off)[0]
        fields = _parse_fields(data, off + 4, off + 4 + hlen)
        off += 4 + hlen
        dlen = struct.unpack_from("<I", data, off)[0]
        off += 4
        payload = data[off:off + dlen]
        off += dlen
        yield fields, payload


def read_messages(path: str, topics=None):
    """Yield (topic, msg_type, raw_bytes, time_ns) for every message."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"not a ROS bag v2.0: {path}")
        data = f.read()

    connections: dict[int, tuple[str, str]] = {}
    messages = []

    def handle(fields, payload):
        op = fields.get("op", b"\x00")[0]
        if op == _OP_CONNECTION:
            conn = struct.unpack("<I", fields["conn"])[0]
            hdr = _parse_fields(payload, 0, len(payload))
            topic = (fields.get("topic") or hdr.get("topic", b"")).decode()
            connections[conn] = (topic, hdr.get("type", b"").decode())
        elif op == _OP_MSG_DATA:
            conn = struct.unpack("<I", fields["conn"])[0]
            t = struct.unpack("<Q", fields["time"])[0] if "time" in fields else 0
            messages.append((conn, payload, t))

    for fields, payload in _records(data):
        op = fields.get("op", b"\x00")[0]
        if op == _OP_CHUNK:
            comp = fields.get("compression", b"none").decode()
            chunk = bz2.decompress(payload) if comp == "bz2" else payload
            for cf, cp in _records(chunk):
                handle(cf, cp)
        else:
            handle(fields, payload)

    for conn, payload, t in messages:
        topic, mtype = connections.get(conn, ("?", "?"))
        if topics is None or topic in topics:
            yield topic, mtype, payload, t


def parse_pointcloud2(raw: bytes) -> np.ndarray:
    """Deserialize sensor_msgs/PointCloud2 → points [N,3] float32."""
    off = 0
    off += 4 + 8  # header: seq + stamp
    slen = struct.unpack_from("<I", raw, off)[0]
    off += 4 + slen  # frame_id
    height, width = struct.unpack_from("<II", raw, off)
    off += 8
    nfields = struct.unpack_from("<I", raw, off)[0]
    off += 4
    fields = []
    for _ in range(nfields):
        nlen = struct.unpack_from("<I", raw, off)[0]
        off += 4
        name = raw[off:off + nlen].decode()
        off += nlen
        foffset, datatype, count = struct.unpack_from("<IBI", raw, off)
        off += 9
        fields.append((name, foffset, datatype, count))
    off += 1  # is_bigendian
    point_step, _row_step = struct.unpack_from("<II", raw, off)
    off += 8
    dlen = struct.unpack_from("<I", raw, off)[0]
    off += 4
    body = raw[off:off + dlen]

    n = len(body) // point_step
    out = np.zeros((n, 3), np.float32)
    arr = np.frombuffer(body[:n * point_step], np.uint8).reshape(n, point_step)
    for name, foff, dt, _cnt in fields:
        if name in ("x", "y", "z") and dt == 7:  # FLOAT32
            out[:, "xyz".index(name)] = arr[:, foff:foff + 4].copy().view(np.float32)[:, 0]
    finite = np.isfinite(out).all(axis=1)
    return out[finite]


def parse_pose(raw: bytes) -> np.ndarray:
    """geometry_msgs/PoseStamped (or Pose) → position [3] float64."""
    return parse_pose_full(raw)[0]


def parse_pose_full(raw: bytes) -> tuple[np.ndarray, np.ndarray]:
    """geometry_msgs/PoseStamped (or Pose) → (position [3], quaternion [4] xyzw)."""
    off = 0
    if len(raw) > 56:  # stamped: skip std_msgs/Header
        off += 4 + 8
        slen = struct.unpack_from("<I", raw, off)[0]
        off += 4 + slen
    x, y, z = struct.unpack_from("<ddd", raw, off)
    qx, qy, qz, qw = struct.unpack_from("<dddd", raw, off + 24)
    return np.array([x, y, z]), np.array([qx, qy, qz, qw])


def quat_angle(q1: np.ndarray, q2: np.ndarray) -> float:
    """Rotation angle (rad) between two unit quaternions (xyzw)."""
    d = abs(float(np.dot(q1, q2)))
    return 2.0 * float(np.arccos(min(1.0, d)))


def replay(path: str, cloud_topic: str = "/selected_pc2_map",
           pose_topic: str = "/robot_pose", with_orientation: bool = False):
    """Yield (points [N,3], origin [3][, quat [4]]) tuples, pairing each cloud
    with the nearest-time pose (the reference server's tf lookup equivalent,
    which waits for the transform; bgkoctomap_server.cpp:46-53)."""
    poses, clouds = [], []
    for topic, _mtype, payload, t in read_messages(path, topics={cloud_topic, pose_topic}):
        if topic == pose_topic:
            poses.append((t,) + parse_pose_full(payload))
        elif topic == cloud_topic:
            clouds.append((t, payload))
    if not poses:
        poses = [(0, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))]
    pt = np.array([t for t, _, _ in poses], dtype=np.float64)
    for t, payload in clouds:
        i = int(np.argmin(np.abs(pt - t)))
        if with_orientation:
            yield parse_pointcloud2(payload), poses[i][1].astype(np.float32), poses[i][2]
        else:
            yield parse_pointcloud2(payload), poses[i][1].astype(np.float32)
