"""ctypes bindings for the native host-preprocessing library.

Builds the repository's C++ source ``native/host_preprocess.cpp`` into the
port's build directory (``la3dm_tpu_torch/build/``, git-ignored) at first
use, and rebuilds it when the source is newer.  Bound: the BGK and GP
host-ingest paths (:func:`bgk_training_data`, :func:`scan_bucket_tables`,
:func:`row_tables`), the BGKL one (:func:`bgkl_training_data`,
:func:`bgkl_scan_tables`, then :func:`row_tables`) and the BGKLV one
(:func:`lv_training_data`, :func:`lv_tile_tables_ray`).  There is no numpy stand-in: if the library
cannot be built, the call raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from la3dm_tpu_torch.geometry.preprocess import PointTrainingData, SegmentTrainingData

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "host_preprocess.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
_SO = os.path.join(BUILD_DIR, "libla3dm_host.so")

_lib = None
_load_lock = threading.Lock()  # insert_pointclouds preprocesses in a pool


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # -ffp-contract=off: no FMA contraction, so float expressions
            # round exactly like numpy's and the training points stay
            # bit-identical to the numpy pipeline (the k̄ update gate sits on
            # the sparse kernel's support boundary, where the last ulp
            # decides).  Build to a temp path + atomic rename so a concurrent
            # process never dlopens a partially written library.
            tmp = f"{_SO}.build.{os.getpid()}"
            proc = subprocess.run(
                ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
                 "-o", tmp, _SRC], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {_SRC} failed:\n{proc.stderr}")
            os.replace(tmp, _SO)
        _lib = _bind(ctypes.CDLL(_SO))
        return _lib


def _bind(lib):
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    ip = ctypes.POINTER(ctypes.c_int)
    lp = ctypes.POINTER(ctypes.c_longlong)
    lib.bgk_training_data.restype = ctypes.c_int
    lib.bgk_training_data.argtypes = [
        f32p, ctypes.c_int, f32p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        f32p, ip, f32p, ip,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.row_tables.restype = ctypes.c_int
    lib.row_tables.argtypes = [
        i32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, i8p, lp,
        i32p, i64p, i32p, lp, i64p,
        ctypes.c_longlong, ctypes.c_longlong,
    ]
    lib.scan_bucket_tables.restype = ctypes.c_int
    lib.scan_bucket_tables.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_double,
        i64p, ctypes.c_int,
        f32p, f32p, ip,
        i64p, i32p, i32p, i32p, ip,
        i64p, i32p, i32p, ip,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.bgkl_training_data.restype = ctypes.c_int
    lib.bgkl_training_data.argtypes = [
        f32p, ctypes.c_int, f32p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        f32p, ip, f32p, ip, f32p, i32p, ip,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.bgkl_scan_tables.restype = ctypes.c_int
    lib.bgkl_scan_tables.argtypes = [
        f32p, ctypes.c_int, f32p, ctypes.c_int,
        f32p, i32p, ctypes.c_int,
        ctypes.c_double, i64p, ctypes.c_int,
        f32p, f32p, ip,
        i64p, i32p, i32p, ip,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.lv_training_data.restype = ctypes.c_int
    lib.lv_training_data.argtypes = [
        f32p, ctypes.c_int, f32p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        f32p, ip, f32p, ip, f32p, i32p, ip,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
    ]
    lib.lv_tile_tables_ray.restype = ctypes.c_int
    lib.lv_tile_tables_ray.argtypes = [
        f32p, ctypes.c_int, f32p, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        i64p, i32p, i32p, i32p, i32p, i32p, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ip, ip, ip,
    ]
    return lib


def bgk_training_data(cloud: np.ndarray, origin: np.ndarray, ds: float, fr: float,
                      max_range: float, free_label: float = 0.0) -> PointTrainingData:
    """Native BGK training-data build (hits + downsampled frees), identical
    to :func:`la3dm_tpu_torch.geometry.preprocess.bgk_training_data`."""
    lib = _load()
    cloud = np.ascontiguousarray(cloud, np.float32)
    origin = np.ascontiguousarray(np.asarray(origin, np.float32).reshape(3))
    n = len(cloud)
    max_h = n + 8
    # frees are downsampled to ds cells — bounded by beam volume; start
    # generous and double on overflow
    max_f = max(4 * n, 1024)
    while True:
        hits = np.empty((max_h, 3), np.float32)
        frees = np.empty((max_f, 3), np.float32)
        nh, nf = ctypes.c_int(), ctypes.c_int()
        rc = lib.bgk_training_data(
            cloud.reshape(-1), n, origin, ds, fr, max_range,
            hits.reshape(-1), ctypes.byref(nh), frees.reshape(-1), ctypes.byref(nf),
            max_h, max_f)
        if rc == 0:
            break
        max_h *= 2
        max_f *= 2
    H, F = nh.value, nf.value
    points = np.concatenate([hits[:H], frees[:F]], axis=0)
    labels = np.concatenate([np.ones(H, np.float32),
                             np.full(F, free_label, np.float32)])
    return PointTrainingData(points=points, labels=labels)


def scan_bucket_tables(points: np.ndarray, labels: np.ndarray,
                       block_size: float, nb_offsets: np.ndarray) -> dict:
    """Fused block bucketing for the point families (see host_preprocess.cpp).

    Returns a dict with the block-sorted entry table and both views of it:
    the model side (one model per entry block: ``model_coords``,
    ``model_starts``, ``model_counts`` and ``nb_t`` [M, G], the test block
    each model serves at each neighbour slot; GP) and the test side
    (``test_coords`` with per-slot ``starts``/``counts`` segments; BGK).
    """
    lib = _load()
    points = np.ascontiguousarray(points, np.float32)
    labels = np.ascontiguousarray(labels, np.float32)
    off = np.ascontiguousarray(np.asarray(nb_offsets, np.int64))
    n, G = len(points), len(off)
    max_ent = 2 * n + 64  # boundary double-membership is rare but systematic
    max_test = 8 * n + 1024  # retry-doubled on overflow
    while True:
        max_models = max_ent
        ent = np.empty((max_ent, 3), np.float32)
        lab = np.empty(max_ent, np.float32)
        mc = np.empty((max_models, 3), np.int64)
        ms = np.empty(max_models, np.int32)
        mn = np.empty(max_models, np.int32)
        nbt = np.empty((max_models, G), np.int32)
        tc = np.empty((max_test, 3), np.int64)
        ts = np.empty((max_test, G), np.int32)
        tn = np.empty((max_test, G), np.int32)
        ne, nm, nt = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = lib.scan_bucket_tables(
            points.reshape(-1), labels, n, float(block_size),
            off.reshape(-1), G,
            ent.reshape(-1), lab, ctypes.byref(ne),
            mc.reshape(-1), ms, mn, nbt.reshape(-1), ctypes.byref(nm),
            tc.reshape(-1), ts.reshape(-1), tn.reshape(-1), ctypes.byref(nt),
            max_ent, max_models, max_test)
        if rc == 0:
            break
        max_ent *= 2
        max_test *= 2
    E, M, B = ne.value, nm.value, nt.value
    return {"entries": ent[:E].copy(), "labels": lab[:E].copy(),
            "model_coords": mc[:M].copy(), "model_starts": ms[:M].copy(),
            "model_counts": mn[:M].copy(), "nb_t": nbt[:M].copy(),
            "test_coords": tc[:B].copy(), "starts": ts[:B].copy(),
            "counts": tn[:B].copy()}


def row_tables(starts: np.ndarray, counts: np.ndarray, W: int):
    """Native fixed-width row tables (models/bgk.py::_row_tables contract).

    Returns (ids [F] i32, gslot [F] i8, row_block [R] i32, row_start [R]
    i64, row_count [R] i32, totals [B] i64).
    """
    lib = _load()
    starts = np.ascontiguousarray(starts, np.int32)
    counts = np.ascontiguousarray(counts, np.int32)
    B, G = counts.shape
    F = int(counts.sum())
    R = int(((counts.sum(axis=1) + W - 1) // W).sum()) if B else 0
    ids = np.empty(max(F, 1), np.int32)
    gslot = np.empty(max(F, 1), np.int8)
    row_block = np.empty(max(R, 1), np.int32)
    row_start = np.empty(max(R, 1), np.int64)
    row_count = np.empty(max(R, 1), np.int32)
    totals = np.empty(max(B, 1), np.int64)
    nf, nr = ctypes.c_longlong(), ctypes.c_longlong()
    rc = lib.row_tables(starts.reshape(-1), counts.reshape(-1), B, G, W,
                        ids, gslot, ctypes.byref(nf),
                        row_block, row_start, row_count, ctypes.byref(nr),
                        totals, len(ids), len(row_block))
    if rc != 0:
        raise RuntimeError(f"row_tables failed (rc={rc})")
    return (ids[:nf.value], gslot[:nf.value], row_block[:nr.value],
            row_start[:nr.value], row_count[:nr.value], totals[:B])


def bgkl_training_data(cloud: np.ndarray, origin: np.ndarray, ds: float, fr: float,
                       max_range: float) -> SegmentTrainingData:
    """Native BGKL training-data build (bgkloctomap.cpp:285-344), identical
    to :func:`la3dm_tpu_torch.geometry.preprocess.bgkl_training_data`: the
    in-range hits recomputed as origin + n·l, their free rays (origin,
    origin + n·(l − fr)) and the rays' proxy samples (the origin, then the
    backward beam samples)."""
    lib = _load()
    cloud = np.ascontiguousarray(cloud, np.float32)
    origin = np.ascontiguousarray(np.asarray(origin, np.float32).reshape(3))
    n = len(cloud)
    max_h = n + 8
    max_s = 64
    while True:
        max_s = max(max_s, int((max(max_range, 1.0) / max(fr, 1e-6) + 2) * max_h))
        hits = np.empty((max_h, 3), np.float32)
        rays = np.empty((max_h, 6), np.float32)
        samples = np.empty((max_s, 3), np.float32)
        sample_ray = np.empty(max_s, np.int32)
        nh, nr, ns = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = lib.bgkl_training_data(
            cloud.reshape(-1), n, origin, ds, fr, max_range,
            hits.reshape(-1), ctypes.byref(nh), rays.reshape(-1), ctypes.byref(nr),
            samples.reshape(-1), sample_ray, ctypes.byref(ns),
            max_h, max_h, max_s)
        if rc == 0:
            break
        max_h *= 2
        max_s *= 2
    return SegmentTrainingData(
        hits=hits[:nh.value].copy(), rays=rays[:nr.value].copy(),
        samples=samples[:ns.value].copy(),
        sample_ray=sample_ray[:ns.value].astype(np.int64))


def bgkl_scan_tables(hits: np.ndarray, rays: np.ndarray, samples: np.ndarray,
                     sample_ray: np.ndarray, block_size: float,
                     nb_offsets: np.ndarray) -> dict:
    """Fused BGKL bucketing (host_preprocess.cpp): hits as degenerate
    segments in their closed-box blocks, each ray once in every block that
    holds one of its proxy samples; per block the hits first, then the rays
    by id.  Returns the block-sorted ``entries`` [E,6] / ``labels`` and the
    test side (``test_coords``, per-slot ``starts`` / ``counts``)."""
    lib = _load()
    hits = np.ascontiguousarray(hits, np.float32)
    rays = np.ascontiguousarray(rays, np.float32)
    samples = np.ascontiguousarray(samples, np.float32)
    sample_ray = np.ascontiguousarray(sample_ray, np.int32)
    off = np.ascontiguousarray(np.asarray(nb_offsets, np.int64))
    H, R, S, G = len(hits), len(rays), len(samples), len(off)
    max_ent = 2 * H + 24 * max(R, 1) + 64  # rays touch many blocks
    max_test = 8 * (H + R) + 1024  # retry-doubled on overflow
    while True:
        ent = np.empty((max_ent, 6), np.float32)
        lab = np.empty(max_ent, np.float32)
        tc = np.empty((max_test, 3), np.int64)
        ts = np.empty((max_test, G), np.int32)
        tn = np.empty((max_test, G), np.int32)
        ne, nt = ctypes.c_int(), ctypes.c_int()
        rc = lib.bgkl_scan_tables(
            hits.reshape(-1), H, rays.reshape(-1), R,
            samples.reshape(-1), sample_ray, S,
            float(block_size), off.reshape(-1), G,
            ent.reshape(-1), lab, ctypes.byref(ne),
            tc.reshape(-1), ts.reshape(-1), tn.reshape(-1), ctypes.byref(nt),
            max_ent, max_test)
        if rc == 0:
            break
        max_ent *= 2
        max_test *= 2
    E, B = ne.value, nt.value
    return {"entries": ent[:E].copy(), "labels": lab[:E].copy(),
            "test_coords": tc[:B].copy(), "starts": ts[:B].copy(),
            "counts": tn[:B].copy()}


def lv_training_data(cloud: np.ndarray, origin: np.ndarray, ds: float, fr: float,
                     max_range: float, ell: float) -> SegmentTrainingData:
    """Native BGKLV training-data build (bgklvoctomap.cpp:303-423): hits,
    shortened free rays, their proxy samples and the hits ∪ samples bbox."""
    lib = _load()
    cloud = np.ascontiguousarray(cloud, np.float32)
    origin = np.ascontiguousarray(np.asarray(origin, np.float32).reshape(3))
    n = len(cloud)
    max_h, max_r = n + 8, n + 8
    max_s = 64
    while True:
        max_s = max(max_s, int((max_range / max(fr, 1e-6) + 2) * max_r))
        hits = np.empty((max_h, 3), np.float32)
        rays = np.empty((max_r, 6), np.float32)
        samples = np.empty((max_s, 3), np.float32)
        sample_ray = np.empty(max_s, np.int32)
        nh, nr, ns = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        bbox = np.empty(6, np.float32)
        rc = lib.lv_training_data(
            cloud.reshape(-1), n, origin, ds, fr, max_range, ell,
            hits.reshape(-1), ctypes.byref(nh), rays.reshape(-1), ctypes.byref(nr),
            samples.reshape(-1), sample_ray, ctypes.byref(ns),
            max_h, max_r, max_s, bbox)
        if rc == 0:
            break
        max_h *= 2
        max_r *= 2
        max_s *= 2
    return SegmentTrainingData(
        hits=hits[:nh.value].copy(), rays=rays[:nr.value].copy(),
        samples=samples[:ns.value].copy(),
        sample_ray=sample_ray[:ns.value].astype(np.int64),
        bbox=bbox.reshape(2, 3).copy() if (nh.value or ns.value) else None)


def lv_tile_tables_ray(hits: np.ndarray, rays: np.ndarray,
                       ts: float, halo: float, shift: float):
    """Per-tile hit/ray tables by a segment event walk (host_preprocess.cpp):
    a slight superset of the proxy-sample candidate set (the row engine
    re-tests exact membership).

    Returns (tile_keys [T] i64, h_start, h_count, r_start, r_count [T] i32,
    hits_flat, rays_flat i32): per active tile, contiguous segments into the
    tile-sorted hit and ray id tables.
    """
    lib = _load()
    hits = np.ascontiguousarray(hits, np.float32)
    rays = np.ascontiguousarray(rays, np.float32)
    H, R = len(hits), len(rays)
    max_t = 64 * max(H + R, 8)
    max_hf = 16 * max(H, 8)
    max_rf = 128 * max(R, 8)
    while True:
        keys = np.empty(max_t, np.int64)
        hs = np.empty(max_t, np.int32)
        hc = np.empty(max_t, np.int32)
        rs = np.empty(max_t, np.int32)
        rc_ = np.empty(max_t, np.int32)
        hf = np.empty(max_hf, np.int32)
        rf = np.empty(max_rf, np.int32)
        nt, nhf, nrf = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = lib.lv_tile_tables_ray(
            hits.reshape(-1), H, rays.reshape(-1), R,
            float(ts), float(halo), float(shift),
            keys, hs, hc, rs, rc_, hf, rf,
            max_t, max_hf, max_rf,
            ctypes.byref(nt), ctypes.byref(nhf), ctypes.byref(nrf))
        if rc == 0:
            break
        max_t *= 2
        max_hf *= 2
        max_rf *= 2
    Ta = nt.value
    return (keys[:Ta].copy(), hs[:Ta].copy(), hc[:Ta].copy(),
            rs[:Ta].copy(), rc_[:Ta].copy(),
            hf[:nhf.value].copy(), rf[:nrf.value].copy())
