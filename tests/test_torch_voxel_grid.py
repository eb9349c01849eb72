"""K7v, the server's pre-downsample on the card, on the CPU: its plain
version (``kernels/ingest_voxel_grid.py``) against the JAX package's
``voxel_downsample`` bit for bit (the float32 words compared as uint32),
and ``OnlineIntegrator``'s choice between the two paths.

A CPU map never takes the card's path; here the map's ``_ingests_on_card``
is patched to say it does, so that the path runs through K7v's plain
version and hands ``insert_pointcloud`` a tensor, which device ingest
(``device_ingest: on``, its plain versions) takes without the upload.  The
counters ``server_ds_card`` and ``server_ds_host`` (``utils/profiling.py``)
count while a profiler session records.  No JAX here: the reference's file
is loaded alone (``torch_cases.jax_voxel_downsample``), so that the card's
tests can share these cases.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from la3dm_tpu_torch import pipeline
from la3dm_tpu_torch.kernels import ingest_voxel_grid as vg
from la3dm_tpu_torch.models import bgk, bgkl, gp
from la3dm_tpu_torch.utils import profiling
from la3dm_tpu_torch.utils.config import MapConfig

from test_torch_ingest_slots import assert_same_pool, room_scans
from torch_cases import (jax_voxel_downsample, keyable, one_torch_thread,  # noqa: F401
                         sum_order_cells, vlp16_cloud)

CLASSES = {"bgk": bgk.BGKOctoMap, "bgkl": bgkl.BGKLOctoMap, "gp": gp.GPOctoMap}


def _cfg(method, ds=0.2, device_ingest="on"):
    return MapConfig(method=method, resolution=0.1, block_depth=3, sf2=1.0, ell=0.2,
                     free_resolution=0.5, ds_resolution=ds, free_thresh=0.3,
                     occupied_thresh=0.7, var_thresh=100.0, prior_A=0.001, prior_B=0.001,
                     max_range=6.0, device_ingest=device_ingest)


def _bits(x) -> np.ndarray:
    x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    assert x.dtype == np.float32
    return x.view(np.uint32)


def _counted(fn) -> dict:
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset()
        fn()
        return profiling.snapshot()["counts"]


def _faces():
    """Points on cell faces at 0.5 and 0.1 (multiples of the leaf, and
    one float32 ulp either side), at negative coordinates, and -0.0s."""
    g = (np.arange(-12, 12) * 0.5).astype(np.float32)
    p = np.stack(np.meshgrid(g, g[::3], g[::4], indexing="ij"), -1).reshape(-1, 3)
    p = np.concatenate([p, np.nextafter(p, np.float32(np.inf)),
                        np.nextafter(p, np.float32(-np.inf)), -p,
                        (np.arange(-30, 30)[:, None] * np.float32(0.1)).repeat(3, 1),
                        np.full((4, 3), -0.0, np.float32)])
    return p.astype(np.float32), np.zeros(3, np.float32)


def _case(name):
    """(cloud, origin, leaf)."""
    cloud, origin = vlp16_cloud(1)
    if name == "empty":
        return np.zeros((0, 3), np.float32), origin, 0.5
    if name == "passthrough":
        return cloud, origin, -1.0
    if name == "one_cell_1024":
        return sum_order_cells((1024,)), np.zeros(3, np.float32), 0.5
    if name == "sum_order_cells":
        return sum_order_cells(), np.zeros(3, np.float32), 0.5
    if name in ("faces_leaf05", "faces_leaf01"):
        return (*_faces(), 0.5 if name == "faces_leaf05" else 0.1)
    if name == "vlp16_leaf05":
        return cloud, origin, 0.5
    if name == "vlp16_leaf01":   # within the window's 51.2 m at 0.1 m
        return (*vlp16_cloud(2, r_max=45.0), 0.1)
    if name == "vlp16_leaf01_past_window":  # 60 m beams pass 51.2 m
        return cloud, origin, 0.1
    if name == "outside_window":
        far = cloud.copy()
        far[1234] = origin + np.float32([0.0, 300.0, 0.0])   # 256 m is the edge at 0.5
        return far, origin, 0.5
    if name in ("nan", "inf"):
        bad = cloud.copy()
        bad[77, 1] = np.nan if name == "nan" else np.inf
        bad[78] = np.nan
        return bad, origin, 0.5
    raise KeyError(name)


CASES = ["empty", "passthrough", "one_cell_1024", "sum_order_cells", "faces_leaf05",
         "faces_leaf01", "vlp16_leaf05", "vlp16_leaf01", "vlp16_leaf01_past_window",
         "outside_window", "nan", "inf"]

#: the cases with points K7v leaves out: past its window, or not finite
DROPS = {"vlp16_leaf01_past_window", "outside_window", "nan", "inf"}


def reference(name):
    """(cloud, origin, leaf, K7v's expected centroids): the JAX package's
    voxel grid of the points K7v keys; the cells of the others are left
    out whole, so this is its grid of the whole cloud less those cells."""
    cloud, origin, leaf = _case(name)
    if leaf < 0:
        return cloud, origin, leaf, cloud
    keep = keyable(cloud, origin, leaf)
    assert (not keep.all()) == (name in DROPS)
    return cloud, origin, leaf, jax_voxel_downsample(cloud[keep], leaf)


@pytest.mark.parametrize("name", CASES)
def test_k7v_equals_voxel_downsample_bit_for_bit(name, monkeypatch):
    """K7v's plain version gives the JAX package's float32 words, less the
    cells of points past the window or not finite; the server's card path
    hands ``insert_pointcloud`` those words as a tensor and counts it."""
    cloud, origin, leaf, ref = reference(name)
    got = vg.voxel_grid_plain(torch.from_numpy(cloud), leaf, origin)
    assert got.shape == ref.shape and np.array_equal(_bits(got), _bits(ref))
    if name not in DROPS:
        with np.errstate(invalid="ignore"):
            assert np.array_equal(_bits(ref), _bits(jax_voxel_downsample(cloud, leaf)))

    m = bgk.BGKOctoMap(_cfg("bgk", ds=leaf), device="cpu")
    fed = []
    monkeypatch.setattr(m, "insert_pointcloud", lambda c, o: fed.append(c))
    monkeypatch.setattr(m, "_ingests_on_card", lambda: True)
    online = pipeline.OnlineIntegrator(m)
    counts = _counted(lambda: online.offer(cloud, origin))
    (c,) = fed
    assert torch.is_tensor(c)
    assert c.shape == ref.shape and np.array_equal(_bits(c), _bits(ref))
    assert counts.get("server_ds_card") == 1 and "server_ds_host" not in counts


def test_an_origin_without_a_cell_leaves_no_cell():
    """An origin that is not finite has no cell, so no cell lies in the
    window round it: K7v gives no centroid (device ingest drops every point
    of such a scan by range)."""
    cloud, _ = vlp16_cloud(3)
    for origin in ([np.nan, 0.0, 0.0], [0.0, np.inf, 0.0]):
        got = vg.voxel_grid(torch.from_numpy(cloud), 0.5, np.float32(origin))
        assert got.shape == (0, 3) and got.dtype == torch.float32


def test_sum_order_cells_need_numpys_sum_order():
    """The cells of ``sum_order_cells`` tell numpy's sum order apart: a
    running float64 sum from each cell's first point gives other float32
    words in every cell of 4, 64 and 1024 points, and a pairwise sum that
    starts from +0.0 loses the -0.0s."""
    p = sum_order_cells()
    ref = jax_voxel_downsample(p, 0.5)
    ijk = np.floor(p * np.float32(2.0)).astype(np.int64)
    order = np.lexsort((ijk[:, 0], ijk[:, 1], ijk[:, 2]))
    srt, key = p[order].astype(np.float64), ijk[order]
    cut = np.concatenate([[0], np.nonzero(np.any(key[1:] != key[:-1], 1))[0] + 1, [len(p)]])
    running = []
    for a, b in zip(cut[:-1], cut[1:]):
        s = srt[a].copy()
        for i in range(a + 1, b):
            s = s + srt[i]
        running.append(s / (b - a))
    running = np.asarray(running).astype(np.float32)
    sizes = np.diff(cut)
    differs = (_bits(running) != _bits(ref)).any(1)
    assert sorted(sizes[differs].tolist()) == [4, 64, 1024]
    (z,) = np.nonzero(sizes == 3)[0]
    assert np.signbit(ref[z, 1:]).all()
    a = cut[z]
    plus = srt[a] + ((0.0 + srt[a + 1]) + srt[a + 2])    # the rest's sum from +0.0
    assert not np.signbit(plus[1:]).any()


@pytest.mark.parametrize("lengths", [range(1, 40), [63, 64, 65, 127, 128, 129, 130, 135],
                                     [255, 256, 257, 1000, 1031, 4100]])
def test_pairwise_sum_plain_equals_reduceat(lengths):
    """``pairwise_sum_plain`` adds in numpy's order: the first value plus it
    equals ``np.add.reduceat`` in float64, on values spread over 40 binades
    (so that the order shows) with signed zeros among them."""
    rng = np.random.default_rng(sum(lengths))
    for n in lengths:
        v = (rng.random((n, 3)) ** 40 * rng.choice([-1.0, 1.0], (n, 3))).astype(np.float32)
        v[rng.random((n, 3)) < 0.1] = -0.0
        x = v.astype(np.float64)
        ref = np.add.reduceat(x, [0], axis=0)[0]
        t = torch.from_numpy(x)[None]
        got = (t[:, 0] + vg.pairwise_sum_plain(t[:, 1:]))[0].numpy()
        assert np.array_equal(got.view(np.uint64), ref.view(np.uint64)), n


def _online(m, scans, card: bool, monkeypatch) -> dict:
    if card:
        monkeypatch.setattr(m, "_ingests_on_card", lambda: True)
    online = pipeline.OnlineIntegrator(m)
    counts = _counted(lambda: [online.offer(c, o) for c, o in scans])
    assert online.n_integrated == len(scans)
    return counts


def _scans(seed=4, k=3, n=600, dirty=False):
    """``k`` room scans; ``dirty``: each with NaNs, an inf, and points past
    K7v's window (102.4 m at the 0.2 m leaf) and past the map's range."""
    scans = room_scans(seed, [(0.1, -0.2 + 0.3 * i, 0.3) for i in range(k)], n=n)
    if dirty:
        for c, o in scans:
            c[5] = np.nan
            c[6, 2] = np.nan
            c[7, 0] = -np.inf
            c[8:11] = o + np.float32([[150.0, 0.0, 0.0], [0.0, -400.0, 1.0], [30.0, 30.0, 0.0]])
    return scans


@pytest.mark.parametrize("dirty", [False, True], ids=["clean", "dirty"])
@pytest.mark.parametrize("method", ["bgk", "bgkl", "gp"])
def test_card_path_gives_the_numpy_paths_map(method, dirty, monkeypatch):
    """Device ingest fed K7v's centroids as tensors (the concatenation and
    upload skipped) builds the map that the JAX package's centroids build,
    pool for pool, also where the clouds hold points that are not finite or
    lie past K7v's window (their cells left out, which device ingest drops
    by range); each scan took the path its counter says."""
    scans = _scans(dirty=dirty)
    card = CLASSES[method](_cfg(method), device="cpu")
    host = CLASSES[method](_cfg(method), device="cpu")
    counts = _online(card, scans, True, monkeypatch)
    assert (counts.get("server_ds_card"), counts.get("server_ds_host")) == (3, None)
    with np.errstate(invalid="ignore"):
        for c, o in scans:
            host.insert_pointcloud(jax_voxel_downsample(c, host.cfg.ds_resolution), o)
    assert card.stats["ingest_host_chunks"] == host.stats["ingest_host_chunks"] == 0
    assert card.pool.n_blocks > 0
    assert_same_pool(card, host)


@pytest.mark.parametrize("device_ingest", ["auto", "on"])
def test_cpu_map_keeps_numpys_downsample(device_ingest):
    """A CPU map takes numpy's voxel grid, on the host path (``auto`` on a
    CPU map) and on device ingest: the map equals one fed the JAX package's
    centroids by hand."""
    scans = _scans(seed=9, n=200)
    m = bgk.BGKOctoMap(_cfg("bgk", device_ingest=device_ingest), device="cpu")
    ref = bgk.BGKOctoMap(_cfg("bgk", device_ingest=device_ingest), device="cpu")
    assert not m._ingests_on_card()
    online = pipeline.OnlineIntegrator(m)
    counts = _counted(lambda: [online.offer(c, o) for c, o in scans])
    assert counts.get("server_ds_host") == 3 and "server_ds_card" not in counts
    for c, o in scans:
        ref.insert_pointcloud(jax_voxel_downsample(c, ref.cfg.ds_resolution), o)
    assert_same_pool(m, ref)
