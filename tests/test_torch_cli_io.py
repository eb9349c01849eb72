"""The port's own copies of the CLI's file formats against the JAX package's,
on the CPU: the exporters (``viz/markers.py``, ``viz/html.py``,
``io/octomap_bt.py::write_bt_from_map``) write the same bytes from the same
map — one JAX NPZ a family loaded into both packages —, ``leaves()`` and
``search()`` return the same keys in the same order with the same dtypes,
the ``.bt`` reader, writer and voxel expansion agree, and the bag reader
(``io/rosbag.py``) replays a bag written by ``chip_smoke.py::write_bag``
(one uncompressed and one bz2 chunk) exactly as the JAX one does; the
``bag`` command's map matches the JAX CLI's at BGK's limit.
"""

import time

import numpy as np
import pytest

from la3dm_tpu import pipeline as jpipe
from la3dm_tpu.io import octomap_bt as jbt, rosbag as jbag
from la3dm_tpu.utils.config import load_method_config as jload_method_config
from la3dm_tpu.viz import html as jhtml, markers as jmarkers

from la3dm_tpu_torch import pipeline
from la3dm_tpu_torch.io import octomap_bt, rosbag
from la3dm_tpu_torch.utils.config import load_method_config
from la3dm_tpu_torch.viz import html, markers

from chip_smoke import write_bag
from tests.test_bgk_vs_oracle import compare_maps
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_cli_cases import LIMITS, METHODS, JaxMapAsOracle, jax_checkpoints, run_both


@pytest.fixture(scope="module")
def jax_npz(tmp_path_factory):
    return jax_checkpoints(tmp_path_factory.mktemp("scene"))


def _both(method, path):
    """(the port's map, the JAX map), each loaded from ``path``."""
    ours = pipeline.build_map(load_method_config(method), "cpu")
    ours.load(path)
    ref = jpipe.build_map(jload_method_config(method))
    ref.load(path)
    return ours, ref


@pytest.mark.parametrize("method", METHODS)
def test_leaves_and_search_keep_jax_keys_and_dtypes(jax_npz, method):
    ours, ref = _both(method, jax_npz[method])
    for expand in (True, False):
        a, b = ours.leaves(expand_pruned=expand), ref.leaves(expand_pruned=expand)
        assert list(a) == list(b)
        assert [a[k].dtype for k in a] == [np.asarray(b[k]).dtype for k in b]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    pts = np.random.default_rng(3).uniform(-0.5, 2.0, (300, 3)).astype(np.float32)
    a, b = ours.search(pts), ref.search(pts)
    assert list(a) == list(b)
    assert [a[k].dtype for k in a] == [np.asarray(b[k]).dtype for k in b]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("method", METHODS)
def test_exporters_write_the_same_bytes(jax_npz, method, tmp_path, monkeypatch):
    ours, ref = _both(method, jax_npz[method])
    cfg = ours.cfg
    ex = pipeline.export_leaves(ours, occupied_z_max=2.0 if method == "bgklv" else None)
    jex = jpipe.export_leaves(ref, occupied_z_max=2.0 if method == "bgklv" else None)
    assert len(ex["occupied"]["x"]) > 10 and len(ex["free"]["x"]) > 10
    files = []
    for name, mod, hmod, bt, e, m in (("t", markers, html, octomap_bt, ex, ours),
                                      ("j", jmarkers, jhtml, jbt, jex, ref)):
        p = str(tmp_path / name)
        n = (mod.export_ply(p + "_occ.ply", e["occupied"], "occupied", cfg.resolution,
                            -0.5, 0.5),
             mod.export_ply(p + "_free.ply", e["free"], "free", cfg.resolution, -0.5, 0.5),
             mod.export_csv(p + ".csv", e["occupied"]),
             hmod.export_html(p + ".html", e["all"], cfg.resolution, title=f"{method} / tiny"))
        # export_npz's zip entries carry the time of day: hold it still
        with monkeypatch.context() as mp:
            mp.setattr(time, "time", lambda: 1.7e9)
            mod.export_npz(p + ".npz", e["all"])
        bt.write_bt_from_map(p + ".bt", m)
        groups = mod.marker_groups(e["occupied"], cfg.resolution, -0.5, 0.5)
        files.append((p, n, groups))
    (p, n, g), (jp, jn, jg) = files
    assert n == jn
    for suffix in ("_occ.ply", "_free.ply", ".csv", ".html", ".npz", ".bt"):
        assert _read(p + suffix) == _read(jp + suffix), suffix
    assert list(g) == list(jg)
    for d in g:
        assert g[d]["size"] == jg[d]["size"]
        np.testing.assert_array_equal(g[d]["positions"], jg[d]["positions"])
        np.testing.assert_array_equal(g[d]["prob"], jg[d]["prob"])


def _leaf_set(seed=5, res=0.1):
    """Base voxels of a 6 × 6 × 4 patch, labels at random, and two coarse
    leaves (0.2 m and 0.4 m) beside it, all on the octomap grid."""
    rng = np.random.default_rng(seed)
    ix = np.stack(np.meshgrid(np.arange(6), np.arange(-3, 3), np.arange(4), indexing="ij"),
                  -1).reshape(-1, 3)
    centers = (ix + 0.5) * res
    sizes = np.full(len(centers), res)
    coarse = np.array([[1.1, 0.1, 0.1], [1.4, 0.2, 0.6]])   # 0.2 m, 0.4 m cells
    centers = np.concatenate([centers, coarse])
    sizes = np.concatenate([sizes, [0.2, 0.4]])
    occ = rng.random(len(centers)) < 0.3
    return centers, sizes, occ


def test_bt_writer_reader_and_expansion_match_jax(tmp_path):
    centers, sizes, occ = _leaf_set()
    p, jp = str(tmp_path / "t.bt"), str(tmp_path / "j.bt")
    octomap_bt.write_bt(p, centers, sizes, occ, 0.1)
    jbt.write_bt(jp, centers, sizes, occ, 0.1)
    assert _read(p) == _read(jp)
    bt, jb = octomap_bt.read_bt(p), jbt.read_bt(jp)
    assert list(bt) == list(jb)
    for k in ("centers", "sizes", "occupied"):
        np.testing.assert_array_equal(bt[k], jb[k])
    assert (bt["resolution"], bt["size"]) == (jb["resolution"], jb["size"])
    # the reader returns the leaves the writer took, in its depth-first order
    order = np.lexsort(bt["centers"].T)
    np.testing.assert_allclose(bt["centers"][order], centers[np.lexsort(centers.T)],
                               atol=1e-9)
    assert bt["occupied"].sum() == occ.sum()
    ex, jex = octomap_bt.expand_to_voxels(bt), jbt.expand_to_voxels(jb)
    for k in ("centers", "occupied"):
        np.testing.assert_array_equal(ex[k], jex[k])
    assert len(ex["centers"]) == len(centers) - 2 + 8 + 64


def _random_tree(seed, res=0.1, n_roots=6, levels=4):
    """Leaves of random octree branches: cells of 3.2 m at random places,
    each child dropped (a fifth), a leaf (about a third) or split again,
    down to ``levels`` below the cell; labels at random."""
    rng = np.random.default_rng(seed)
    centers, sizes = [], []

    def grow(c, size, left):
        for i in range(8):
            cc = c + (np.array([i & 1, (i >> 1) & 1, (i >> 2) & 1]) * 2 - 1) * size / 4
            r = rng.random()
            if r < 0.2:
                continue
            if left == 0 or r < 0.5:
                centers.append(cc)
                sizes.append(size / 2)
            else:
                grow(cc, size / 2, left - 1)

    cells = rng.choice(1000, n_roots, replace=False)
    for k in np.stack([cells % 10, cells // 10 % 10, cells // 100], -1) - 5:
        grow((k + 0.5) * res * 2 ** (levels + 1), res * 2 ** (levels + 1), levels)
    return np.array(centers), np.array(sizes), rng.random(len(centers)) < 0.4


@pytest.mark.parametrize("seed", range(4))
def test_bt_writer_matches_jax_on_random_trees(tmp_path, seed):
    """The port's vectorised writer against the JAX package's node-by-node
    one: the same bytes for leaves of every size from 0.1 to 1.6 m, in an
    order unrelated to the tree's."""
    centers, sizes, occ = _random_tree(seed)
    order = np.random.default_rng(seed).permutation(len(centers))
    args = (centers[order], sizes[order], occ[order], 0.1)
    octomap_bt.write_bt(str(tmp_path / "t.bt"), *args)
    jbt.write_bt(str(tmp_path / "j.bt"), *args)
    assert _read(str(tmp_path / "t.bt")) == _read(str(tmp_path / "j.bt"))
    assert len(np.unique(sizes)) >= 4


def test_bt_writer_of_no_leaves_matches_jax(tmp_path):
    none = (np.zeros((0, 3)), np.zeros(0), np.zeros(0, bool), 0.1)
    octomap_bt.write_bt(str(tmp_path / "t.bt"), *none)
    jbt.write_bt(str(tmp_path / "j.bt"), *none)
    assert _read(str(tmp_path / "t.bt")) == _read(str(tmp_path / "j.bt"))
    assert octomap_bt.read_bt(str(tmp_path / "t.bt"))["size"] == 1


@pytest.mark.parametrize("case", ["inside", "twice", "above"])
def test_bt_writer_rejects_overlapping_leaves_as_jax_does(tmp_path, case):
    centers, sizes = {
        "inside": ([[0.05, 0.05, 0.05], [0.1, 0.1, 0.1]], [0.1, 0.2]),   # 0.1 m in 0.2 m
        "twice": ([[0.05, 0.05, 0.05], [0.05, 0.05, 0.05]], [0.1, 0.1]),
        "above": ([[0.1, 0.1, 0.1], [0.05, 0.05, 0.05]], [0.2, 0.1]),    # 0.2 m first
    }[case]
    for mod in (octomap_bt, jbt):
        with pytest.raises(ValueError, match="leaf"):
            mod.write_bt(str(tmp_path / "x.bt"), np.array(centers), np.array(sizes),
                         np.array([True, False]), 0.1)


def test_read_bt_rejects_color_octree(tmp_path):
    p = tmp_path / "c.bt"
    p.write_bytes(b"# Octomap OcTree binary file\nid ColorOcTree\n"
                  b"size 1\nres 0.1\ndata\n\x00\x00")
    with pytest.raises(ValueError, match="ColorOcTree"):
        octomap_bt.read_bt(str(p))


def _bag_scans(n=5, seed=11):
    """Walls in front of a sensor moving 0.2 m a scan along y, the fourth
    scan at the third's pose (gated out by the server's motion gate), a NaN
    point in the second cloud (dropped by the reader)."""
    rng = np.random.default_rng(seed)
    scans = []
    for i in range(n):
        origin = np.array([0.0, 0.2 * min(i, 2) + 0.2 * max(i - 3, 0), 0.0], np.float32)
        yz = rng.uniform(-0.3, 0.3, size=(120, 2)).astype(np.float32)
        wall = np.column_stack([np.full(len(yz), 1.5, np.float32), yz]) + origin
        scans.append((wall.astype(np.float32), origin))
    scans[1][0][7] = np.nan
    return scans


@pytest.mark.parametrize("with_orientation", [False, True])
def test_bag_replay_matches_jax(tmp_path, with_orientation):
    scans = _bag_scans()
    path = str(tmp_path / "scans.bag")
    write_bag(path, scans, per_chunk=3)          # one plain chunk, one bz2
    raw = _read(path)
    assert b"compression=bz2" in raw and b"compression=none" in raw
    ours = list(rosbag.replay(path, with_orientation=with_orientation))
    ref = list(jbag.replay(path, with_orientation=with_orientation))
    assert len(ours) == len(ref) == len(scans)
    for a, b, (cloud, origin) in zip(ours, ref, scans):
        assert len(a) == len(b) == (3 if with_orientation else 2)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[0], cloud[np.isfinite(cloud).all(axis=1)])
        np.testing.assert_array_equal(a[1], origin)
    assert len(ours[1][0]) == 119
    msgs = list(rosbag.read_messages(path))
    assert [m[:2] for m in msgs] == [m[:2] for m in jbag.read_messages(path)]
    assert [m[0] for m in msgs[:2]] == ["/robot_pose", "/selected_pc2_map"]


def test_bag_command_matches_jax(tmp_path):
    path = str(tmp_path / "scans.bag")
    write_bag(path, _bag_scans(), per_chunk=3)
    (jrc, jout, jpre), (rc, out, pre) = run_both(
        ["bag", "--method", "bgk", "--bag", path, "--out", "bag", "--set", "max_range=8.0"],
        tmp_path)
    assert jrc == rc == 0
    summary = [ln for ln in out.splitlines() if "clouds integrated" in ln]
    jsummary = [ln for ln in jout.splitlines() if "clouds integrated" in ln]
    assert summary[0].startswith("4 clouds integrated (1 gated)")
    assert summary[0].split(" in ")[0] == jsummary[0].split(" in ")[0]
    assert summary[0].split("; ")[1] == jsummary[0].split("; ")[1]
    ours = pipeline.build_map(load_method_config("bgk", max_range=8.0), "cpu")
    ours.load(pre + "_map.npz")
    ref = jpipe.build_map(jload_method_config("bgk", max_range=8.0))
    ref.load(jpre + "_map.npz")
    n, _ = compare_maps(ours, JaxMapAsOracle(ref), **LIMITS["bgk"])
    assert n > 500
    for suffix in ("_occupied.ply", "_map.bt"):
        assert _read(pre + suffix) == _read(jpre + suffix), suffix
