"""The PyTorch port's BGKLV slice against the JAX package and the oracle, on
the CPU.

Scans come from the same numpy seed for both packages: the small walls of
tests/test_bgk_vs_oracle.py under ``LV_CFG`` of
tests/test_families_vs_oracle.py (block_depth 3).  Against the oracle the
tolerances are that file's (atol 3e-3 for one scan, 5e-3 for two, touched
compared where the mass exceeds 5e-3: the closed-form cube membership can
flip a sample on a cube face).  Against the JAX map the comparison is voxel
by voxel and much tighter: A/B within 1e-5 + 1e-5·|JAX|, state and touched
equal wherever the voxel's added mass exceeds 1e-5 (the k̄ > 0.001 gate and
the membership decide voxels below that in the last ulp).

JAX's row engine compiles once per padded shape; the pads of every config
used here are seeded large enough for all its scans, so each config costs
one compile for single-scan and one for multi-scan dispatches.
"""

import dataclasses

import numpy as np
import pytest
import torch

from la3dm_tpu import pipeline as jpipe
from la3dm_tpu.geometry import native as jnative
from la3dm_tpu.models import bgklv as jlv
from la3dm_tpu.utils.config import DatasetConfig as JDatasetConfig
from la3dm_tpu.utils.config import load_method_config as jload_method_config

from la3dm_tpu_torch import pipeline
from la3dm_tpu_torch.geometry import native
from la3dm_tpu_torch.io.pcd import save_pcd
from la3dm_tpu_torch.kernels import lv_prune, lv_rows
from la3dm_tpu_torch.models import bgklv, posterior
from la3dm_tpu_torch.utils.config import DatasetConfig, MapConfig, load_method_config

from tests.oracle.oracle_maps import OracleBGKLV
from tests.test_bgk_vs_oracle import compare_maps, synthetic_scan
from tests.test_families_vs_oracle import LV_CFG
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

TCFG = MapConfig(**dataclasses.asdict(LV_CFG))
MASS_TOL = 1e-5
#: depth-5 original_size config: few points, short range (the prune path)
PRUNE_CFG = dataclasses.replace(LV_CFG, block_depth=5, original_size=True,
                                max_range=3.0, var_thresh=0.001, min_W=0.01)
#: pads of the JAX row engine: one shape per (config, single/multi scan)
_PADS = {"E": 8192, "F": 65536, "R": 2048, "T": 2048}


def _seed_jax_pads(cfg):
    for single in (True, False):
        jlv._GLOBAL_PADS.setdefault(("BGKLVOctoMap", cfg, single), dict(_PADS))


for _cfg in (LV_CFG, PRUNE_CFG):
    _seed_jax_pads(_cfg)


def _scans(seed, k, n=60):
    rng = np.random.default_rng(seed)
    return [synthetic_scan(rng, n=n, origin=(0.1, -0.2 + 0.3 * i, 0.3))
            for i in range(k)]


def _port(cfg=TCFG):
    return bgklv.BGKLVOctoMap(cfg, device="cpu")


def _jax(cfg=LV_CFG):
    return jlv.BGKLVOctoMap(cfg)


def _pool(m):
    """(coords, {A, B}, touched, eff) of a map of either package, raster order."""
    nb = m.pool.n_blocks
    rows = np.arange(nb)
    fields = {k: np.asarray(m._gather_rows(v, rows)) for k, v in m.pool.fields.items()}
    return (m.pool.coords[:nb], fields, np.asarray(m._gather_rows(m.pool.touched, rows)),
            np.asarray(m._gather_rows(m.pool.eff_level, rows)))


def assert_matches_jax(ours, ref, min_away=100):
    """Voxel by voxel: same blocks in the same slots, A/B within
    1e-5 + 1e-5·|JAX|, eff equal, and state and touched equal wherever the
    added mass exceeds 1e-5.  Returns the number of touched voxels at or
    below that mass (the gate boundary)."""
    c1, f1, t1, e1 = _pool(ours)
    c2, f2, t2, e2 = _pool(ref)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(e1, e2)
    mass = np.zeros(t1.shape, np.float32)
    for k, p in (("A", LV_CFG.prior_A), ("B", LV_CFG.prior_B)):
        np.testing.assert_allclose(f1[k], f2[k], atol=1e-5, rtol=1e-5, err_msg=k)
        mass = np.maximum(mass, np.maximum(np.abs(f1[k] - p), np.abs(f2[k] - p)))
    away = mass > MASS_TOL
    assert away.sum() > min_away
    np.testing.assert_array_equal(t1[away], t2[away])
    s1 = ours._posterior({**f1, "touched": t1})["state"]
    s2 = ref._posterior({**f2, "touched": t2})["state"]
    np.testing.assert_array_equal(s1[away], s2[away])
    return int(((t1 | t2) & ~away).sum())


# ------------------------------------------------------------ host tables

def test_training_data_and_tables_match_jax():
    """The port's native bindings build the JAX package's training data,
    tile tables and (scan, tile) rows bit for bit."""
    cloud, origin = _scans(30, 1, n=80)[0]
    args = (cloud, origin, 0.1, 0.1, 8.0, 0.2)
    td, jtd = native.lv_training_data(*args), jnative.lv_training_data(*args)
    for k in ("hits", "rays", "samples", "sample_ray", "bbox"):
        np.testing.assert_array_equal(getattr(td, k), getattr(jtd, k), err_msg=k)
    ours, jm = _port(), _jax()
    for a, b in zip(ours._scan_tables(td), jm._scan_tables(jtd)):
        np.testing.assert_array_equal(a, b)
    r, jr = ours._scan_rows(td), jm._scan_rows(jtd)
    for k in ("slots", "pos_id", "centers", "mcount", "ids"):
        np.testing.assert_array_equal(r[k], jr[k], err_msg=k)
    np.testing.assert_array_equal(ours.pool.coords[:ours.pool.n_blocks],
                                  jm.pool.coords[:jm.pool.n_blocks])


# ---------------------------------------------------------- the whole slice

def test_single_scan_vs_oracle_and_jax():
    cloud, origin = _scans(31, 1)[0]
    ours, jm = _port(), _jax()
    ours.insert_pointcloud(cloud, origin)
    jm.insert_pointcloud(cloud, origin)
    om = OracleBGKLV(LV_CFG)
    om.insert_pointcloud(cloud, origin, LV_CFG.ds_resolution, LV_CFG.free_resolution,
                         LV_CFG.max_range)
    n, _ = compare_maps(ours, om, atol=3e-3, touched_mass_tol=5e-3)
    assert n > 300
    boundary = assert_matches_jax(ours, jm)
    print(f"single scan: {boundary} touched voxels at mass <= {MASS_TOL}")


def test_two_scans_vs_oracle_and_jax():
    ours, jm, om = _port(), _jax(), OracleBGKLV(LV_CFG)
    for cloud, origin in _scans(32, 2, n=40):
        ours.insert_pointcloud(cloud, origin)
        jm.insert_pointcloud(cloud, origin)
        om.insert_pointcloud(cloud, origin, LV_CFG.ds_resolution,
                             LV_CFG.free_resolution, LV_CFG.max_range)
    compare_maps(ours, om, atol=5e-3, touched_mass_tol=5e-3)
    boundary = assert_matches_jax(ours, jm)
    print(f"two scans: {boundary} touched voxels at mass <= {MASS_TOL}")


def test_large_map_depth6_matches_depth3():
    """tests/test_families_vs_oracle.py::test_bgklv_large_map_depth6 in the
    port: LV inference is per base voxel, so where both sweeps reach, a
    depth-6 map (V = 32³, 4³ tiles per block) equals a depth-3 map."""
    cfg6 = load_method_config("bgklvoctomap_large_map", max_range=1.5,
                              original_size=False)
    assert cfg6.block_depth == 6 and cfg6.voxels_per_block == 32768
    cfg3 = dataclasses.replace(cfg6, block_depth=3)
    rng = np.random.default_rng(7)
    n = 15
    cloud = np.stack([0.8 + 0.03 * rng.standard_normal(n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(0.0, 0.6, n)], -1).astype(np.float32)
    origin = np.zeros(3, np.float32)
    m6, m3 = _port(cfg6), _port(cfg3)
    assert m6.pool.capacity * m6.pool.V <= (1 << 23)
    m6.insert_pointcloud(cloud, origin)
    m3.insert_pointcloud(cloud, origin)
    leaves = m6.leaves()
    touched = leaves["state"] != posterior.UNKNOWN
    assert touched.sum() > 200
    pts = np.stack([leaves[a][touched] for a in "xyz"], -1).astype(np.float32)
    got = {k: leaves[k][touched] for k in ("prob", "var", "A", "B")}
    want = m3.search(pts)
    common = want["touched"]
    assert common.sum() > 0.9 * len(pts)
    for k in ("prob", "var", "A", "B"):
        np.testing.assert_allclose(got[k][common], want[k][common],
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_original_size_prune_matches_jax():
    """block_depth 5 with original_size: every scan integrated, then its
    blocks pruned on the tile-major pool; eff equal everywhere."""
    ours, jm = _port(MapConfig(**dataclasses.asdict(PRUNE_CFG))), _jax(PRUNE_CFG)
    rng = np.random.default_rng(33)
    for i in range(2):
        cloud = np.stack([2.0 + 0.02 * rng.standard_normal(60), rng.uniform(-1.0, 1.0, 60),
                          rng.uniform(0.0, 1.0, 60)], -1).astype(np.float32)
        origin = np.array([0.0, 0.1 * i, 0.2], np.float32)
        ours.insert_pointcloud(cloud, origin)
        jm.insert_pointcloud(cloud, origin)
    assert_matches_jax(ours, jm)
    eff = _pool(ours)[3]
    assert (eff > 0).sum() > 500 and eff.max() >= 2


# ------------------------------------------------------------ batching

def test_insert_pointclouds_equals_sequential_inserts():
    scans = _scans(34, 3, n=40)
    seq, batch = _port(), _port()
    for cloud, origin in scans:
        seq.insert_pointcloud(cloud, origin)
    batch.insert_pointclouds([c for c, _ in scans], [o for _, o in scans])
    assert seq.stats["scans"] == batch.stats["scans"] == 3
    assert seq.stats["kernel_evals"] == batch.stats["kernel_evals"]
    c1, f1, t1, e1 = _pool(seq)
    c2, f2, t2, e2 = _pool(batch)
    np.testing.assert_array_equal(c1, c2)
    for k in f1:
        np.testing.assert_allclose(f1[k], f2[k], atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(e1, e2)


def test_scan_batches_are_chunked(monkeypatch):
    calls = []
    orig = lv_rows.lv_rows
    monkeypatch.setattr(lv_rows, "lv_rows",
                        lambda *a, **k: (calls.append(len(a[5])), orig(*a, **k)))
    monkeypatch.setattr(bgklv, "_SCAN_BATCH", 2)
    m = _port()
    scans = _scans(35, 5, n=20)
    m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans])
    assert len(calls) == 3 and m.stats["scans"] == 5


def test_original_size_integrates_and_prunes_scan_by_scan(monkeypatch):
    steps, prunes = [], []
    monkeypatch.setattr(lv_rows, "lv_rows", lambda *a, **k: steps.append(1))
    monkeypatch.setattr(lv_prune, "lv_prune", lambda *a, **k: prunes.append(len(a[4])))
    m = _port(MapConfig(**dataclasses.asdict(PRUNE_CFG)))
    scans = _scans(36, 3, n=20)
    m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans])
    assert len(steps) == len(prunes) == 3 and min(prunes) > 0


# ------------------------------------------------- queries and the hooks

def test_stored_order_hooks_round_trip():
    m = _port(load_method_config("bgklv", max_range=8.0))
    rows = np.arange(2 * m.V).reshape(2, m.V)
    assert np.array_equal(m._stored_to_raster(m._raster_to_stored(rows)), rows)
    v = np.arange(m.V)
    assert np.array_equal(m._raster_to_stored(rows)[0][m._stored_vidx(v)], v)
    assert m.Vt == 512 and m.tiles_per_axis == 2


def test_search_missing_block_returns_prior():
    out = _port().search(np.array([[100.0, 100.0, 100.0]]))
    assert out["state"][0] == posterior.UNKNOWN
    assert out["A"][0] == pytest.approx(LV_CFG.prior_A)
    assert not out["touched"][0]


def test_search_and_leaves_match_jax():
    scans = _scans(37, 2, n=40)
    cfg5 = dataclasses.replace(LV_CFG, block_depth=5)   # tile-major ≠ raster
    _seed_jax_pads(cfg5)
    ours, jm = _port(MapConfig(**dataclasses.asdict(cfg5))), _jax(cfg5)
    for cloud, origin in scans:
        ours.insert_pointcloud(cloud, origin)
        jm.insert_pointcloud(cloud, origin)
    pts = np.concatenate([scans[0][0], scans[1][0] - np.float32(0.15),
                          np.array([[50.0, 0.0, 0.0]], np.float32)])
    a, b = ours.search(pts), jm.search(pts)
    np.testing.assert_array_equal(a["touched"], b["touched"])
    np.testing.assert_array_equal(a["state"], b["state"])
    for k in ("A", "B", "prob", "var"):
        np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=1e-5)
    assert a["touched"].sum() > 20
    for expand in (True, False):
        la, lb = ours.leaves(expand_pruned=expand), jm.leaves(expand_pruned=expand)
        for k in ("x", "y", "z", "size", "A", "B"):
            np.testing.assert_allclose(la[k], lb[k], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(la["state"], lb["state"])
    ex = pipeline.export_leaves(ours, occupied_z_max=2.0)
    jex = jpipe.export_leaves(jm, occupied_z_max=2.0)
    assert len(ex["occupied"]["x"]) == len(jex["occupied"]["x"]) > 0


# --------------------------------------------------------- carry-across

def test_jax_checkpoint_loads_into_port_and_continues(tmp_path):
    scans = _scans(38, 3, n=40)
    jm = _jax()
    for cloud, origin in scans[:2]:
        jm.insert_pointcloud(cloud, origin)
    path = str(tmp_path / "jax_lv.npz")
    jm.save(path)
    ours = _port()
    ours.load(path)
    assert_matches_jax(ours, jm)
    for m in (ours, jm):
        m.insert_pointcloud(*scans[2])
    assert_matches_jax(ours, jm)


def test_port_checkpoint_loads_into_jax_and_continues(tmp_path):
    scans = _scans(39, 3, n=40)
    ours = _port()
    for cloud, origin in scans[:2]:
        ours.insert_pointcloud(cloud, origin)
    path = str(tmp_path / "port_lv.npz")
    ours.save(path)
    jm = _jax()
    jm.load(path)
    assert_matches_jax(ours, jm)
    for m in (ours, jm):
        m.insert_pointcloud(*scans[2])
    assert_matches_jax(ours, jm)


def test_load_state_takes_a_jax_pool():
    jm = _jax()
    jm.insert_pointcloud(*_scans(40, 1, n=40)[0])
    coords, fields, touched, eff = _pool(jm)
    ours = _port()
    ours.load_state(coords, fields, touched, eff)
    assert_matches_jax(ours, jm)
    with pytest.raises(ValueError, match="empty"):
        ours.load_state(coords, fields, touched, eff)


# ------------------------------------------------------------ pipeline

def test_run_static_matches_jax(tmp_path):
    for i, (cloud, origin) in enumerate(_scans(41, 3, n=40), start=1):
        save_pcd(str(tmp_path / f"wall_{i}.pcd"), cloud, origin)
    kw = dict(name="wall", dir=str(tmp_path), prefix="wall", scan_num=3,
              max_range=8.0)
    lv_rows.launches = lv_prune.launches = 0
    res = pipeline.run_static(TCFG, DatasetConfig(**kw), device="cpu")
    jres = jpipe.run_static(LV_CFG, JDatasetConfig(**kw))
    assert lv_rows.launches == lv_prune.launches == 0   # CPU: plain versions
    assert isinstance(res.map, bgklv.BGKLVOctoMap) and res.map.stats["scans"] == 3
    assert_matches_jax(res.map, jres.map)
    seq = pipeline.run_static(TCFG, DatasetConfig(**kw), block_per_scan=True,
                              device="cpu")
    assert_matches_jax(seq.map, jres.map)


def test_online_integrator_passes_raw_clouds_and_matches_jax(monkeypatch):
    scans = _scans(42, 2, n=60)
    scans.insert(1, (scans[0][0], scans[0][1] + np.float32(0.05)))  # gated out
    ours = pipeline.OnlineIntegrator(_port())
    ref = jpipe.OnlineIntegrator(_jax())
    seen = []
    orig = ours.map.insert_pointcloud
    monkeypatch.setattr(ours.map, "insert_pointcloud",
                        lambda c, o: (seen.append(len(c)), orig(c, o)))
    for cloud, origin in scans:
        assert ours.offer(cloud, origin) == ref.offer(cloud, origin)
    assert (ours.n_integrated, ours.n_skipped) == (2, 1)
    assert seen == [60, 60]          # the BGKLV server skips the pre-downsample
    assert_matches_jax(ours.map, ref.map)


def test_build_map_makes_bgklv_maps():
    cfg = load_method_config("bgklv", max_range=8.0)
    m = pipeline.build_map(cfg, device="cpu")
    assert isinstance(m, bgklv.BGKLVOctoMap) and m.device.type == "cpu"
    assert (cfg.block_depth, cfg.ell, m.V) == (5, 0.2, 4096)
    jcfg = jload_method_config("bgklv", max_range=8.0)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    large = load_method_config("bgklvoctomap_large_map")
    assert large.original_size and large.block_depth == 6
    assert dataclasses.asdict(large) == dataclasses.asdict(
        jload_method_config("bgklvoctomap_large_map"))
    step = m._vox_base_t[0, 1] - m._vox_base_t[0, 0]    # x fastest inside a tile
    assert torch.allclose(step, torch.tensor([0.1, 0.0, 0.0]), atol=1e-6)
