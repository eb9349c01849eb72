"""The PyTorch port's GP slice against the JAX package and the oracle, on the
CPU.

Scans come from the same numpy seed for both packages: the small walls of
tests/test_bgk_vs_oracle.py under ``GP_CFG`` of
tests/test_families_vs_oracle.py (block_depth 3) and the large-map config
(block_depth 4).  Against the oracle the tolerances are that file's (atol
5e-2 / rtol 0.02 for one scan, 1e-1 / 0.05 for two, 5e-3 for the large
map).  Against the JAX map the comparison is voxel by voxel: m_ivar and
ivar within 2e-2 + 2e-3·|JAX| — the two packages' LAPACKs round the
Cholesky factor in different orders, and the BCM weights 1/σ² (σ² ≈ noise
near training points) amplify it — touched equal everywhere (GP has no
gate), state equal except where either map's p lies within 1e-3 of a
threshold or its ivar within 1e-3·min_known_ivar of the chop (counted), and
eff equal in every block without such a voxel.

JAX's heavy and light steps compile once per padded shape; the pads of every
config used here are seeded large enough for all its scans.
"""

import dataclasses

import numpy as np
import pytest
import torch

from la3dm_tpu import pipeline as jpipe
from la3dm_tpu.geometry import native as jnative
from la3dm_tpu.models import gp as jgp
from la3dm_tpu.utils.config import DatasetConfig as JDatasetConfig
from la3dm_tpu.utils.config import load_method_config as jload_method_config

from la3dm_tpu_torch import pipeline
from la3dm_tpu_torch.io.pcd import save_pcd
from la3dm_tpu_torch.kernels import gp_heavy, gp_light
from la3dm_tpu_torch.models import gp, posterior
from la3dm_tpu_torch.utils.config import DatasetConfig, MapConfig, load_method_config

from tests.oracle.oracle_maps import OracleGP
from tests.test_bgk_vs_oracle import compare_maps, synthetic_scan
from tests.test_families_vs_oracle import GP_CFG
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

TCFG = MapConfig(**dataclasses.asdict(GP_CFG))
LARGE_CFG = load_method_config("gpoctomap_large_map", max_range=8.0)
JLARGE_CFG = jload_method_config("gpoctomap_large_map", max_range=8.0)
#: state margin: p within this of a threshold, or ivar within this times
#: min_known_ivar of the chop, may be decided apart by the packages' roundings
MARGIN = 1e-3


def _seed_jax_pads(cfg):
    jgp._GLOBAL_PADS.setdefault(
        ("GPOctoMap", cfg),
        {"N": 8192, "T": 2048, "B": 1024, "tiers": {128: {"M": 512}, 256: {"M": 64},
                                                    512: {"M": 64}}})


for _cfg in (GP_CFG, JLARGE_CFG):
    _seed_jax_pads(_cfg)


def _scans(seed, k, n=40):
    rng = np.random.default_rng(seed)
    return [synthetic_scan(rng, n=n, origin=(0.1, -0.2 + 0.4 * i, 0.3))
            for i in range(k)]


def _port(cfg=TCFG):
    return gp.GPOctoMap(cfg, device="cpu")


def _jax(cfg=GP_CFG):
    return jgp.GPOctoMap(cfg)


def _pool(m):
    """(coords, {m_ivar, ivar}, touched, eff) of a map of either package."""
    nb = m.pool.n_blocks
    rows = np.arange(nb)
    fields = {k: np.asarray(m._gather_rows(v, rows)) for k, v in m.pool.fields.items()}
    return (m.pool.coords[:nb], fields, np.asarray(m._gather_rows(m.pool.touched, rows)),
            np.asarray(m._gather_rows(m.pool.eff_level, rows)))


def _near_threshold(m, f, margin):
    post = m._posterior({**f, "touched": np.ones_like(f["ivar"], bool)})
    p, cfg = post["prob"], m.cfg
    return ((np.abs(p - cfg.free_thresh) <= margin)
            | (np.abs(p - cfg.occupied_thresh) <= margin)
            | (np.abs(f["ivar"] - m.min_known_ivar) <= margin * m.min_known_ivar))


def assert_matches_jax(ours, ref, min_touched=300, atol=2e-2, rtol=2e-3,
                       margin=MARGIN):
    """Voxel by voxel as the module docstring states; returns the number of
    near-threshold voxels excused from the state and eff comparisons."""
    c1, f1, t1, e1 = _pool(ours)
    c2, f2, t2, e2 = _pool(ref)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(t1, t2)
    assert t1.sum() > min_touched
    for k in ("m_ivar", "ivar"):
        np.testing.assert_allclose(f1[k], f2[k], atol=atol, rtol=rtol, err_msg=k)
    near = t1 & (_near_threshold(ours, f1, margin) | _near_threshold(ref, f2, margin))
    s1 = ours._posterior({**f1, "touched": t1})["state"]
    s2 = ref._posterior({**f2, "touched": t2})["state"]
    np.testing.assert_array_equal(s1[~near], s2[~near])
    calm = ~near.any(axis=1)
    np.testing.assert_array_equal(e1[calm], e2[calm])
    assert near.sum() <= 0.01 * t1.sum()
    return int(near.sum())


# ------------------------------------------------------------ host tables

def test_model_tables_match_jax():
    """The port's native binding returns the JAX package's model-side tables
    bit for bit, and the two maps build the same model tables."""
    cloud, origin = _scans(50, 1, n=80)[0]
    ours, jm = _port(), _jax()
    t = ours._scan_model_tables(cloud, origin, None, None, None)
    jt = jm._scan_model_tables(cloud, origin, None, None, None)
    assert t.keys() == jt.keys()
    for k in t:
        np.testing.assert_array_equal(t[k], jt[k], err_msg=k)
    assert (t["lab"] == -1.0).any() and (t["lab"] == 1.0).any()
    from la3dm_tpu_torch.geometry import native
    args = (t["pts"], t["lab"], ours.block_size, ours._neighbor_offsets)
    nt, jnt = native.scan_bucket_tables(*args), jnative.scan_bucket_tables(*args)
    assert nt.keys() == jnt.keys()
    for k in nt:
        np.testing.assert_array_equal(nt[k], jnt[k], err_msg=k)


# ---------------------------------------------------------- the whole slice

def test_single_scan_vs_oracle_and_jax():
    cloud, origin = _scans(51, 1)[0]
    ours, jm = _port(), _jax()
    ours.insert_pointcloud(cloud, origin)
    jm.insert_pointcloud(cloud, origin)
    om = OracleGP(GP_CFG)
    om.insert_pointcloud(cloud, origin, GP_CFG.ds_resolution, GP_CFG.free_resolution,
                         GP_CFG.max_range)
    n, _ = compare_maps(ours, om, atol=5e-2, rtol=0.02)
    assert n > 300
    near = assert_matches_jax(ours, jm)
    print(f"single scan: {near} near-threshold voxels")
    assert int(ours.failed_models) == 0


def test_two_scans_vs_oracle_and_jax():
    ours, jm, om = _port(), _jax(), OracleGP(GP_CFG)
    for cloud, origin in _scans(52, 2, n=30):
        ours.insert_pointcloud(cloud, origin)
        jm.insert_pointcloud(cloud, origin)
        om.insert_pointcloud(cloud, origin, GP_CFG.ds_resolution,
                             GP_CFG.free_resolution, GP_CFG.max_range)
    compare_maps(ours, om, atol=1e-1, rtol=0.05)
    near = assert_matches_jax(ours, jm)
    print(f"two scans: {near} near-threshold voxels")


def test_large_map_depth4_vs_oracle_and_jax():
    """gpoctomap_large_map: block_depth 4 (V = 512), the prune over 3 levels,
    as tests/test_families_vs_oracle.py::test_gp_large_map_depth4, at its
    tolerance against the oracle."""
    assert LARGE_CFG.block_depth == 4 and LARGE_CFG.original_size
    assert dataclasses.asdict(LARGE_CFG) == dataclasses.asdict(JLARGE_CFG)
    cloud, origin = _scans(53, 1)[0]
    ours, jm = _port(LARGE_CFG), _jax(JLARGE_CFG)
    ours.insert_pointcloud(cloud, origin)
    jm.insert_pointcloud(cloud, origin)
    om = OracleGP(JLARGE_CFG)
    om.insert_pointcloud(cloud, origin, LARGE_CFG.ds_resolution,
                         LARGE_CFG.free_resolution, LARGE_CFG.max_range)
    n, _ = compare_maps(ours, om, atol=5e-3)
    assert n > 0
    near = assert_matches_jax(ours, jm, min_touched=100)
    print(f"large map: {near} near-threshold voxels")


def test_large_map_overflow_tier_matches_jax(monkeypatch):
    """The large-map config on a scan downsampled at 0.1 (not its 0.5), so
    that three blocks hold more than 128 points and the overflow tier
    runs."""
    tiers = []
    orig = gp_heavy.gp_heavy
    monkeypatch.setattr(gp_heavy, "gp_heavy",
                        lambda *a, **k: (tiers.append(int(k["host_counts"].max())),
                                         orig(*a, **k)))
    cloud, origin = _scans(53, 1)[0]
    ours, jm = _port(LARGE_CFG), _jax(JLARGE_CFG)
    ours.insert_pointcloud(cloud, origin, ds_resolution=0.1)
    jm.insert_pointcloud(cloud, origin, ds_resolution=0.1)
    assert len(tiers) == 2 and tiers[0] <= 128 < tiers[1]
    near = assert_matches_jax(ours, jm, min_touched=100)
    print(f"large map, overflow tier: {near} near-threshold voxels")
    assert (_pool(ours)[3] > 0).any()


def test_insert_training_data_overflow_tier_matches_jax(monkeypatch):
    """A dense block of 300 points (the large map's 1.6 m block (0, 0, 0))
    forces the overflow tier.  Its Gram at ℓ = 1 has a condition
    number near 1e4, so the two packages' f32 factors differ by ≈ 1e-3 in
    α, and m_ivar by up to 3 % (atol 0.1), state margin 1e-2."""
    rng = np.random.default_rng(54)
    dense = rng.uniform(-0.75, 0.75, (300, 3))
    sparse = rng.uniform(-3.0, 3.0, (60, 3))
    pts = np.concatenate([dense, sparse]).astype(np.float32)
    lab = np.where(rng.uniform(size=len(pts)) < 0.5, 1.0, -1.0).astype(np.float32)
    tiers = []
    orig = gp_heavy.gp_heavy
    monkeypatch.setattr(gp_heavy, "gp_heavy",
                        lambda *a, **k: (tiers.append((int(k["host_counts"].max()), len(a[2]))),
                                         orig(*a, **k)))
    ours, jm = _port(LARGE_CFG), _jax(JLARGE_CFG)
    ours.insert_training_data(pts, lab)
    jm.insert_training_data(pts, lab)
    assert len(tiers) == 2 and tiers[0][0] <= 128 and tiers[1] == (302, 1)
    assert ours.stats["heavy_tiers"] == 2
    assert_matches_jax(ours, jm, min_touched=100, atol=0.1, rtol=0.03, margin=1e-2)


# ------------------------------------------------------------ batching

def test_insert_pointclouds_equals_sequential_inserts():
    scans = _scans(55, 3, n=30)
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
        np.testing.assert_allclose(f1[k], f2[k], atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(e1, e2)


def test_scan_batches_are_chunked(monkeypatch):
    heavy, light = [], []
    monkeypatch.setattr(gp_heavy, "gp_heavy", lambda *a, **k: heavy.append(1))
    monkeypatch.setattr(gp_light, "gp_light", lambda *a, **k: light.append(1))
    monkeypatch.setattr(gp, "_SCAN_BATCH", 2)
    m = _port()
    scans = _scans(56, 5, n=20)
    m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans])
    assert len(heavy) == 3 and len(light) == 5 and m.stats["scans"] == 5
    assert m.stats["heavy_tiers"] == len(heavy)


# ------------------------------------------------------------ queries

def test_search_and_leaves_match_jax():
    scans = _scans(57, 2, n=30)
    ours, jm = _port(), _jax()
    for cloud, origin in scans:
        ours.insert_pointcloud(cloud, origin)
        jm.insert_pointcloud(cloud, origin)
    pts = np.concatenate([scans[0][0], scans[1][0] - np.float32(0.15),
                          np.array([[50.0, 0.0, 0.0]], np.float32)])
    a, b = ours.search(pts), jm.search(pts)
    np.testing.assert_array_equal(a["touched"], b["touched"])
    assert a["touched"].sum() > 20 and not a["touched"][-1]
    assert a["ivar"][-1] == pytest.approx(1.0 / GP_CFG.max_var)
    for k in ("m_ivar", "ivar"):
        np.testing.assert_allclose(a[k], b[k], atol=2e-2, rtol=2e-3)
    for expand in (True, False):
        la, lb = ours.leaves(expand_pruned=expand), jm.leaves(expand_pruned=expand)
        for k in ("x", "y", "z", "size"):
            np.testing.assert_array_equal(la[k], lb[k])
        np.testing.assert_allclose(la["m_ivar"], lb["m_ivar"], atol=2e-2, rtol=2e-3)
    ex, jex = pipeline.export_leaves(ours), jpipe.export_leaves(jm)
    assert abs(len(ex["occupied"]["x"]) - len(jex["occupied"]["x"])) <= 5
    assert len(ex["occupied"]["x"]) > 0 and len(ex["free"]["x"]) > 0


# --------------------------------------------------------- carry-across

def test_jax_checkpoint_loads_into_port_and_continues(tmp_path):
    scans = _scans(58, 3, n=30)
    jm = _jax()
    for cloud, origin in scans[:2]:
        jm.insert_pointcloud(cloud, origin)
    path = str(tmp_path / "jax_gp.npz")
    jm.save(path)
    ours = _port()
    ours.load(path)
    c1, f1, t1, e1 = _pool(ours)
    c2, f2, t2, e2 = _pool(jm)
    np.testing.assert_array_equal(c1, c2)
    for k in f1:
        np.testing.assert_array_equal(f1[k], f2[k])
    for m in (ours, jm):
        m.insert_pointcloud(*scans[2])
    assert_matches_jax(ours, jm)


def test_port_checkpoint_loads_into_jax_and_continues(tmp_path):
    scans = _scans(59, 3, n=30)
    ours = _port()
    for cloud, origin in scans[:2]:
        ours.insert_pointcloud(cloud, origin)
    path = str(tmp_path / "port_gp.npz")
    ours.save(path)
    jm = _jax()
    jm.load(path)
    for m in (ours, jm):
        m.insert_pointcloud(*scans[2])
    assert_matches_jax(ours, jm)


# ------------------------------------------------------------ pipeline

def test_run_static_matches_jax(tmp_path):
    for i, (cloud, origin) in enumerate(_scans(60, 3, n=30), start=1):
        save_pcd(str(tmp_path / f"wall_{i}.pcd"), cloud, origin)
    kw = dict(name="wall", dir=str(tmp_path), prefix="wall", scan_num=3, max_range=8.0)
    gp_heavy.launches = gp_light.launches = 0
    res = pipeline.run_static(TCFG, DatasetConfig(**kw), device="cpu")
    jres = jpipe.run_static(GP_CFG, JDatasetConfig(**kw))
    assert gp_heavy.launches == gp_light.launches == 0   # CPU: plain versions
    assert isinstance(res.map, gp.GPOctoMap) and res.map.stats["scans"] == 3
    assert_matches_jax(res.map, jres.map)


def test_online_integrator_matches_jax():
    scans = _scans(61, 2, n=40)
    scans.insert(1, (scans[0][0], scans[0][1] + np.float32(0.05)))  # gated out
    ours = pipeline.OnlineIntegrator(_port())
    ref = jpipe.OnlineIntegrator(_jax())
    for cloud, origin in scans:
        assert ours.offer(cloud, origin) == ref.offer(cloud, origin)
    assert (ours.n_integrated, ours.n_skipped) == (2, 1)
    assert ours.map.SERVER_DOWNSAMPLE
    assert_matches_jax(ours.map, ref.map)


def test_build_map_makes_gp_maps():
    cfg = load_method_config("gp", max_range=8.0)
    m = pipeline.build_map(cfg, device="cpu")
    assert isinstance(m, gp.GPOctoMap) and m.device.type == "cpu"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jload_method_config("gp", max_range=8.0))
    assert m.FIELD_FILLS == {"m_ivar": 0.0, "ivar": 1.0 / cfg.max_var}
    assert m._state_fn == posterior.GPStateFn(100.0, 1000.0, 50.0, 0.3, 0.7)
    assert m._all_nodes.shape == (73, 3) and torch.equal(
        m._node_idx[0], torch.arange(64, dtype=torch.int32))
