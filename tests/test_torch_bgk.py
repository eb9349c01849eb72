"""The PyTorch port's BGK slice against the JAX package and the oracle, on
the CPU.

Scans come from the same numpy seed for both packages (the small 100–120
point walls of tests/test_bgk_vs_oracle.py, block_depth 3).  Tolerances are
the JAX package's own: 2e-3 for one scan, 5e-3 for several with pruning
against the oracle; eff levels and touched flags equal except where a
voxel's added mass is ≤ 1e-5 — the k̄ > 0 gate sits on the sparse kernel's
clamp boundary, where XLA's and PyTorch's CPU sin/cos differ in ulps.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from la3dm_tpu import pipeline as jpipe
from la3dm_tpu.models import bgk as jbgk
from la3dm_tpu.utils.config import DatasetConfig as JDatasetConfig

from la3dm_tpu_torch import pipeline
from la3dm_tpu_torch.io.pcd import save_pcd
from la3dm_tpu_torch.kernels import bgk_heavy, bgk_light
from la3dm_tpu_torch.models import bgk, posterior
from la3dm_tpu_torch.utils.config import DatasetConfig, MapConfig

from tests.oracle.oracle_maps import OracleBGK
from tests.test_bgk_vs_oracle import CFG, compare_maps, synthetic_scan
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

TCFG = MapConfig(**dataclasses.asdict(CFG))
MASS_TOL = 1e-5


def _scans(seed, k, n=100):
    rng = np.random.default_rng(seed)
    return [synthetic_scan(rng, n=n, origin=(0.1 + 0.3 * i, -0.2, 0.3))
            for i in range(k)]


def _port(cfg=TCFG):
    return bgk.BGKOctoMap(cfg, device="cpu")


def _pool(m):
    """(coords, {A, B}, touched, eff) of a map of either package, raster order."""
    nb = m.pool.n_blocks
    rows = np.arange(nb)
    fields = {k: np.asarray(m._gather_rows(v, rows)) for k, v in m.pool.fields.items()}
    return (m.pool.coords[:nb], fields, np.asarray(m._gather_rows(m.pool.touched, rows)),
            np.asarray(m._gather_rows(m.pool.eff_level, rows)))


def assert_same_map(ours, ref, atol, prior=(CFG.prior_A, CFG.prior_B)):
    """Voxel by voxel: same blocks in the same slots, A/B within ``atol``,
    touched and eff equal wherever the voxel's added mass exceeds 1e-5."""
    c1, f1, t1, e1 = _pool(ours)
    c2, f2, t2, e2 = _pool(ref)
    np.testing.assert_array_equal(c1, c2)
    mass = np.zeros(t1.shape, np.float32)
    for k, p in zip(("A", "B"), prior):
        np.testing.assert_allclose(f1[k], f2[k], atol=atol, rtol=0)
        mass = np.maximum(mass, np.maximum(np.abs(f1[k] - p), np.abs(f2[k] - p)))
    away = mass > MASS_TOL
    assert away.sum() > 100
    np.testing.assert_array_equal(t1[away], t2[away])
    np.testing.assert_array_equal(e1[away], e2[away])


# ------------------------------------------------ host tables

def test_training_data_and_tables_match_jax():
    """The port's native loader, its numpy copy and the JAX package build
    bit-identical training points, bucket tables and rows."""
    from la3dm_tpu.geometry import preprocess as jpre
    from la3dm_tpu_torch.geometry import native, preprocess

    cloud, origin = _scans(10, 1, n=120)[0]
    args = (cloud, origin, CFG.ds_resolution, CFG.free_resolution, CFG.max_range)
    td = native.bgk_training_data(*args, free_label=0.0)
    np_td = preprocess.bgk_training_data(*args, free_label=0.0)
    j_td = jpre.bgk_training_data(*args, free_label=0.0)
    for other in (np_td, j_td):
        np.testing.assert_array_equal(td.points, other.points)
        np.testing.assert_array_equal(td.labels, other.labels)
    ours, jm = _port(), jbgk.BGKOctoMap(CFG)
    t, jt = ours._scan_tables(cloud, origin, None, None, None), \
        jm._scan_tables(cloud, origin, None, None, None)
    for k in ("test_coords", "entries", "labels", "starts", "counts"):
        np.testing.assert_array_equal(getattr(t, k), getattr(jt, k))
    for a, b in zip(ours._row_tables(t), jm._row_tables(jt)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------ (b) the engine step itself

def test_seq_step_plain_matches_jax_step():
    """The port's _bgk_seq_step on the argument tuple the JAX map captures
    (pool state after one scan, then a 3-scan dispatch with its padding)."""
    scans = _scans(11, 4)
    jm = jbgk.BGKOctoMap(CFG)
    jm.insert_pointcloud(*scans[0])
    jm._capture_step_args = True
    jm.insert_pointclouds([c for c, _ in scans[1:]], [o for _, o in scans[1:]])
    jax.block_until_ready(list(jm.pool.fields.values()))  # the map's own step
    # the captured arrays may view device buffers: take owned copies, one
    # set for each package (the JAX step donates its pool arguments)
    args = [np.array(a, copy=True) for a in jm._last_step_call[0]]
    st = jm._last_step_call[1]
    ref = jbgk._bgk_seq_step(*(a.copy() for a in args), **st)
    ref = [np.array(r) for r in ref]

    A0, B0 = args[0], args[1]
    targs = [torch.from_numpy(a.copy()) for a in args[:15]]
    sf = st["state_fn"]
    jbgk_step_kw = dict(G=st["G"], sf2=st["sf2"], ell=st["ell"], gate=st["gate"],
                        n=st["n"], max_level=st["max_level"], do_prune=st["do_prune"],
                        state_fn=posterior.BetaStateFn(sf.var_thresh, sf.free_thresh,
                                                       sf.occupied_thresh))
    assert int((args[16] > 0).sum()) == 3     # three scans, padded to 16 steps
    bgk._bgk_seq_step(*targs, args[15].tolist(), args[16].tolist(), **jbgk_step_kw)
    A, B, touched, eff = (t.numpy() for t in targs[:4])

    np.testing.assert_allclose(A, ref[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(B, ref[1], atol=1e-4, rtol=0)
    mass = np.maximum(np.maximum(np.abs(A - A0), np.abs(ref[0] - A0)),
                      np.maximum(np.abs(B - B0), np.abs(ref[1] - B0)))
    away = mass > MASS_TOL
    assert away.sum() > 1000 and (ref[3] > 0).any()
    np.testing.assert_array_equal(touched[away], ref[2][away])
    np.testing.assert_array_equal(eff[away], ref[3][away])


# ------------------------------------------------ (c) the whole slice

def test_single_scan_vs_oracle_and_jax():
    cloud, origin = _scans(12, 1, n=120)[0]
    ours = _port()
    ours.insert_pointcloud(cloud, origin)
    om = OracleBGK(CFG)
    om.insert_pointcloud(cloud, origin, CFG.ds_resolution, CFG.free_resolution,
                         CFG.max_range)
    n, _ = compare_maps(ours, om, atol=2e-3)
    assert n > 500
    jm = jbgk.BGKOctoMap(CFG)
    jm.insert_pointcloud(cloud, origin)
    assert_same_map(ours, jm, atol=2e-3)


def test_multi_scan_with_pruning_vs_oracle_and_jax():
    ours, om, jm = _port(), OracleBGK(CFG), jbgk.BGKOctoMap(CFG)
    for cloud, origin in _scans(13, 3):
        ours.insert_pointcloud(cloud, origin)
        jm.insert_pointcloud(cloud, origin)
        om.insert_pointcloud(cloud, origin, CFG.ds_resolution, CFG.free_resolution,
                             CFG.max_range)
    compare_maps(ours, om, atol=5e-3)
    coords, _, _, effs = _pool(ours)
    slot_of = {tuple(c): i for i, c in enumerate(coords)}
    n_pruned = 0
    for (bc, v), leaf in om.base_voxel_dict().items():
        L = om.depth - 1 - leaf.depth
        assert int(effs[slot_of[bc], v]) == L, (bc, v, L)
        n_pruned += L > 0
    assert n_pruned > 0
    assert_same_map(ours, jm, atol=5e-3)


# ------------------------------------------------ (d) batching

def test_insert_pointclouds_equals_sequential_inserts():
    scans = _scans(14, 4)
    seq, batch = _port(), _port()
    for cloud, origin in scans:
        seq.insert_pointcloud(cloud, origin)
    batch.insert_pointclouds([c for c, _ in scans], [o for _, o in scans])
    assert seq.stats["scans"] == batch.stats["scans"] == 4
    assert seq.stats["kernel_evals"] == batch.stats["kernel_evals"]
    c1, f1, t1, e1 = _pool(seq)
    c2, f2, t2, e2 = _pool(batch)
    np.testing.assert_array_equal(c1, c2)
    for k in f1:
        np.testing.assert_allclose(f1[k], f2[k], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(e1, e2)
    assert (e1 > 0).any()


def test_scan_batches_are_chunked(monkeypatch):
    calls = []
    orig = bgk._bgk_seq_step
    monkeypatch.setattr(bgk, "_bgk_seq_step",
                        lambda *a, **k: (calls.append(len(a[15])), orig(*a, **k)))
    monkeypatch.setattr(bgk, "_SCAN_BATCH", 2)
    m = _port()
    scans = _scans(15, 5)
    m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans])
    assert calls == [2, 2, 1]


# ------------------------------------------------ (e) queries, training data

def test_search_missing_block_returns_prior():
    m = _port()
    out = m.search(np.array([[100.0, 100.0, 100.0]]))
    assert out["state"][0] == posterior.UNKNOWN
    assert out["A"][0] == pytest.approx(CFG.prior_A)
    assert out["B"][0] == pytest.approx(CFG.prior_B)
    assert not out["touched"][0]


def test_search_and_leaves_match_jax():
    scans = _scans(16, 2)
    ours, jm = _port(), jbgk.BGKOctoMap(CFG)
    for cloud, origin in scans:
        ours.insert_pointcloud(cloud, origin)
        jm.insert_pointcloud(cloud, origin)
    pts = np.concatenate([scans[0][0], np.array([[50.0, 0.0, 0.0]], np.float32)])
    a, b = ours.search(pts), jm.search(pts)
    for k in ("A", "B", "prob"):
        np.testing.assert_allclose(a[k], b[k], atol=5e-3, rtol=0)
    la, lb = ours.leaves(expand_pruned=False), jm.leaves(expand_pruned=False)
    for k in ("x", "y", "z", "size"):
        np.testing.assert_allclose(la[k], lb[k], atol=1e-6)
    np.testing.assert_array_equal(ours.get_bbox()[0], jm.get_bbox()[0])
    ex = pipeline.export_leaves(ours)
    assert len(ex["occupied"]["x"]) > 0 and len(ex["free"]["x"]) > 0
    fr = pipeline.frontier_leaves(ours, 0.0, 0.5, -10, 10)
    jfr = jpipe.frontier_leaves(jm, 0.0, 0.5, -10, 10)
    assert abs(len(fr["x"]) - len(jfr["x"])) <= 0.01 * len(jfr["x"])


def test_insert_training_data_vs_oracle():
    rng = np.random.default_rng(17)
    pts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    labels = (rng.uniform(size=50) > 0.5).astype(np.float32)
    ours = _port()
    ours.insert_training_data(pts, labels)
    om = OracleBGK(CFG)
    om.insert_training(pts, labels)
    n, _ = compare_maps(ours, om)
    assert n > 0


# ------------------------------------------------ (f) carry-across

def test_jax_checkpoint_loads_into_port_and_continues(tmp_path):
    scans = _scans(18, 3)
    jm = jbgk.BGKOctoMap(CFG)
    for cloud, origin in scans[:2]:
        jm.insert_pointcloud(cloud, origin)
    path = str(tmp_path / "jax_map.npz")
    jm.save(path)
    ours = _port()
    ours.load(path)
    assert_same_map(ours, jm, atol=0.0)
    for m in (ours, jm):
        m.insert_pointcloud(*scans[2])
    assert_same_map(ours, jm, atol=5e-3)


def test_port_checkpoint_loads_into_jax_and_continues(tmp_path):
    scans = _scans(19, 3)
    ours = _port()
    for cloud, origin in scans[:2]:
        ours.insert_pointcloud(cloud, origin)
    path = str(tmp_path / "port_map.npz")
    ours.save(path)
    jm = jbgk.BGKOctoMap(CFG)
    jm.load(path)
    assert_same_map(ours, jm, atol=0.0)
    for m in (ours, jm):
        m.insert_pointcloud(*scans[2])
    assert_same_map(ours, jm, atol=5e-3)


def test_load_state_takes_a_jax_pool():
    jm = jbgk.BGKOctoMap(CFG)
    jm.insert_pointcloud(*_scans(20, 1)[0])
    coords, fields, touched, eff = _pool(jm)
    ours = _port()
    ours.load_state(coords, fields, touched, eff)
    assert_same_map(ours, jm, atol=0.0)
    with pytest.raises(ValueError, match="empty"):
        ours.load_state(coords, fields, touched, eff)


# ------------------------------------------------ (g) pipeline

def test_run_static_matches_jax(tmp_path):
    for i, (cloud, origin) in enumerate(_scans(21, 3), start=1):
        save_pcd(str(tmp_path / f"wall_{i}.pcd"), cloud, origin)
    kw = dict(name="wall", dir=str(tmp_path), prefix="wall", scan_num=3,
              max_range=8.0)
    bgk_heavy.launches = bgk_light.launches = 0
    res = pipeline.run_static(TCFG, DatasetConfig(**kw), device="cpu")
    jres = jpipe.run_static(CFG, JDatasetConfig(**kw))
    assert bgk_heavy.launches == bgk_light.launches == 0   # CPU: plain versions
    assert res.map.stats["scans"] == 3 and len(res.per_scan_seconds) == 3
    assert_same_map(res.map, jres.map, atol=5e-3)
    seq = pipeline.run_static(TCFG, DatasetConfig(**kw), block_per_scan=True,
                              device="cpu")
    assert_same_map(seq.map, jres.map, atol=5e-3)


def test_online_integrator_matches_jax():
    scans = _scans(22, 3, n=120)
    scans.insert(1, (scans[0][0], scans[0][1] + np.float32(0.05)))  # gated out
    ours = pipeline.OnlineIntegrator(_port())
    ref = jpipe.OnlineIntegrator(jbgk.BGKOctoMap(CFG))
    for cloud, origin in scans:
        assert ours.offer(cloud, origin) == ref.offer(cloud, origin)
    assert (ours.n_integrated, ours.n_skipped) == (3, 1)
    assert_same_map(ours.map, ref.map, atol=5e-3)
