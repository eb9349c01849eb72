"""The PyTorch port's BGKL slice against the JAX package and the oracle, on
the CPU, on both ingest paths.

Scans come from the same numpy seed for both packages (the small walls of
tests/test_bgk_vs_oracle.py, block_depth 3, the BGKL config of
tests/test_families_vs_oracle.py: ℓ 0.2, free_resolution 0.3, gate 0.001).
Limits:

* the engine step (the captured JAX ``_bgk_seq_step(segments=True,
  gate=0.001)``) within 1e-4;
* host-ingest maps against the JAX map within tests/test_torch_bgk.py's bars
  (2e-3 one scan, 5e-3 several), against ``OracleBGKL`` within
  tests/test_families_vs_oracle.py's (3e-3, 5e-3);
* device-ingest maps against the JAX map with ``device_ingest="on"`` within
  1e-5 + 1e-5·|JAX| (tests/test_torch_ingest.py's bar);
* eff and touched equal wherever the voxel's added mass exceeds 1e-5.

JAX gets copies of every array it is handed (its steps donate their inputs
and run asynchronously).
"""

import dataclasses

import jax
import numpy as np
import pytest

from la3dm_tpu import pipeline as jpipe
from la3dm_tpu.geometry import device_ingest as jdi, preprocess as jpre
from la3dm_tpu.models import bgk as jbgk, bgkl as jbgkl
from la3dm_tpu.utils.config import DatasetConfig as JDatasetConfig

from la3dm_tpu_torch import pipeline
from la3dm_tpu_torch.geometry import native, preprocess
from la3dm_tpu_torch.io.pcd import save_pcd
from la3dm_tpu_torch.kernels import bgk_aligned_heavy, bgk_heavy, ingest_rays
from la3dm_tpu_torch.models import bgk, bgkl, posterior
from la3dm_tpu_torch.utils.config import DatasetConfig, MapConfig

from tests.oracle.oracle_maps import OracleBGKL
from tests.test_bgk_vs_oracle import compare_maps, synthetic_scan
from tests.test_families_vs_oracle import BGKL_CFG
from tests.test_torch_bgk import MASS_TOL, _pool
from tests.test_torch_ingest import assert_bgk_close, assert_bgk_matches
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

TCFG = MapConfig(**dataclasses.asdict(BGKL_CFG))
ON = dataclasses.replace(BGKL_CFG, device_ingest="on")
MAX_RANGE = 6.0


def _t(cfg):
    return MapConfig(**dataclasses.asdict(cfg))


def _scans(seed, k, n=60):
    rng = np.random.default_rng(seed)
    return [synthetic_scan(rng, n=n, origin=(0.1, -0.2 + 0.3 * i, 0.3)) for i in range(k)]


def _port(cfg=TCFG):
    return bgkl.BGKLOctoMap(cfg, device="cpu")


def assert_same_map(ours, ref, atol):
    """Same blocks in the same slots, A/B within ``atol``, touched and eff
    equal wherever the voxel's added mass exceeds 1e-5."""
    c1, f1, t1, e1 = _pool(ours)
    c2, f2, t2, e2 = _pool(ref)
    np.testing.assert_array_equal(c1, c2)
    mass = np.zeros(t1.shape, np.float32)
    for k, p in zip(("A", "B"), (BGKL_CFG.prior_A, BGKL_CFG.prior_B)):
        np.testing.assert_allclose(f1[k], f2[k], atol=atol, rtol=0, err_msg=k)
        mass = np.maximum(mass, np.maximum(np.abs(f1[k] - p), np.abs(f2[k] - p)))
    away = mass > MASS_TOL
    assert away.sum() > 100
    np.testing.assert_array_equal(t1[away], t2[away])
    np.testing.assert_array_equal(e1[away], e2[away])


# ------------------------------------------------ host tables

def test_training_data_and_tables_match_jax():
    """The native loader, the numpy copy and the JAX package build
    bit-identical segment training data and bucket tables; the numpy
    ``segment_block_entries`` equals the JAX one."""
    from la3dm_tpu.models.bgkl import segment_block_entries as j_entries

    cloud, origin = _scans(30, 1, n=120)[0]
    args = (cloud, origin, BGKL_CFG.ds_resolution, BGKL_CFG.free_resolution, MAX_RANGE)
    td, np_td, j_td = (native.bgkl_training_data(*args),
                       preprocess.bgkl_training_data(*args), jpre.bgkl_training_data(*args))
    assert len(td.hits) > 50 and len(td.samples) > 5 * len(td.hits)
    for other in (np_td, j_td):
        np.testing.assert_array_equal(td.hits, other.hits)
        np.testing.assert_array_equal(td.rays, other.rays)
    # the native sample order is origins, then each beam's samples; the
    # numpy one (both packages) the same multiset
    for a, b in ((np_td, j_td),):
        np.testing.assert_array_equal(a.samples, b.samples)
        np.testing.assert_array_equal(a.sample_ray, b.sample_ray)
    for ours, ref in zip(bgkl.segment_block_entries(np_td, TCFG.block_size),
                         j_entries(j_td, BGKL_CFG.block_size)):
        np.testing.assert_array_equal(ours, ref)
    ours, jm = _port(), jbgkl.BGKLOctoMap(BGKL_CFG)
    t = ours._scan_tables(cloud, origin, None, None, MAX_RANGE)
    jt = jm._scan_tables(cloud, origin, None, None, MAX_RANGE)
    assert t.entries.shape[1] == 6
    for k in ("test_coords", "entries", "labels", "starts", "counts"):
        np.testing.assert_array_equal(getattr(t, k), getattr(jt, k))


# ------------------------------------------------ the engine step

def test_seq_step_plain_matches_jax_step():
    """The port's _bgk_seq_step (K1's segment branch + K2 at the 0.001 gate,
    plain versions) on the argument tuple the JAX BGKL map captures: pool
    state after one scan, then a 3-scan dispatch."""
    scans = _scans(31, 4)
    jm = jbgkl.BGKLOctoMap(BGKL_CFG)
    jm.insert_pointcloud(scans[0][0].copy(), scans[0][1].copy(), max_range=MAX_RANGE)
    jm._capture_step_args = True
    jm.insert_pointclouds([c.copy() for c, _ in scans[1:]], [o.copy() for _, o in scans[1:]],
                          max_range=MAX_RANGE)
    jax.block_until_ready(list(jm.pool.fields.values()))
    args = [np.array(a, copy=True) for a in jm._last_step_call[0]]
    st = jm._last_step_call[1]
    assert st["segments"] and st["gate"] == 0.001 and args[6].shape[1] == 6
    ref = [np.array(r) for r in jbgk._bgk_seq_step(*(a.copy() for a in args), **st)]

    import torch

    A0, B0 = args[0], args[1]
    targs = [torch.from_numpy(a.copy()) for a in args[:15]]
    sf = st["state_fn"]
    kw = dict(G=st["G"], sf2=st["sf2"], ell=st["ell"], gate=st["gate"], n=st["n"],
              max_level=st["max_level"], do_prune=st["do_prune"],
              state_fn=posterior.BetaStateFn(sf.var_thresh, sf.free_thresh,
                                             sf.occupied_thresh))
    bgk._bgk_seq_step(*targs, args[15].tolist(), args[16].tolist(), **kw)
    A, B, touched, eff = (x.numpy() for x in targs[:4])
    np.testing.assert_allclose(A, ref[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(B, ref[1], atol=1e-4, rtol=0)
    mass = np.maximum(np.maximum(np.abs(A - A0), np.abs(ref[0] - A0)),
                      np.maximum(np.abs(B - B0), np.abs(ref[1] - B0)))
    away = mass > MASS_TOL
    assert away.sum() > 1000 and (ref[3] > 0).any()
    np.testing.assert_array_equal(touched[away], ref[2][away])
    np.testing.assert_array_equal(eff[away], ref[3][away])


# ------------------------------------------------ host-ingest maps

def test_single_scan_vs_oracle_and_jax():
    cloud, origin = _scans(32, 1)[0]
    ours = _port()
    ours.insert_pointcloud(cloud, origin, max_range=MAX_RANGE)
    assert ours.stats["ingest_host_chunks"] == 0     # auto: the host path on a CPU map
    om = OracleBGKL(BGKL_CFG)
    om.insert_pointcloud(cloud, origin, BGKL_CFG.ds_resolution, BGKL_CFG.free_resolution,
                         MAX_RANGE)
    n, _ = compare_maps(ours, om, atol=3e-3)
    assert n > 300
    jm = jbgkl.BGKLOctoMap(BGKL_CFG)
    jm.insert_pointcloud(cloud.copy(), origin.copy(), max_range=MAX_RANGE)
    assert_same_map(ours, jm, atol=2e-3)


def test_multi_scan_with_pruning_vs_oracle_and_jax():
    ours, om, jm = _port(), OracleBGKL(BGKL_CFG), jbgkl.BGKLOctoMap(BGKL_CFG)
    for cloud, origin in _scans(33, 3, n=50):
        ours.insert_pointcloud(cloud, origin, max_range=MAX_RANGE)
        jm.insert_pointcloud(cloud.copy(), origin.copy(), max_range=MAX_RANGE)
        om.insert_pointcloud(cloud, origin, BGKL_CFG.ds_resolution, BGKL_CFG.free_resolution,
                             MAX_RANGE)
    compare_maps(ours, om, atol=5e-3)
    assert (ours.pool.eff_level > 0).any()
    assert_same_map(ours, jm, atol=5e-3)


def test_insert_pointclouds_equals_sequential_inserts():
    scans = _scans(34, 3)
    seq, batch = _port(), _port()
    for cloud, origin in scans:
        seq.insert_pointcloud(cloud, origin, max_range=MAX_RANGE)
    batch.insert_pointclouds([c for c, _ in scans], [o for _, o in scans], max_range=MAX_RANGE)
    assert seq.stats["kernel_evals"] == batch.stats["kernel_evals"] > 0
    assert_same_map(batch, seq, atol=1e-5)


def test_insert_training_data_matches_jax():
    """Raw segments (rays, degenerate hits, one shorter than the 1e-4
    threshold), each keyed by its start point's block."""
    rng = np.random.default_rng(35)
    start = rng.uniform(-1, 1, (80, 3)).astype(np.float32)
    end = start + rng.uniform(-0.6, 0.6, (80, 3)).astype(np.float32)
    end[::5] = start[::5]
    end[1] = start[1] + np.float32(2e-5)
    seg = np.concatenate([start, end], axis=1)
    labels = (np.arange(80) % 5 == 0).astype(np.float32)
    ours, jm = _port(), jbgkl.BGKLOctoMap(BGKL_CFG)
    ours.insert_training_data(seg, labels)
    jm.insert_training_data(seg.copy(), labels.copy())
    assert ours.stats["scans"] == jm.stats["scans"] == 1
    assert ours.pool.n_blocks == jm.pool.n_blocks > 0
    assert_same_map(ours, jm, atol=2e-3)


# ------------------------------------------------ device-ingest maps

def test_device_ingest_maps_match_jax():
    """3 scans, one dispatch, then one more scan alone (K = 1): the port's
    device path (plain K7a, K7b, K7d, K7c, K1′, K2) against JAX's, and
    against the port's host path within JAX's own device-vs-host bar."""
    scans = _scans(36, 4)
    jm = jbgkl.BGKLOctoMap(ON)
    jm.insert_pointclouds([c.copy() for c, _ in scans[:3]], [o.copy() for _, o in scans[:3]],
                          max_range=MAX_RANGE)
    jm.insert_pointcloud(scans[3][0].copy(), scans[3][1].copy(), max_range=MAX_RANGE)
    jax.block_until_ready(list(jm.pool.fields.values()))
    ours = _port(_t(ON))
    bgk_heavy.launches = bgk_aligned_heavy.launches = ingest_rays.launches = 0
    ours.insert_pointclouds([c for c, _ in scans[:3]], [o for _, o in scans[:3]],
                            max_range=MAX_RANGE)
    ours.insert_pointcloud(*scans[3], max_range=MAX_RANGE)
    assert bgk_heavy.launches == bgk_aligned_heavy.launches == ingest_rays.launches == 0
    assert ours.stats["scans"] == 4 and ours.stats["ingest_host_chunks"] == 0
    assert ours.stats["kernel_evals"] == jm.stats["kernel_evals"]
    assert_bgk_matches(ours, jm)
    off = _port()
    off.insert_pointclouds([c for c, _ in scans[:3]], [o for _, o in scans[:3]],
                           max_range=MAX_RANGE)
    off.insert_pointcloud(*scans[3], max_range=MAX_RANGE)
    assert_bgk_close(ours, off)


def test_long_diagonal_beam_matches_what_jax_integrates(monkeypatch):
    """tests/test_device_ingest.py's Rmax boundary scene: one long diagonal
    beam whose samples walk more distinct blocks than JAX's 8 Rmax slots.
    JAX regrows Rmax and retries on the device; the port, with no Rmax,
    integrates the same map in one pass."""
    real_spec_for = jdi.spec_for
    monkeypatch.setattr(jdi, "spec_for", lambda *a: dataclasses.replace(
        real_spec_for(*a), Rmax=8))
    rng = np.random.default_rng(11)
    cloud, origin = synthetic_scan(rng, n=30)
    far = origin + np.float32(MAX_RANGE * 0.95) / np.sqrt(3.0)
    cloud = np.concatenate([cloud, far[None, :]], axis=0)
    jm = jbgkl.BGKLOctoMap(ON)
    fallbacks = []
    jm._ingest_overflow_fallback = lambda *a: fallbacks.append(a)
    jm.insert_pointcloud(cloud.copy(), origin.copy(), max_range=MAX_RANGE)
    assert not fallbacks and jm._ingest_dims().get("Rmax", 0) > 8
    ours = _port(_t(ON))
    ours.insert_pointcloud(cloud, origin, max_range=MAX_RANGE)
    assert_bgk_matches(ours, jm)
    # the diagonal ray reaches blocks beyond 8 of its own
    diag = np.abs(ours.pool.coords[:ours.pool.n_blocks] - ours.pool.coords[0]).max()
    assert diag > 8


# ------------------------------------------------ carry-across

@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_carry_across(tmp_path, direction):
    scans = _scans(37, 3)
    first = jbgkl.BGKLOctoMap(BGKL_CFG) if direction == "jax_to_port" else _port()
    for cloud, origin in scans[:2]:
        first.insert_pointcloud(cloud.copy(), origin.copy(), max_range=MAX_RANGE)
    path = str(tmp_path / "map.npz")
    first.save(path)
    second = _port() if direction == "jax_to_port" else jbgkl.BGKLOctoMap(BGKL_CFG)
    second.load(path)
    assert_same_map(second, first, atol=0.0)
    for m in (first, second):
        m.insert_pointcloud(scans[2][0].copy(), scans[2][1].copy(), max_range=MAX_RANGE)
    assert_same_map(second, first, atol=5e-3)


# ------------------------------------------------ pipeline

@pytest.mark.parametrize("mode", ["off", "on"])
def test_run_static_matches_jax(tmp_path, mode):
    for i, (cloud, origin) in enumerate(_scans(38, 3), start=1):
        save_pcd(str(tmp_path / f"wall_{i}.pcd"), cloud, origin)
    kw = dict(name="wall", dir=str(tmp_path), prefix="wall", scan_num=3,
              max_range=MAX_RANGE)
    cfg = dataclasses.replace(BGKL_CFG, device_ingest=mode)
    res = pipeline.run_static(_t(cfg), DatasetConfig(**kw), device="cpu")
    jres = jpipe.run_static(cfg, JDatasetConfig(**kw))
    assert isinstance(res.map, bgkl.BGKLOctoMap) and res.map.stats["scans"] == 3
    if mode == "on":
        assert_bgk_matches(res.map, jres.map)
    else:
        assert_same_map(res.map, jres.map, atol=5e-3)
    ex = pipeline.export_leaves(res.map)
    assert len(ex["occupied"]["x"]) > 0 and len(ex["free"]["x"]) > 0


@pytest.mark.parametrize("mode", ["off", "on"])
def test_online_integrator_matches_jax(mode):
    """The server's motion gate and pre-downsample (on, as for BGK)."""
    scans = _scans(39, 3, n=120)
    scans.insert(1, (scans[0][0], scans[0][1] + np.float32(0.05)))  # gated out
    cfg = dataclasses.replace(BGKL_CFG, device_ingest=mode, max_range=MAX_RANGE)
    ours = pipeline.OnlineIntegrator(_port(_t(cfg)))
    ref = jpipe.OnlineIntegrator(jbgkl.BGKLOctoMap(cfg))
    assert ours.map.SERVER_DOWNSAMPLE
    for cloud, origin in scans:
        assert ours.offer(cloud, origin) == ref.offer(cloud.copy(), origin.copy())
    assert (ours.n_integrated, ours.n_skipped) == (3, 1)
    if mode == "on":
        assert_bgk_matches(ours.map, ref.map)
    else:
        assert_same_map(ours.map, ref.map, atol=5e-3)


def test_build_map_makes_a_bgkl_map():
    from la3dm_tpu_torch.utils.config import load_method_config

    for name in ("bgkl", "bgkloctomap_large_map"):
        m = pipeline.build_map(load_method_config(name), device="cpu")
        assert isinstance(m, bgkl.BGKLOctoMap) and m.GATE == 0.001 and m.SEGMENTS
