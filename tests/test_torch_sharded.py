"""The PyTorch port's sharded pool and maps (la3dm_tpu_torch/parallel/) on
the CPU, against the JAX package's and against the port's unsharded maps.

* Placement: seeded ``ensure`` sequences (weighted, unweighted, with keys
  repeated inside a call) through growth and ``rebalance`` give the port's
  ``ShardedBlockPool`` the JAX pool's key → slot map, ``dev_load`` (bit for
  bit), resident counts, generation and capacity (8 shards against
  ``block_mesh(8)`` over the 8 virtual CPU devices of tests/conftest.py).
* Each family's 8-shard map against JAX's 8-device sharded map on the 80-point
  walls of tests/test_sharded.py: the same blocks in the same slots, and the
  voxels within the tolerances of tests/test_torch_{bgk,bgkl,bgklv}.py
  (BGK and BGKL A/B within 5e-3, BGKLV within 1e-5 + 1e-5·|JAX|; touched and
  eff equal where a voxel's added mass exceeds 1e-5) and, for GP, in
  posterior space as tests/test_sharded.py:44-54 (p within 1e-3, σ² within
  1e-3 + 1e-3·|JAX|).
* The port sharded against the port unsharded, keyed by block coordinates:
  bit for bit for BGK, BGKL and BGKLV on the host path and for BGK and BGKL
  on device ingest, through growth from ``capacity=16`` inside one batched
  insert and ``rebalance()`` (the LPT bound checked); GP in posterior space
  as above, because its plain heavy pass (kernels/gp_heavy.py::
  gp_heavy_plain) runs LAPACK's Cholesky and triangular solves on models
  padded to the call's largest model, so a shard's call rounds them apart
  from the whole dispatch's (on the card K4 sums each model alike whatever
  the call holds, and chip_smoke.py holds GP bit for bit there).  Reads:
  ``search``, ``leaves``, ``save`` → ``load`` and ``raycast_device`` (the plain
  K6).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from la3dm_tpu.models import bgk as jbgk, bgklv as jlv, gp as jgp
from la3dm_tpu.parallel import mesh as jpm, sharded_map as jsm

from la3dm_tpu_torch import entry
from la3dm_tpu_torch.models import bgk, bgkl, bgklv, gp, raycast as rc
from la3dm_tpu_torch.parallel import mesh as pm, sharded_map as sm
from la3dm_tpu_torch.utils.config import MapConfig

from tests.test_bgk_vs_oracle import CFG, synthetic_scan
from tests.test_families_vs_oracle import BGKL_CFG, GP_CFG, LV_CFG
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

MASS_TOL = 1e-5
N_SHARDS = 8
#: family → (unsharded port class, sharded port class, JAX sharded class,
#: JAX config)
FAMILIES = {
    "bgk": (bgk.BGKOctoMap, sm.ShardedBGKOctoMap, jsm.ShardedBGKOctoMap, CFG),
    "bgkl": (bgkl.BGKLOctoMap, sm.ShardedBGKLOctoMap, jsm.ShardedBGKLOctoMap, BGKL_CFG),
    "bgklv": (bgklv.BGKLVOctoMap, sm.ShardedBGKLVOctoMap, jsm.ShardedBGKLVOctoMap, LV_CFG),
    "gp": (gp.GPOctoMap, sm.ShardedGPOctoMap, jsm.ShardedGPOctoMap, GP_CFG),
}


def _seed_jax_pads():
    """Pads of the JAX sharded engines, large enough for every scan here,
    so that each config compiles once (tests/multihost_worker.py)."""
    for name, cfg in (("ShardedBGKOctoMap", CFG), ("ShardedBGKLOctoMap", BGKL_CFG)):
        jbgk._GLOBAL_PADS.setdefault(
            (name, cfg), {"N": 1024, "F": 4096, "R": jbgk._CHUNK, "T": 256, "B": 256})
    for single in (True, False):
        jlv._GLOBAL_PADS.setdefault(("ShardedBGKLVOctoMap", LV_CFG, single),
                                    {"E": 8192, "F": 65536, "R": 2048, "T": 2048})
    jgp._GLOBAL_PADS.setdefault(
        ("ShardedGPOctoMap", GP_CFG),
        {"N": 8192, "T": 2048, "B": 1024, "tiers": {128: {"M": 512}, 256: {"M": 64},
                                                    512: {"M": 64}}})


_seed_jax_pads()


def port_cfg(cfg, **kw) -> MapConfig:
    return dataclasses.replace(MapConfig(**dataclasses.asdict(cfg)), **kw)


def wall_scans(seed=42, k=2, n=80):
    """tests/test_sharded.py's scans: 80-point walls from origins 0.3 m apart."""
    rng = np.random.default_rng(seed)
    return [synthetic_scan(rng, n=n, origin=(0.1, -0.2 + 0.3 * i, 0.3)) for i in range(k)]


def keyed(m):
    """(slots, coords, fields, touched, eff) of a map of either package, its
    blocks in coordinate order, voxels in raster order."""
    slots = np.asarray(m.pool.active_slots())
    coords = m.pool.coords[slots]
    order = np.lexsort((coords[:, 2], coords[:, 1], coords[:, 0]))
    slots, coords = slots[order], coords[order]
    fields = {k: np.asarray(m._gather_rows(v, slots)) for k, v in m.pool.fields.items()}
    return (slots, coords, fields, np.asarray(m._gather_rows(m.pool.touched, slots)),
            np.asarray(m._gather_rows(m.pool.eff_level, slots)))


def assert_bits(ours, ref):
    """The same blocks; every field, touched and eff bit for bit."""
    _, c1, f1, t1, e1 = keyed(ours)
    _, c2, f2, t2, e2 = keyed(ref)
    np.testing.assert_array_equal(c1, c2)
    for k in f1:
        np.testing.assert_array_equal(f1[k].view(np.int32), f2[k].view(np.int32), err_msg=k)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(e1, e2)
    assert t1.sum() > 100


def gp_posterior(cfg, f):
    p = 1.0 / (1.0 + np.exp(-cfg.l * f["m_ivar"] / (1.0 / cfg.min_var)))
    return p, 1.0 / f["ivar"]


def assert_close(family, ours, ref, cfg):
    """The family's tolerance (module docstring), keyed by coordinates."""
    _, c1, f1, t1, e1 = keyed(ours)
    _, c2, f2, t2, e2 = keyed(ref)
    np.testing.assert_array_equal(c1, c2)
    if family == "gp":
        (p1, v1), (p2, v2) = gp_posterior(cfg, f1), gp_posterior(cfg, f2)
        np.testing.assert_allclose(p1, p2, atol=1e-3, rtol=0, err_msg="prob")
        np.testing.assert_allclose(v1, v2, atol=1e-3, rtol=1e-3, err_msg="var")
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(e1, e2)
        assert t1.sum() > 100
        return
    atol, rtol = (1e-5, 1e-5) if family == "bgklv" else (5e-3, 0.0)
    mass = np.zeros(t1.shape, np.float32)
    for k, p in (("A", cfg.prior_A), ("B", cfg.prior_B)):
        np.testing.assert_allclose(f1[k], f2[k], atol=atol, rtol=rtol, err_msg=k)
        mass = np.maximum(mass, np.maximum(np.abs(f1[k] - p), np.abs(f2[k] - p)))
    away = mass > MASS_TOL
    assert away.sum() > 100
    np.testing.assert_array_equal(t1[away], t2[away])
    np.testing.assert_array_equal(e1[away], e2[away])


def assert_lpt_bound(m):
    """Per-shard touched voxels within max ≤ mean + the heaviest block."""
    block = m.pool.touched.sum(dim=1, dtype=torch.float64).numpy()
    per = block.reshape(m.pool.n_shards, -1).sum(axis=1)
    assert per.max() <= per.mean() + block.max() + 1e-9


# ------------------------------------------------------------------ placement

def _ensure_steps(seed):
    """A seeded sequence of (coords, weights or None) and rebalance steps
    (None) over a few hundred blocks, with repeats inside and across calls."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(7):
        if i == 4:
            steps.append(None)
            continue
        coords = rng.integers(-6, 6, (int(rng.integers(20, 90)), 3))
        coords = np.concatenate([coords, coords[:5]])            # repeated keys
        kind = (seed + i) % 3
        w = (None if kind == 0 else rng.integers(0, 40, len(coords)) if kind == 1
             else rng.uniform(0.0, 10.0, len(coords)).round(1))
        steps.append((coords, w))
    return steps


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_placement_matches_jax(seed):
    """Every ensure and rebalance places as the JAX pool does, and the
    relayouts move each block's rows with it."""
    assert len(jax.devices()) >= N_SHARDS
    jpool = jsm.ShardedBlockPool(8, {"A": 0.5}, 16, jpm.block_mesh(N_SHARDS))
    pool = sm.ShardedBlockPool(8, {"A": 0.5}, 16, pm.block_mesh(N_SHARDS, "cpu"))
    rng = np.random.default_rng(100 + seed)
    mark = {}
    for step in _ensure_steps(seed):
        if step is None:
            load = rng.integers(0, 50, pool.capacity).astype(np.float64)
            jpool.rebalance(load)
            pool.rebalance(load)
        else:
            coords, w = step
            js = jpool.ensure(coords, weights=w)
            ps = pool.ensure(coords, weights=w)
            np.testing.assert_array_equal(ps, js)
            for c, s in zip(map(tuple, coords), ps):    # tag each new block's row
                if c not in mark:
                    mark[c] = float(len(mark) + 1)
                    pool.fields["A"][int(s)] = mark[c]
        keys = np.asarray(list(jpool._slot_of), np.int64)
        np.testing.assert_array_equal(pool.lookup(jpool.coords[jpool.active_slots()]),
                                      jpool.active_slots())
        np.testing.assert_array_equal(pool.active_slots(), jpool.active_slots())
        assert len(keys) == pool.n_blocks == jpool.n_blocks
        np.testing.assert_array_equal(pool.dev_load, jpool.dev_load)
        np.testing.assert_array_equal(pool._dev_count, jpool._dev_count)
        assert (pool.generation, pool.capacity, pool.chunk) == \
            (jpool.generation, jpool.capacity, jpool.chunk)
        slots = pool.active_slots()
        rows = pool.fields["A"][torch.as_tensor(slots, dtype=torch.long), 0].numpy()
        want = [mark[tuple(c)] for c in pool.coords[slots]]
        np.testing.assert_array_equal(rows, want)
    assert pool.generation >= 2 and pool.capacity > 16


def test_mesh_and_device_rules():
    """Shard bookkeeping, and a map on the mesh's device only (no map
    without a device where CUDA is absent: tests/test_torch_package.py)."""
    mesh = pm.ShardMesh(torch.device("cpu"), shards_per_rank=3, rank=1, world=2)
    assert mesh.n_shards == 6 and list(mesh.local_shards()) == [3, 4, 5]
    assert not mesh.distributed
    with pytest.raises(ValueError):
        pm.ShardMesh(torch.device("cpu"), shards_per_rank=2, rank=2, world=2)
    m = sm.ShardedBGKOctoMap(port_cfg(CFG), mesh=pm.block_mesh(4, "cpu"), capacity=10)
    assert (m.pool.capacity, m.pool.chunk, m.pool.shard_rows) == (12, 3, 3)
    assert m.pool.fields["A"].shape == (12, m.V)
    with pytest.raises(ValueError):
        sm.ShardedBGKOctoMap(port_cfg(CFG), mesh=pm.block_mesh(4, "cpu"), device="meta")


# ------------------------------------------------- port against JAX, 8 shards

@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's 8-device sharded maps of the four families on the two walls,
    built once."""
    out = {}
    for fam, (_, _, jcls, cfg) in FAMILIES.items():
        m = jcls(cfg, mesh=jpm.block_mesh(N_SHARDS), capacity=2048)
        for cloud, origin in wall_scans():
            m.insert_pointcloud(cloud, origin)
        out[fam] = m
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_matches_jax_sharded(family, jax_sharded):
    _, cls, _, cfg = FAMILIES[family]
    ours = cls(port_cfg(cfg), mesh=pm.block_mesh(N_SHARDS, "cpu"), capacity=2048)
    for cloud, origin in wall_scans():
        ours.insert_pointcloud(cloud, origin)
    ref = jax_sharded[family]
    # the same placement: every block in the JAX map's slot
    np.testing.assert_array_equal(keyed(ours)[0], keyed(ref)[0])
    np.testing.assert_array_equal(ours.pool.dev_load, ref.pool.dev_load)
    assert len({int(s) // ours.pool.chunk for s in ours.pool.active_slots()}) == N_SHARDS
    assert_close(family, ours, ref, cfg)


# ----------------------------------------------- port sharded against unsharded

CASES = [("bgk", "off"), ("bgk", "on"), ("bgkl", "off"), ("bgkl", "on"),
         ("bgklv", "off"), ("gp", "off"), ("gp", "on")]


@pytest.mark.parametrize("family,ingest", CASES)
def test_sharded_equals_unsharded(family, ingest):
    """Growth inside one batched insert (the slots of the earlier scans
    re-resolved), then rebalance between inserts: the same map as the
    unsharded port's."""
    ucls, cls, _, cfg = FAMILIES[family]
    cfg = port_cfg(cfg, device_ingest=ingest)
    scans = wall_scans(seed=7, k=3)
    ref = ucls(cfg, device="cpu")
    ours = cls(cfg, mesh=pm.block_mesh(N_SHARDS, "cpu"), capacity=16)
    for m in (ref, ours):
        m.insert_pointclouds([c for c, _ in scans[:2]], [o for _, o in scans[:2]])
    assert ours.pool.capacity > 16 and ours.pool.generation >= 1
    gen = ours.pool.generation
    ours.rebalance()
    assert ours.pool.generation == gen + 1
    assert_lpt_bound(ours)
    for m in (ref, ours):
        m.insert_pointcloud(*scans[2])
    if family == "gp":
        assert_close(family, ours, ref, cfg)
        assert int(ours.failed_models) == int(ref.failed_models) == 0
    else:
        assert_bits(ours, ref)
    for k in ("kernel_evals", "scans"):
        assert ours.stats[k] == ref.stats[k]


@pytest.mark.parametrize("family", ["bgk", "bgklv", "gp"])
def test_reads_match_unsharded(family, tmp_path):
    """search, leaves, save → load (into a sharded and an unsharded map) and
    raycast_device read a sharded map as the unsharded one."""
    ucls, cls, _, cfg = FAMILIES[family]
    cfg = port_cfg(cfg)
    scans = wall_scans(seed=11, k=2)
    ref = ucls(cfg, device="cpu")
    ours = cls(cfg, mesh=pm.block_mesh(4, "cpu"), capacity=64)
    for m in (ref, ours):
        m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans])
    exact = family != "gp"
    pts = np.concatenate([scans[0][0][:40], scans[0][0][:20] - 0.3,
                          np.array([[40.0, 40.0, 40.0]], np.float32)])
    a, b = ours.search(pts), ref.search(pts)
    np.testing.assert_array_equal(a["state"], b["state"])
    np.testing.assert_array_equal(a["touched"], b["touched"])
    for k in a:
        if exact:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    la, lb = ours.leaves(), ref.leaves()
    oa = np.lexsort((la["z"], la["y"], la["x"]))
    ob = np.lexsort((lb["z"], lb["y"], lb["x"]))
    for k in ("x", "y", "z", "size"):
        np.testing.assert_array_equal(la[k][oa], lb[k][ob], err_msg=k)
    if exact:
        for k in la:
            np.testing.assert_array_equal(la[k][oa], lb[k][ob], err_msg=k)

    path = str(tmp_path / "sharded.npz")
    ours.save(path)
    back = cls(cfg, mesh=pm.block_mesh(4, "cpu"), capacity=16)
    back.load(path)
    assert_bits(back, ours)
    plain = ucls(cfg, device="cpu")
    plain.load(path)
    assert_bits(plain, ours)

    if family != "gp":
        rng = np.random.default_rng(3)
        origins = np.repeat(np.array([[0.1, -0.2, 0.3]], np.float32), 400, axis=0)
        dirs = rng.normal(size=(400, 3)) + np.array([3.0, 0.0, 0.5])
        ra = rc.raycast_device(ours, origins, dirs, 6.0)
        rb = rc.raycast_device(ref, origins, dirs, 6.0)
        assert ra["hit"].sum() > 50
        for k in ("hit", "distance", "steps"):
            np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)


def test_dryrun_multichip_on_the_cpu(capsys):
    loads = entry.dryrun_multichip(4, device="cpu")
    assert set(loads) == {"ShardedBGKOctoMap", "ShardedBGKLOctoMap",
                          "ShardedBGKLVOctoMap", "ShardedGPOctoMap"}
    out = capsys.readouterr().out
    for name, load in loads.items():
        assert len(load) == 4 and sum(load) > 0
        assert f"placement skew {name}" in out
