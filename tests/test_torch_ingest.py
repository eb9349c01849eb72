"""The PyTorch port's device-side scan ingest (K7, K1′) against the JAX
package's device ingest, on the CPU.

The JAX side runs with ``device_ingest="on"`` on the CPU, as
tests/test_device_ingest.py does; the port's with ``device_ingest="on"`` on a
CPU map, i.e. through the kernels' plain versions.  Scenes are that file's:
``synthetic_scan`` walls, seeds 0 and 5 (seed 5 puts a voxel full of sensor
origins on a block face), ``MAX_RANGE`` 6, 3 scans.  JAX gets copies of every
array (its steps donate their inputs and run asynchronously).

Tolerances: the K7 tables agree exactly on keys, block sets, counts and test
blocks; entry coordinates (centroids summed in another order: JAX's
Hillis–Steele tree, the port's sorted order) within ``CENTROID_TOL``, the
largest deviation seen being 1.24e-7 relative (3.6e-7 m; f32 ulps); K1′'s plain version
against JAX's ``_aligned_heavy`` within 1e-5 + 1e-5·|JAX| (the BGK heavy-pass
limit); BGK maps within 1e-5 + 1e-5·|JAX| on A/B with touched and eff equal
where the added mass exceeds 1e-5 (the k̄ > 0 gate's clamp boundary); GP maps
at the port's GP tolerance (tests/test_torch_gp.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from la3dm_tpu import pipeline as jpipe
from la3dm_tpu.geometry import device_ingest as jdi
from la3dm_tpu.models import bgk as jbgk, bgkl as jbgkl, bgklv as jbgklv, gp as jgp
from la3dm_tpu.utils.config import DatasetConfig as JDatasetConfig

from la3dm_tpu_torch import pipeline
from la3dm_tpu_torch.geometry import blocks as geo, device_ingest
from la3dm_tpu_torch.io.pcd import save_pcd
from la3dm_tpu_torch.kernels import (bgk_aligned_heavy, bgk_heavy, ingest_beams,
                                     ingest_keys, ingest_members, ingest_rays)
from la3dm_tpu_torch.models import bgk, bgkl, bgklv, gp
from la3dm_tpu_torch.utils.config import DatasetConfig, MapConfig

from tests.test_bgk_vs_oracle import CFG, synthetic_scan
from tests.test_families_vs_oracle import BGKL_CFG, GP_CFG, LV_CFG
from tests.test_torch_bgk import MASS_TOL, _pool
from tests.test_torch_gp import assert_matches_jax
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

MAX_RANGE = 6.0
#: entry coordinates, port against JAX: |Δ| ≤ CENTROID_TOL·(1 + |JAX|)
CENTROID_TOL = 1e-6
#: BGKL entries (occ = origin + ndir·l and the ray ends, from the
#: centroids), port against JAX: |Δ| ≤ ENTRY_TOL·(1 + |JAX|): the centroids'
#: largest deviation (1.24e-7) plus one f32 rounding (2^-23): XLA's CPU code
#: fuses origin + ndir·l into one rounding (a multiply-add), the port rounds
#: the product and the sum apart, as the parity rules ask; 1.58e-7 seen
ENTRY_TOL = 1.24e-7 + 2.0 ** -23

BGK_ON = dataclasses.replace(CFG, device_ingest="on")
GP_ON = dataclasses.replace(GP_CFG, device_ingest="on")


def _t(cfg):
    """The port's copy of a JAX MapConfig."""
    return MapConfig(**dataclasses.asdict(cfg))


def _scans(seed, k=3, n=90):
    rng = np.random.default_rng(seed)
    return [synthetic_scan(rng, n=n, origin=(0.1, -0.2 + 0.3 * i, 0.3)) for i in range(k)]


def _jax_insert(m, scans, **kw):
    m.insert_pointclouds([c.copy() for c, _ in scans], [o.copy() for _, o in scans], **kw)
    jax.block_until_ready(list(m.pool.fields.values()))


def _port_tables(cfg, scans, ds, fr, mr, free_label):
    """The port's K7 tables (plain versions) and the block anchors."""
    origins = np.stack([o for _, o in scans]).astype(np.float32)
    pts = np.concatenate([c for c, _ in scans]).astype(np.float32)
    scan = np.repeat(np.arange(len(scans), dtype=np.int32), [len(c) for c, _ in scans])
    banchor = device_ingest.anchors(origins, cfg.block_size)
    kf = device_ingest.beam_slots(ds, fr, mr, cfg.block_size)
    t = torch.from_numpy
    off = t(ingest_keys.pack_offsets(geo.FACE_NEIGHBOR_OFFSETS))
    tabs = device_ingest.ingest_batch(
        t(pts), t(scan), t(origins), t(device_ingest.anchors(origins, ds)), t(banchor), off,
        ds=ds, fr=fr, mr=mr, kf=kf, block_size=cfg.block_size, free_label=free_label)
    return tabs, banchor


def _jax_tables(cfg, scans, ds, fr, mr):
    """JAX ``ingest_batch`` on the same clouds, at the spec and batch padding
    its BGK (or BGKL) map dispatches with (so the executable is shared); no
    table of the scene overflows its pad (BGKL: no ray is cut at Rmax)."""
    cls = jbgkl.BGKLOctoMap if cfg.method == "bgkl" else jbgk.BGKOctoMap
    jm = cls(dataclasses.replace(cfg, device_ingest="on"))
    spec = jm._ingest_spec(ds, fr, mr, max(len(c) for c, _ in scans))
    K = len(scans)
    K_pad = 1 if K == 1 else jm.SCAN_BATCH
    cp = np.zeros((K_pad, spec.P, 3), np.float32)
    npts = np.zeros(K_pad, np.int32)
    op = np.zeros((K_pad, 3), np.float32)
    for s, (c, o) in enumerate(scans):
        cp[s, :len(c)] = c
        npts[s] = len(c)
        op[s] = o
    out = jdi.ingest_batch(jnp.asarray(cp), jnp.asarray(npts), jnp.asarray(op),
                           jm._off_keys_dev, spec)
    out = {k: np.asarray(v)[:K] for k, v in out.items()}
    assert (out["counts"][:, [0, 1, 3, 4, 5]]
            <= [spec.Ph, spec.Pf, spec.Bu, spec.T, spec.Rmax]).all()
    return out, spec


# ------------------------------------------------------------ K7 tables

@pytest.mark.parametrize("seed", [0, 5])
def test_k7_tables_match_jax(seed):
    """Global block sets, per-block entry counts and runs (labels equal,
    coordinates within CENTROID_TOL), test-block sets, and the slot maps,
    scan by scan."""
    scans = _scans(seed)
    cfg = CFG
    ds, fr = cfg.ds_resolution, cfg.free_resolution
    tabs, banchor = _port_tables(cfg, scans, ds, fr, MAX_RANGE, 0.0)
    out, _ = _jax_tables(cfg, scans, ds, fr, MAX_RANGE)
    pscan, pcoord = ingest_keys.unpack_np(tabs["ukey"].numpy(), banchor)
    tscan, tcoord = ingest_keys.unpack_np(tabs["tkey"].numpy(), banchor)
    ustart, ucount = tabs["ustart"].numpy(), tabs["ucount"].numpy()
    worst = 0.0
    for s in range(len(scans)):
        ok = out["ucount"][s] > 0
        jcoord = jdi.unpack_local_keys(out["ukey"][s][ok], out["bias"][s])
        mine = pscan == s
        np.testing.assert_array_equal(pcoord[mine], jcoord)
        np.testing.assert_array_equal(ucount[mine], out["ucount"][s][ok])
        tok = out["tkey"][s] != jdi._SENT
        np.testing.assert_array_equal(
            tcoord[tscan == s], jdi.unpack_local_keys(out["tkey"][s][tok], out["bias"][s]))
        # entry runs, block by block
        for a, b, c in zip(ustart[mine], out["ustart"][s][ok], ucount[mine]):
            pe, je = tabs["ent"][a:a + c].numpy(), out["ent"][s][b:b + c]
            np.testing.assert_array_equal(tabs["lab"][a:a + c].numpy(), out["lab"][s][b:b + c])
            worst = max(worst, float((np.abs(pe - je) / (1 + np.abs(je))).max()))
            np.testing.assert_allclose(tabs["ent_rel"][a:a + c].numpy(),
                                       out["ent_rel"][s][b:b + c], atol=2 * CENTROID_TOL)
        # slot maps: row of u − off_g among the test blocks, entry block of
        # t + off_g (or none), as positions within the scan
        u0, t0 = int(np.nonzero(mine)[0][0]), int(np.nonzero(tscan == s)[0][0])
        np.testing.assert_array_equal(tabs["nb_row"][mine].numpy() - t0,
                                      out["nb_row"][s][ok])
        U = len(ucount)
        tb = tabs["tb_u"][tscan == s].numpy()
        jtb = out["tb_u"][s][tok]
        np.testing.assert_array_equal(tb == U, jtb >= out["ukey"].shape[1])
        np.testing.assert_array_equal(tb[tb < U] - u0, jtb[jtb < out["ukey"].shape[1]])
    assert worst <= CENTROID_TOL


@pytest.mark.parametrize("seed", [0, 5])
def test_bgkl_k7_tables_match_jax(seed):
    """BGKL (K7a, K7b, K7d, K7c): per scan the entry-block set, the per-block
    entry counts and labels, the test blocks, and each ray's set of distinct
    blocks (from the port's pair list and, on the JAX side, from its ray
    entries) exactly equal; entries within ENTRY_TOL·(1 + |JAX|)."""
    scans = _scans(seed)
    cfg = BGKL_CFG
    ds, fr = cfg.ds_resolution, cfg.free_resolution
    origins = np.stack([o for _, o in scans]).astype(np.float32)
    pts = np.concatenate([c for c, _ in scans]).astype(np.float32)
    scan = np.repeat(np.arange(len(scans), dtype=np.int32), [len(c) for c, _ in scans])
    banchor = device_ingest.anchors(origins, cfg.block_size)
    kf = device_ingest.beam_slots(ds, fr, MAX_RANGE, cfg.block_size)
    t = torch.from_numpy
    tabs = device_ingest.ingest_batch_bgkl(
        t(pts), t(scan), t(origins), t(device_ingest.anchors(origins, ds)), t(banchor),
        t(ingest_keys.pack_offsets(geo.FACE_NEIGHBOR_OFFSETS)), ds=ds, fr=fr, mr=MAX_RANGE,
        kf=kf, block_size=cfg.block_size)
    out, _ = _jax_tables(cfg, scans, ds, fr, MAX_RANGE)
    assert tabs["ent"].shape[1] == tabs["ent_rel"].shape[1] == 6
    # the port's rays: its K7d call on the same hits (the pipeline's own)
    inv = float(np.float32(1.0 / ds))
    lim = float(np.float32((MAX_RANGE + np.sqrt(3.0) * ds) ** 2))
    keys = ingest_beams.point_keys(t(pts), t(scan), t(origins),
                                   t(device_ingest.anchors(origins, ds)), inv_leaf=inv, lim=lim)
    hkey, hits = device_ingest._downsample(t(pts), keys, t(device_ingest.anchors(origins, ds)),
                                           float(np.float32(ds)))
    _, seg, inr, pray, pkey, _ = ingest_rays.ray_pairs(
        hits, hkey, t(origins), t(banchor), kf=kf, mr=float(np.float32(MAX_RANGE)),
        fr=float(np.float32(fr)), block_size=cfg.block_size)
    rscan = (hkey >> 48).numpy()
    _, pcoords = ingest_keys.unpack_np(pkey.numpy(), banchor)
    ours_sets = {r: set() for r in range(len(hits))}
    for r, c in zip(pray.numpy(), pcoords):
        ours_sets[int(r)].add(tuple(c))
    jax_sets = {r: set() for r in range(len(hits))}

    pscan, pcoord = ingest_keys.unpack_np(tabs["ukey"].numpy(), banchor)
    tscan, tcoord = ingest_keys.unpack_np(tabs["tkey"].numpy(), banchor)
    ustart, ucount = tabs["ustart"].numpy(), tabs["ucount"].numpy()
    worst = 0.0
    seg_np = seg.numpy()
    for s in range(len(scans)):
        ok = out["ucount"][s] > 0
        jcoord = jdi.unpack_local_keys(out["ukey"][s][ok], out["bias"][s])
        mine = pscan == s
        np.testing.assert_array_equal(pcoord[mine], jcoord)
        np.testing.assert_array_equal(ucount[mine], out["ucount"][s][ok])
        tok = out["tkey"][s] != jdi._SENT
        np.testing.assert_array_equal(
            tcoord[tscan == s], jdi.unpack_local_keys(out["tkey"][s][tok], out["bias"][s]))
        rays_s = np.nonzero(rscan == s)[0]
        for a, b, c, bc in zip(ustart[mine], out["ustart"][s][ok], ucount[mine], jcoord):
            pe, je = tabs["ent"][a:a + c].numpy(), out["ent"][s][b:b + c]
            pl = tabs["lab"][a:a + c].numpy()
            np.testing.assert_array_equal(pl, out["lab"][s][b:b + c])
            worst = max(worst, float((np.abs(pe - je) / (1 + np.abs(je))).max()))
            # each JAX ray entry is the ray whose segment it matches
            for e in je[pl == 0]:
                dist = np.abs(seg_np[rays_s] - e).max(axis=1)
                r = rays_s[int(np.argmin(dist))]
                assert dist.min() <= 1e-5
                jax_sets[int(r)].add(tuple(bc))
    assert ours_sets == jax_sets
    assert sum(len(v) for v in ours_sets.values()) > 5 * len(hits) and inr.all()
    assert worst <= ENTRY_TOL, worst


def test_downsample_keeps_an_origin_on_a_block_face_exact():
    """Seed 5's case: a voxel full of copies of a sensor origin that sits on
    a block face (y = −0.2 with 0.4 m blocks) must average to the origin
    exactly (the compensated sum), so both blocks of the face keep it."""
    rng = np.random.default_rng(5)
    origin = np.float32([0.1, -0.2, 0.3])
    pts = np.concatenate([np.repeat(origin[None], 90, 0),
                          rng.uniform(-1, 1, (40, 3)).astype(np.float32)])
    ds = CFG.ds_resolution
    anchor = torch.from_numpy(device_ingest.anchors(origin[None], ds))
    scan = torch.zeros(len(pts), dtype=torch.int32)
    keys = ingest_beams.point_keys(torch.from_numpy(pts), scan, torch.from_numpy(origin[None]),
                                   anchor, inv_leaf=float(np.float32(1 / ds)), lim=100.0)
    ukey, cent = device_ingest._downsample(torch.from_numpy(pts), keys, anchor,
                                           float(np.float32(ds)))
    jc, jok, jn = jdi._downsample(jnp.asarray(pts), jnp.ones(len(pts), bool), ds, len(pts))
    jc = np.asarray(jc)[np.asarray(jok)]
    assert int(jn) == len(cent)
    np.testing.assert_allclose(cent.numpy(), jc, rtol=0, atol=CENTROID_TOL)
    at_origin = (cent.numpy() == origin).all(axis=1)
    assert at_origin.sum() == 1 and (jc == origin).all(axis=1).sum() == 1
    mcoord, mok = ingest_members.closed_box_memberships(
        cent[torch.from_numpy(at_origin)], torch.ones(1, dtype=torch.bool), CFG.block_size)
    assert int(mok.sum()) == 2  # the two blocks sharing the face


def test_far_outlier_does_not_poison_the_scan():
    """tests/test_device_ingest.py's far-outlier scene: the port's device
    path matches JAX's and the port's host path."""
    rng = np.random.default_rng(13)
    cloud, origin = synthetic_scan(rng, n=60)
    cloud = np.concatenate([cloud, np.float32([[-200.0, -200.0, -200.0]])], axis=0)
    jm = jbgk.BGKOctoMap(BGK_ON)
    jm.insert_pointcloud(cloud.copy(), origin.copy(), max_range=MAX_RANGE)
    on = bgk.BGKOctoMap(_t(BGK_ON), device="cpu")
    off = bgk.BGKOctoMap(_t(dataclasses.replace(CFG, device_ingest="off")), device="cpu")
    for m in (on, off):
        m.insert_pointcloud(cloud, origin, max_range=MAX_RANGE)
    assert on.pool.n_blocks > 0
    assert_bgk_matches(on, jm)
    assert_bgk_close(on, off)


# ------------------------------------------------------------ K1′

_jax_aligned_heavy = jax.jit(
    jbgk._aligned_heavy,
    static_argnames=("Wa", "chunk", "G", "sf2", "ell", "segments"))


@pytest.mark.parametrize("seed", [0, 5])
def test_aligned_heavy_plain_matches_jax(seed):
    """K1′'s plain version on the JAX ingest tables of one scan against JAX
    ``_aligned_heavy`` plus the ``u_targets`` gather: 1e-5 + 1e-5·|JAX|."""
    out, spec = _jax_tables(CFG, _scans(seed, k=1), CFG.ds_resolution,
                            CFG.free_resolution, MAX_RANGE)
    m = bgk.BGKOctoMap(_t(BGK_ON), device="cpu")
    ext = m._ext_nodes.numpy()
    G, Bu = m.num_slots, spec.Bu
    Vall = ext.shape[0] // G
    u_tgt, tb_rows = jdi.u_targets(jnp.asarray(out["urank_rows"]), jnp.asarray(out["tb_u"]),
                                   Bu, G)
    R2 = spec.R2
    chunk = next(c for c in (64, 32, 16, 8, 4, 2, 1) if R2 % c == 0)
    acc = _jax_aligned_heavy(jnp.zeros((Bu + 1, 2 * G * Vall), jnp.float32),
                             jnp.asarray(ext), jnp.asarray(out["ent_rel"][0]),
                             jnp.asarray(out["lab"][0]), jnp.asarray(out["vmask"][0]),
                             u_tgt, Wa=spec.Wa, chunk=chunk, G=G, sf2=CFG.sf2, ell=CFG.ell,
                             segments=False)
    acc4 = np.asarray(acc).reshape(Bu + 1, 2, G, Vall)
    rows = np.asarray(tb_rows)                                  # [T,G]
    ref = np.stack([acc4[rows, 0, np.arange(G)], acc4[rows, 1, np.arange(G)]], 2)  # [T,G,2,V]
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    ours = bgk_aligned_heavy.bgk_aligned_heavy(
        t(out["ent_rel"][0]), t(out["lab"][0]), t(out["ustart"][0].astype(np.int64)),
        t(out["ucount"][0].astype(np.int64)), t(out["tb_u"][0].astype(np.int64)),
        m._ext_nodes, G=G, sf2=CFG.sf2, ell=CFG.ell).numpy()       # [T,Vall,2G]
    tvalid = out["tkey"][0] != jdi._SENT
    ours = ours[tvalid].reshape(-1, Vall, 2, G).transpose(0, 3, 2, 1)   # [T,G,2,V]
    ref = ref[tvalid]
    assert (ref[:, :, 1] > 0).sum() > 1000
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_aligned_heavy_segment_plain_matches_jax(seed):
    """K1′'s segment branch (plain) on the JAX BGKL ingest tables of one scan
    against JAX ``_aligned_heavy(segments=True)`` plus the ``u_targets``
    gather: 1e-5 + 1e-5·|JAX|, and the 0.001 gate decided alike wherever k̄
    is not within 1e-5 of it."""
    out, spec = _jax_tables(BGKL_CFG, _scans(seed, k=1), BGKL_CFG.ds_resolution,
                            BGKL_CFG.free_resolution, MAX_RANGE)
    assert spec.segments and out["ent_rel"].shape[-1] == 6
    m = bgkl.BGKLOctoMap(_t(dataclasses.replace(BGKL_CFG, device_ingest="on")), device="cpu")
    ext = m._ext_nodes.numpy()
    G, Bu = m.num_slots, spec.Bu
    Vall = ext.shape[0] // G
    u_tgt, tb_rows = jdi.u_targets(jnp.asarray(out["urank_rows"]), jnp.asarray(out["tb_u"]),
                                   Bu, G)
    chunk = next(c for c in (64, 32, 16, 8, 4, 2, 1) if spec.R2 % c == 0)
    acc = _jax_aligned_heavy(jnp.zeros((Bu + 1, 2 * G * Vall), jnp.float32),
                             jnp.asarray(ext), jnp.asarray(out["ent_rel"][0]),
                             jnp.asarray(out["lab"][0]), jnp.asarray(out["vmask"][0]),
                             u_tgt, Wa=spec.Wa, chunk=chunk, G=G, sf2=BGKL_CFG.sf2,
                             ell=BGKL_CFG.ell, segments=True)
    acc4 = np.asarray(acc).reshape(Bu + 1, 2, G, Vall)
    rows = np.asarray(tb_rows)
    ref = np.stack([acc4[rows, 0, np.arange(G)], acc4[rows, 1, np.arange(G)]], 2)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    ours = bgk_aligned_heavy.bgk_aligned_heavy(
        t(out["ent_rel"][0]), t(out["lab"][0]), t(out["ustart"][0].astype(np.int64)),
        t(out["ucount"][0].astype(np.int64)), t(out["tb_u"][0].astype(np.int64)),
        m._ext_nodes, G=G, sf2=BGKL_CFG.sf2, ell=BGKL_CFG.ell).numpy()
    tvalid = out["tkey"][0] != jdi._SENT
    ours = ours[tvalid].reshape(-1, Vall, 2, G).transpose(0, 3, 2, 1)
    ref = ref[tvalid]
    assert (ref[:, :, 1] > 0).sum() > 1000
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    far = np.abs(ref[:, :, 1] - 0.001) > 1e-5
    np.testing.assert_array_equal((ours[:, :, 1] > 0.001)[far], (ref[:, :, 1] > 0.001)[far])


# ------------------------------------------------------------ BGK maps

def assert_bgk_matches(ours, ref, tol=1e-5):
    """Same blocks in the same slots, A/B within tol + tol·|ref|, touched and
    eff equal where the voxel's added mass exceeds MASS_TOL."""
    c1, f1, t1, e1 = _pool(ours)
    c2, f2, t2, e2 = _pool(ref)
    np.testing.assert_array_equal(c1, c2)
    mass = np.zeros(t1.shape, np.float32)
    for k, p in zip(("A", "B"), (CFG.prior_A, CFG.prior_B)):
        np.testing.assert_allclose(f1[k], f2[k], atol=tol, rtol=tol, err_msg=k)
        mass = np.maximum(mass, np.maximum(np.abs(f1[k] - p), np.abs(f2[k] - p)))
    away = mass > MASS_TOL
    assert away.sum() > 100
    np.testing.assert_array_equal(t1[away], t2[away])
    np.testing.assert_array_equal(e1[away], e2[away])


def _voxels(m):
    """{block coord: (fields, touched)}: maps whose slots differ in order."""
    c, f, t, _ = _pool(m)
    return {tuple(x): ({k: v[i] for k, v in f.items()}, t[i]) for i, x in enumerate(c)}


def assert_bgk_close(on, off):
    """JAX's own device-vs-host tolerance (tests/test_device_ingest.py:75-77)."""
    vo, vf = _voxels(on), _voxels(off)
    assert set(vo) == set(vf)
    for c in vo:
        for k in vo[c][0]:
            np.testing.assert_allclose(vo[c][0][k], vf[c][0][k], atol=1e-4, rtol=1e-4,
                                       err_msg=f"{c} {k}")


@pytest.mark.parametrize("seed", [0, 5])
def test_bgk_insert_pointclouds_matches_jax(seed):
    scans = _scans(seed)
    jm = jbgk.BGKOctoMap(BGK_ON)
    _jax_insert(jm, scans, max_range=MAX_RANGE)
    ours = bgk.BGKOctoMap(_t(BGK_ON), device="cpu")
    ours.insert_pointclouds([c for c, _ in scans], [o for _, o in scans], max_range=MAX_RANGE)
    assert ours.stats["scans"] == 3 and ours.stats["ingest_host_chunks"] == 0
    assert ours.stats["kernel_evals"] == jm.stats["kernel_evals"]
    assert_bgk_matches(ours, jm)


@pytest.mark.parametrize("seed", [0, 5])
def test_bgk_insert_pointcloud_matches_jax(seed):
    """K = 1 dispatches, scan after scan."""
    jm = jbgk.BGKOctoMap(BGK_ON)
    ours = bgk.BGKOctoMap(_t(BGK_ON), device="cpu")
    for cloud, origin in _scans(seed):
        jm.insert_pointcloud(cloud.copy(), origin.copy(), max_range=MAX_RANGE)
        ours.insert_pointcloud(cloud, origin, max_range=MAX_RANGE)
    assert_bgk_matches(ours, jm)


@pytest.mark.parametrize("seed", [0, 5])
def test_bgk_device_ingest_matches_host_ingest(seed):
    scans = _scans(seed)
    on = bgk.BGKOctoMap(_t(BGK_ON), device="cpu")
    off = bgk.BGKOctoMap(_t(dataclasses.replace(CFG, device_ingest="off")), device="cpu")
    for m in (on, off):
        m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans],
                             max_range=MAX_RANGE)
    assert_bgk_close(on, off)


def test_device_ingest_chunks_equal_one_dispatch(monkeypatch):
    """Dispatches of ≤ SCAN_BATCH scans resume from the pool state as one
    dispatch would (same tables, light pass scan by scan)."""
    scans = _scans(3, k=5)
    one = bgk.BGKOctoMap(_t(BGK_ON), device="cpu")
    one.insert_pointclouds([c for c, _ in scans], [o for _, o in scans], max_range=MAX_RANGE)
    calls = []
    orig = bgk._bgk_seq_step_aligned
    monkeypatch.setattr(bgk, "_bgk_seq_step_aligned",
                        lambda *a, **k: (calls.append(len(a[12])), orig(*a, **k)))
    monkeypatch.setattr(bgk.BGKOctoMap, "SCAN_BATCH", 2)
    many = bgk.BGKOctoMap(_t(BGK_ON), device="cpu")
    many.insert_pointclouds([c for c, _ in scans], [o for _, o in scans], max_range=MAX_RANGE)
    assert calls == [2, 2, 1]
    vo, vm = _voxels(one), _voxels(many)
    assert set(vo) == set(vm)
    for c in vo:
        for k in vo[c][0]:
            np.testing.assert_allclose(vo[c][0][k], vm[c][0][k], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(vo[c][1], vm[c][1])


# ------------------------------------------------------------ GP maps

@pytest.mark.parametrize("seed", [0, 5])
def test_gp_insert_pointclouds_matches_jax(seed):
    """Port on against JAX on at the port's GP tolerance; port on against
    port off on the occupancy probability (tests/test_device_ingest.py:
    70-73)."""
    scans = _scans(seed)
    jm = jgp.GPOctoMap(GP_ON)
    _jax_insert(jm, scans, max_range=MAX_RANGE)
    ours = gp.GPOctoMap(_t(GP_ON), device="cpu")
    ours.insert_pointclouds([c for c, _ in scans], [o for _, o in scans], max_range=MAX_RANGE)
    assert ours.stats["ingest_host_chunks"] == 0 and ours.stats["heavy_tiers"] == 1
    assert int(ours.failed_models) == 0
    assert_matches_jax(ours, jm)
    off = gp.GPOctoMap(_t(dataclasses.replace(GP_CFG, device_ingest="off")), device="cpu")
    off.insert_pointclouds([c for c, _ in scans], [o for _, o in scans], max_range=MAX_RANGE)
    vo, vf = _voxels(ours), _voxels(off)
    assert set(vo) == set(vf)
    max_ivar = 1.0 / GP_CFG.min_var
    for c in vo:
        p = [1.0 / (1.0 + np.exp(-GP_CFG.l * v[c][0]["m_ivar"] / max_ivar)) for v in (vo, vf)]
        np.testing.assert_allclose(p[0], p[1], atol=1e-3, err_msg=f"{c} prob")


def test_gp_insert_pointcloud_matches_jax():
    jm = jgp.GPOctoMap(GP_ON)
    ours = gp.GPOctoMap(_t(GP_ON), device="cpu")
    for cloud, origin in _scans(0, k=2):
        jm.insert_pointcloud(cloud.copy(), origin.copy(), max_range=MAX_RANGE)
        ours.insert_pointcloud(cloud, origin, max_range=MAX_RANGE)
    assert ours.stats["heavy_tiers"] == 2
    assert_matches_jax(ours, jm)


# ------------------------------------------------------------ pipeline

@pytest.mark.parametrize("family", ["bgk", "gp"])
def test_run_static_matches_jax(tmp_path, family):
    for i, (cloud, origin) in enumerate(_scans(21), start=1):
        save_pcd(str(tmp_path / f"wall_{i}.pcd"), cloud, origin)
    kw = dict(name="wall", dir=str(tmp_path), prefix="wall", scan_num=3, max_range=MAX_RANGE)
    cfg = BGK_ON if family == "bgk" else GP_ON
    bgk_aligned_heavy.launches = bgk_heavy.launches = 0
    res = pipeline.run_static(_t(cfg), DatasetConfig(**kw), device="cpu")
    jres = jpipe.run_static(cfg, JDatasetConfig(**kw))
    assert bgk_aligned_heavy.launches == bgk_heavy.launches == 0   # CPU: plain versions
    assert res.map.stats["scans"] == 3 and res.map.stats["ingest_host_chunks"] == 0
    if family == "bgk":
        assert_bgk_matches(res.map, jres.map)
    else:
        assert_matches_jax(res.map, jres.map)


@pytest.mark.parametrize("family", ["bgk", "gp"])
def test_online_integrator_matches_jax(family):
    """K = 1 dispatches behind the server's motion gate and downsample."""
    scans = _scans(22, n=120)
    scans.insert(1, (scans[0][0], scans[0][1] + np.float32(0.05)))  # gated out
    cfg = dataclasses.replace(BGK_ON if family == "bgk" else GP_ON, max_range=MAX_RANGE)
    cls, jcls = (bgk.BGKOctoMap, jbgk.BGKOctoMap) if family == "bgk" else \
        (gp.GPOctoMap, jgp.GPOctoMap)
    ours = pipeline.OnlineIntegrator(cls(_t(cfg), device="cpu"))
    ref = jpipe.OnlineIntegrator(jcls(cfg))
    for cloud, origin in scans:
        assert ours.offer(cloud, origin) == ref.offer(cloud.copy(), origin.copy())
    assert (ours.n_integrated, ours.n_skipped) == (3, 1)
    assert ours.map.stats["ingest_host_chunks"] == 0
    if family == "bgk":
        assert_bgk_matches(ours.map, ref.map)
    else:
        assert_matches_jax(ours.map, ref.map)


# ------------------------------------------------------------ switches

def test_unbounded_config_takes_the_host_path():
    """max_range ≤ 0 cannot bound the beams: the host path integrates the
    scans and counts the chunks."""
    scans = _scans(7, k=2, n=40)
    cfg = dataclasses.replace(BGK_ON, max_range=-1.0)
    m = bgk.BGKOctoMap(_t(cfg), device="cpu")
    m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans])
    m.insert_pointcloud(*scans[0])
    assert m.stats["ingest_host_chunks"] == 2 and m.pool.n_blocks > 0
    jm = jbgk.BGKOctoMap(cfg)
    _jax_insert(jm, scans)
    jm.insert_pointcloud(scans[0][0].copy(), scans[0][1].copy())
    assert_bgk_matches(m, jm, tol=2e-3)


def test_auto_is_off_on_a_cpu_map(monkeypatch):
    m = gp.GPOctoMap(_t(dataclasses.replace(GP_CFG, device_ingest="auto")), device="cpu")
    assert not m._ingest_enabled()
    calls = []
    monkeypatch.setattr(device_ingest, "ingest_batch", lambda *a, **k: calls.append(a))
    m.insert_pointcloud(*_scans(8, k=1, n=40)[0], max_range=MAX_RANGE)
    assert not calls and m.pool.n_blocks > 0
    on = bgk.BGKOctoMap(_t(BGK_ON), device="cpu")
    assert on._ingest_enabled()
    on._capture_step_args = True                     # the capture keeps the host path
    assert not on._ingest_enabled()


def test_bgklv_accepts_device_ingest_on():
    """Neither package's LV map reads the flag: both build and fill a map."""
    cfg = dataclasses.replace(LV_CFG, device_ingest="on")
    cloud, origin = _scans(9, k=1, n=60)[0]
    jm = jbgklv.BGKLVOctoMap(cfg)
    jm.insert_pointcloud(cloud.copy(), origin.copy(), max_range=MAX_RANGE)
    ours = bgklv.BGKLVOctoMap(_t(cfg), device="cpu")
    ours.insert_pointcloud(cloud, origin, max_range=MAX_RANGE)
    assert ours.pool.n_blocks == jm.pool.n_blocks > 0
    assert int(ours.pool.touched.sum()) == int(np.asarray(jm.pool.touched).sum()) > 0
