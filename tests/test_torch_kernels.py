"""The port's kernel modules against their JAX counterparts, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
CUDA kernels themselves run only on a card: tests/test_torch_cuda.py holds
them against their plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from la3dm_tpu.geometry import blocks as jgeo, device_ingest as jdi
from la3dm_tpu.kernels import gp as jgpk, math as jkm, predict as jkp
from la3dm_tpu.models import (bgk as jbgk, bgklv as jlv, gp as jgp, posterior as jpo,
                              pruning as jpr)

from la3dm_tpu_torch.geometry import blocks as geo, device_ingest
from la3dm_tpu_torch.kernels import (bgk_aligned_heavy, bgk_heavy, bgk_light, gp as kgp,
                                     gp_heavy, gp_light, ingest_beams, ingest_downsample,
                                     ingest_keys, ingest_members, ingest_rays, ingest_sort,
                                     lv_prune, lv_rows, math as km, predict as kp,
                                     raycast as k6)
from la3dm_tpu_torch.models import posterior as po, pruning as pr

from torch_cases import (GP_BCM, GP_STATE, GP_STATICS, INGEST, LV_ROWS_STATICS,  # noqa: F401
                         LV_STATE, aligned_heavy_inputs, gp_heavy_inputs, gp_light_inputs,
                         heavy_inputs as _heavy_inputs, ingest_scene,
                         light_inputs as _light_inputs, lv_prune_inputs, lv_rows_inputs,
                         member_entries, one_torch_thread, ray_inputs,  # (one_torch_thread: autouse fixture)
                         raycast_inputs)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------- math, predict

@pytest.mark.parametrize("ell", [0.2, 0.5])
def test_cov_sparse_matches_jax(ell):
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.4, 0.4, (73, 3)).astype(np.float32)
    z = rng.uniform(-0.6, 0.6, (64, 3)).astype(np.float32)
    ours = km.cov_sparse(_t(x), _t(z), 1.0, ell).numpy()
    ref = np.asarray(jkm.cov_sparse(jnp.asarray(x), jnp.asarray(z), 1.0, ell))
    assert ours.shape == ref.shape == (73, 64)
    assert (ref == 0).any() and (ref > 0).any()   # both sides of the clamp
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(km.pairwise_dist(_t(x), _t(z)).numpy(),
                               np.asarray(jkm.pairwise_dist(jnp.asarray(x), jnp.asarray(z))),
                               atol=1e-6, rtol=0)


def test_cov_sparse_batched_equals_unbatched():
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.4, 0.4, (3, 9, 3)).astype(np.float32)
    z = rng.uniform(-0.4, 0.4, (3, 5, 3)).astype(np.float32)
    batched = km.cov_sparse(_t(x), _t(z), 1.0, 0.2)
    for b in range(3):
        assert torch.equal(batched[b], km.cov_sparse(_t(x[b]), _t(z[b]), 1.0, 0.2))


def test_slot_rhs_matches_jax():
    rng = np.random.default_rng(3)
    labels = (rng.uniform(size=64) > 0.5).astype(np.float32)
    slots = rng.integers(0, 7, 64).astype(np.int8)
    valid = rng.uniform(size=64) > 0.2
    ours = kp._slot_rhs(_t(labels), _t(slots), _t(valid), 7).numpy()
    ref = np.asarray(jkp._slot_rhs(jnp.asarray(labels), jnp.asarray(slots),
                                   jnp.asarray(valid), 7))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("gate", [0.0, 0.001])
def test_beta_update_matches_jax(gate):
    rng = np.random.default_rng(4)
    kbar = rng.uniform(-0.2, 2.0, (40, 73, 7)).astype(np.float32)
    kbar[rng.uniform(size=kbar.shape) < 0.3] = 0.0
    ybar = (kbar * rng.uniform(0, 1, kbar.shape)).astype(np.float32)
    dA, dB, tch = kp.beta_update(_t(ybar), _t(kbar), gate)
    rA, rB, rt = jkp.beta_update(jnp.asarray(ybar), jnp.asarray(kbar), gate)
    np.testing.assert_allclose(dA.numpy(), np.asarray(rA), atol=1e-6, rtol=0)
    np.testing.assert_allclose(dB.numpy(), np.asarray(rB), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tch.numpy(), np.asarray(rt))


# -------------------------------------------------------- posterior, pruning

def _prune_inputs(seed, B=24, n=4):
    """Pool rows whose states sit far from every threshold: each 2³ group
    takes one of three (A, B) templates (occupied, free, unknown), a few
    voxels another, with small noise so that collapse copies are visible."""
    rng = np.random.default_rng(seed)
    tmpl = np.array([[5.0, 0.5], [0.5, 5.0], [1.0, 1.0]], np.float32)
    grp = rng.integers(0, 3, (B, n // 2, n // 2, n // 2))
    mixed = np.ones(B, bool)
    if seed % 2:  # whole blocks of one known state: collapses reach level 2
        grp[: B // 2] = rng.integers(0, 2, (B // 2, 1, 1, 1))
        mixed[: B // 2] = False
    vox = grp.repeat(2, 1).repeat(2, 2).repeat(2, 3).reshape(B, -1)  # z,y,x raster
    mix = (rng.uniform(size=vox.shape) < 0.03) & mixed[:, None]
    vox = np.where(mix, rng.integers(0, 3, vox.shape), vox)
    noise = rng.uniform(0.95, 1.05, (B, n ** 3, 2)).astype(np.float32)
    AB = tmpl[vox] * noise
    touched = (rng.uniform(size=vox.shape) > 0.05) | ~mixed[:, None]
    eff = np.zeros(vox.shape, np.int8)
    eff[:3, :8] = 1   # blocks whose first voxels claim a level-1 leaf
    return AB[..., 0].copy(), AB[..., 1].copy(), touched, eff


def test_beta_state_matches_jax():
    A, B, touched, _ = _prune_inputs(0)
    ours = po.beta_state(_t(A), _t(B), _t(touched), 0.05, 0.3, 0.7).numpy()
    ref = np.asarray(jpo.beta_state(jnp.asarray(A), jnp.asarray(B),
                                    jnp.asarray(touched), 0.05, 0.3, 0.7))
    np.testing.assert_array_equal(ours, ref)
    assert set(np.unique(ours)) == {po.FREE, po.OCCUPIED, po.UNKNOWN}
    np.testing.assert_allclose(po.beta_prob(_t(A), _t(B)).numpy(),
                               np.asarray(jpo.beta_prob(A, B)), rtol=1e-7)
    np.testing.assert_allclose(po.beta_var(_t(A), _t(B)).numpy(),
                               np.asarray(jpo.beta_var(A, B)), rtol=1e-6)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_prune_blocks_matches_jax(seed):
    A, B, touched, eff = _prune_inputs(seed)
    n, max_level = 4, 2
    sf_t = po.BetaStateFn(0.05, 0.3, 0.7)
    sf_j = jpo.BetaStateFn(0.05, 0.3, 0.7)
    vals = {"A": _t(A), "B": _t(B), "touched": _t(touched.astype(np.float32))}
    ours, ours_eff = pr.prune_blocks(vals, _t(eff), n=n, max_level=max_level,
                                     state_fn=sf_t)
    jvals = {"A": jnp.asarray(A), "B": jnp.asarray(B),
             "touched": jnp.asarray(touched.astype(np.float32))}
    ref, ref_eff = jpr.prune_blocks(jvals, jnp.asarray(eff), n=n,
                                    max_level=max_level, state_fn=sf_j)
    np.testing.assert_array_equal(ours_eff.numpy(), np.asarray(ref_eff))
    for k in vals:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_array_equal(sf_t(ours).numpy(), np.asarray(sf_j(ref)))
    assert (ours_eff.numpy() == 1).any()
    if seed % 2:
        assert (ours_eff.numpy() == 2).any()


def test_group_view_round_trip():
    x = torch.arange(2 * 64).reshape(2, 64)
    for m in (2, 4):
        g = pr._group_view(x, 4, m)
        assert g.shape == (2, 64 // m ** 3, m ** 3)
        assert torch.equal(pr._ungroup(g, 4, m), x)
        # element 0 of each group is its minimum (raster) corner
        assert torch.equal(g[..., 0], g.min(dim=-1).values)


def test_all_level_nodes_copy_matches_jax():
    for depth in (3, 4):
        a, ai = geo.all_level_nodes(0.1, depth)
        b, bi = jgeo.all_level_nodes(0.1, depth)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ai, bi)


# ------------------------------------------------------- K1 / K2 plain paths

def _heavy_reference(a, G, sf2, ell):
    """The heavy pass through the JAX package's cov_sparse (or, for segment
    entries, cov_sparse_segment(lv=False)) and _slot_rhs, one row at a
    time."""
    x = {k: v.numpy() for k, v in a.items()}
    acc = np.zeros((len(x["centers"]), len(x["all_nodes"]), 2 * G), np.float32)
    for b, s, c in zip(x["row_block"], x["row_start"], x["row_count"]):
        ids = x["ids"][s:s + c]
        vox, ent = jnp.asarray(x["all_nodes"] + x["centers"][b]), jnp.asarray(x["entries"][ids])
        if ent.shape[1] == 6:
            K = jkm.cov_sparse_segment(vox, ent, sf2, ell, lv=False)
        else:
            K = jkm.cov_sparse(vox, ent, sf2, ell)
        rhs = jkp._slot_rhs(jnp.asarray(x["labels"][ids]),
                            jnp.asarray(x["gslot"][s:s + c]),
                            jnp.ones(c, bool), G)
        acc[b] += np.asarray(K @ rhs)
    return acc


@pytest.mark.parametrize("G", [7, 27])
def test_bgk_heavy_plain_matches_jax(G):
    a = _heavy_inputs(5, G=G)
    before = bgk_heavy.launches
    acc = bgk_heavy.bgk_heavy(**a, G=G, sf2=1.0, ell=0.2)
    assert bgk_heavy.launches == before          # CPU tensors: plain version
    assert acc.shape == (5, 73, 2 * G)
    np.testing.assert_allclose(acc.numpy(), _heavy_reference(a, G, 1.0, 0.2),
                               atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("G", [7, 27])
def test_bgk_heavy_segment_plain_matches_jax(G):
    """K1's segment branch (BGKL): rays, degenerate hits, segments shorter
    than the 1e-4 threshold and axis-aligned ones."""
    a = _heavy_inputs(15, G=G, segments=True)
    assert a["entries"].shape[1] == 6
    before = bgk_heavy.launches
    acc = bgk_heavy.bgk_heavy(**a, G=G, sf2=0.1, ell=0.2)
    assert bgk_heavy.launches == before
    ref = _heavy_reference(a, G, 0.1, 0.2)
    assert (ref[..., G:] > 0).sum() > 500
    np.testing.assert_allclose(acc.numpy(), ref, atol=1e-5, rtol=1e-6)
    # the 0.001 gate decided alike wherever k̄ is not within 1e-5 of it
    kk, kr = acc.numpy()[..., G:], ref[..., G:]
    far = np.abs(kr - 0.001) > 1e-5
    np.testing.assert_array_equal((kk > 0.001)[far], (kr > 0.001)[far])


def test_bgk_heavy_padding_rows_are_inert():
    a = _heavy_inputs(6)
    acc = bgk_heavy.bgk_heavy(**a, G=7, sf2=1.0, ell=0.2)
    # JAX-style padding: extra rows at the last block with count 0
    pad = dict(a)
    T = a["centers"].shape[0]
    pad["row_block"] = torch.cat([a["row_block"], torch.full((5,), T - 1, dtype=torch.int32)])
    pad["row_start"] = torch.cat([a["row_start"], torch.zeros(5, dtype=torch.int32)])
    pad["row_count"] = torch.cat([a["row_count"], torch.zeros(5, dtype=torch.int32)])
    assert torch.equal(bgk_heavy.bgk_heavy(**pad, G=7, sf2=1.0, ell=0.2), acc)


@pytest.mark.parametrize("segments", [False, True])
def test_bgk_heavy_plain_adds_rows_in_row_order(segments):
    """The plain version adds a block's rows in row order whatever its chunk
    (the kernel's order): one row a chunk, chunks that split a block's rows
    and the default chunk give the same bits."""
    a = _heavy_inputs(16, segments=segments)
    kw = dict(G=7, sf2=0.1 if segments else 1.0, ell=0.2)
    assert int(torch.bincount(a["row_block"].long()).max()) >= 3
    acc = bgk_heavy.bgk_heavy_plain(**a, **kw)
    for chunk in (1, 3):
        assert torch.equal(bgk_heavy.bgk_heavy_plain(**a, **kw, chunk=chunk), acc)


def test_bgk_light_plain_applies_scans_in_order():
    acc, A, B, touched, eff, node_idx, slots = _light_inputs(7)
    kw = dict(G=7, gate=0.0, n=4, max_level=2,
              state_fn=po.BetaStateFn(100.0, 0.3, 0.7), do_prune=True)
    before = bgk_light.launches
    bgk_light.bgk_light(acc, A, B, touched, eff, node_idx, slots, 0, 6, **kw)
    bgk_light.bgk_light(acc, A, B, touched, eff, node_idx, slots, 6, 6, **kw)
    assert bgk_light.launches == before
    sl = slots[:11].long()
    assert touched[sl].any() and (eff[sl] > 0).any()
    untouched = torch.ones(A.shape[0], dtype=torch.bool)
    untouched[sl] = False
    assert (A[untouched] == 0.001).all() and not touched[untouched].any()
    assert (eff[slots[:6].long()] == 2).all()       # the uniform blocks collapsed
    # voxels left at eff 0 took their own node's gated sums
    acc_np, s6 = acc.numpy(), int(slots[6])
    ybar, kbar = acc_np[6, :64, :7], acc_np[6, :64, 7:]
    dA = np.where(kbar > 0, ybar, 0).sum(-1)
    base = eff[s6].numpy() == 0
    assert base.sum() > 32
    np.testing.assert_allclose(A[s6].numpy()[base], (0.001 + dA)[base], rtol=1e-6)


def test_wrappers_reject_devices_without_a_kernel():
    # no quiet fall-back to the plain version off the CPU
    a = {k: v.to("meta") for k, v in _heavy_inputs(8).items()}
    with pytest.raises(ValueError, match="device"):
        bgk_heavy.bgk_heavy(**a, G=7, sf2=1.0, ell=0.2)
    acc, A, B, touched, eff, node_idx, slots = (x.to("meta") for x in _light_inputs(8))
    with pytest.raises(ValueError, match="device"):
        bgk_light.bgk_light(acc, A, B, touched, eff, node_idx, slots, 0, 4, G=7,
                            gate=0.0, n=4, max_level=2,
                            state_fn=po.BetaStateFn(100.0, 0.3, 0.7), do_prune=True)


# ------------------------------------------------------------- LV kernel maths

def test_sparse_kernel_lv_matches_jax():
    r = np.linspace(0.0, 1.5, 4001, dtype=np.float32)
    ours = km.sparse_kernel_lv(_t(r), 0.1).numpy()
    ref = np.asarray(jkm.sparse_kernel_lv(jnp.asarray(r), 0.1))
    np.testing.assert_allclose(ours, ref, atol=1e-7, rtol=0)
    # no output clamp: r ≥ 1 gives the kernel's value at 1, not 0
    np.testing.assert_array_equal(ours[r >= 1.0], ours[np.argmax(r >= 1.0)])


def _segments(rng, n):
    """Segments of every branch: degenerate (|u| < 1e-4), and long ones the
    points see before the start, past the end and in the middle."""
    p0 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    p1 = p0 + rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    p1[: n // 4] = p0[: n // 4] + rng.uniform(-3e-5, 3e-5, (n // 4, 3))  # degenerate
    p1[n // 4: n // 3] = p0[n // 4: n // 3]                               # exact hits
    return np.concatenate([p0, p1], 1).astype(np.float32)


def test_point_to_segment_dist_matches_jax():
    rng = np.random.default_rng(21)
    p = rng.uniform(-0.8, 0.8, (96, 3)).astype(np.float32)
    seg = _segments(rng, 64)
    ours = km.point_to_segment_dist(_t(p), _t(seg)).numpy()
    ref = np.asarray(jkm.point_to_segment_dist(jnp.asarray(p), jnp.asarray(seg)))
    assert ours.shape == ref.shape == (96, 64)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)
    # every branch is taken: c1 ≤ 0, c2 ≤ c1 and the projection
    u = seg[:, 3:] - seg[:, :3]
    c1 = ((p[:, None, :] - seg[None, :, :3]) * u[None]).sum(-1)
    c2 = (u * u).sum(-1)[None]
    long_ = np.sqrt(c2[0]) >= 1e-4
    for branch in (c1 <= 0, (c2 <= c1) & (c1 > 0), (c1 > 0) & (c2 > c1)):
        assert (branch & long_[None]).sum() > 100
    # batched over a leading dimension, as the row engine calls it
    batched = km.point_to_segment_dist(_t(np.stack([p, p[::-1]])),
                                       _t(np.stack([seg, seg])))
    assert torch.equal(batched[0], _t(ours))


@pytest.mark.parametrize("lv", [False, True])
def test_cov_sparse_segment_matches_jax(lv):
    rng = np.random.default_rng(22)
    p = rng.uniform(-0.4, 0.4, (64, 3)).astype(np.float32)
    seg = _segments(rng, 48)
    ours = km.cov_sparse_segment(_t(p), _t(seg), 0.1, 0.2, lv=lv).numpy()
    ref = np.asarray(jkm.cov_sparse_segment(jnp.asarray(p), jnp.asarray(seg), 0.1,
                                            0.2, lv=lv))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    assert (ref < 0).any() if lv else (ref == 0).any()


def test_lv_state_matches_jax():
    A, B, touched, _ = _prune_inputs(4)
    A[:5], B[:5] = 1.0, 1.0            # W = A + B: the UNCERTAIN branch
    args = (0.001, 0.2, 0.3, 0.7)
    ours = po.lv_state(_t(A), _t(B), _t(touched), *args).numpy()
    ref = np.asarray(jpo.lv_state(jnp.asarray(A), jnp.asarray(B),
                                  jnp.asarray(touched), *args))
    np.testing.assert_array_equal(ours, ref)
    assert set(np.unique(ours)) == {po.FREE, po.OCCUPIED, po.UNKNOWN, po.UNCERTAIN}
    np.testing.assert_allclose(po.lv_prob(_t(A), _t(B), 0.001).numpy(),
                               np.asarray(jpo.lv_prob(A, B, 0.001)), rtol=1e-6)
    np.testing.assert_allclose(po.lv_var(_t(A), _t(B), 0.001).numpy(),
                               np.asarray(jpo.lv_var(A, B, 0.001)), rtol=1e-6, atol=1e-7)
    vals = {"A": _t(A), "B": _t(B), "touched": _t(touched.astype(np.float32))}
    jvals = {k: jnp.asarray(v.numpy()) for k, v in vals.items()}
    np.testing.assert_array_equal(po.LVStateFn(*args)(vals).numpy(),
                                  np.asarray(jpo.LVStateFn(*args)(jvals)))


def test_tile_vox_map_is_the_jax_storage_order():
    from la3dm_tpu.utils.config import MapConfig as JMapConfig
    for depth in (3, 5):
        jm = jlv.BGKLVOctoMap(JMapConfig(method="bgklv", block_depth=depth))
        np.testing.assert_array_equal(geo.tile_vox_map(jm.n), jm._tile_vox_map)
    m6 = geo.tile_vox_map(32)
    assert m6.shape == (64, 512) and np.array_equal(np.sort(m6.reshape(-1)),
                                                    np.arange(32 ** 3))


# ------------------------------------------------------- K3 / K8 plain paths

def _jax_rows_step(a, st, chunk=4):
    """la3dm_tpu's _lv_rows_step on lv_rows_inputs' tuple: flat pool
    arrays, rows padded with count-0 rows to a multiple of ``chunk``."""
    x = [v.numpy() for v in a]
    cap, V = x[0].shape
    pad = -len(x[8]) % chunk
    rows = [np.concatenate([r, np.zeros(pad, np.int32)]) for r in x[8:11]]
    out = jlv._lv_rows_step(
        jnp.asarray(x[0].reshape(-1)), jnp.asarray(x[1].reshape(-1)),
        jnp.asarray(x[2].reshape(-1)), jnp.asarray(x[3].reshape(-1)),
        *(jnp.asarray(v) for v in x[4:8]), *(jnp.asarray(r) for r in rows),
        *(jnp.asarray(v) for v in x[11:14]), V=V, W=64, chunk=chunk, **st)
    return [np.asarray(o).reshape(cap, V) for o in out]


@pytest.mark.parametrize("depth", [3, 5])
def test_lv_rows_plain_matches_jax(depth):
    a = lv_rows_inputs(7, depth=depth)
    ref = _jax_rows_step(a, LV_ROWS_STATICS)
    pool = [x.clone() for x in a[:4]]
    before = lv_rows.launches
    lv_rows.lv_rows(*pool, *a[4:], **LV_ROWS_STATICS)
    assert lv_rows.launches == before                # CPU tensors: plain version
    A, B, touched = (x.numpy() for x in pool[:3])
    for ours, r in ((A, ref[0]), (B, ref[1])):
        np.testing.assert_allclose(ours, r, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(touched, ref[2])
    assert torch.equal(pool[3], a[3])                # eff is read only
    assert (A != a[0].numpy()).sum() > 100
    # the gate: base-resolution voxels only
    assert (A[a[3].numpy() > 0] == a[0].numpy()[a[3].numpy() > 0]).all()


def test_lv_rows_plain_sums_in_row_order():
    """The same dispatch, rows and tiles in another chunking: the row sums
    and their index-add do not depend on how the rows are chunked."""
    a = lv_rows_inputs(8)
    args = (a[4:11], a[12], a[13])
    kw = dict(sf2=0.1, ell=0.2, free_res=0.1)
    y1, k1, m1 = lv_rows.lv_rows_acc_plain(*args[0], *args[1:], **kw)
    y2, k2, m2 = lv_rows.lv_rows_acc_plain(*args[0], *args[1:], **kw, chunk=3)
    assert torch.equal(y1, y2) and torch.equal(k1, k2) and int(m1) == int(m2) > 0


@pytest.mark.parametrize("depth", [3, 5])
def test_lv_prune_plain_matches_jax(depth):
    n = 2 ** (depth - 1)
    A, B, T, E, slots = lv_prune_inputs(9, n=n)
    kw = dict(n=n, max_level=depth - 1)
    perm = geo.tile_vox_map(n).reshape(-1)
    # copies: the JAX step donates its pool inputs and runs asynchronously,
    # and jnp.asarray may alias the numpy memory the port's in-place prune
    # below writes
    fields, jt, je = jlv._prune_step_tilemajor(
        {"A": jnp.asarray(A.numpy().copy()), "B": jnp.asarray(B.numpy().copy())},
        jnp.asarray(T.numpy().copy()), jnp.asarray(E.numpy().copy()),
        jnp.asarray(slots.numpy()),
        jnp.asarray(np.argsort(perm)), jnp.asarray(perm),
        state_fn=jpo.LVStateFn(**LV_STATE), **kw)
    before = lv_prune.launches
    lv_prune.lv_prune(A, B, T, E, slots, state_fn=po.LVStateFn(**LV_STATE), **kw)
    assert lv_prune.launches == before
    np.testing.assert_array_equal(E.numpy(), np.asarray(je))
    np.testing.assert_array_equal(T.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(A.numpy(), np.asarray(fields["A"]))
    np.testing.assert_array_equal(B.numpy(), np.asarray(fields["B"]))
    assert {int(L) for L in np.unique(E.numpy())} >= set(range(depth))


def test_lv_wrappers_reject_devices_without_a_kernel():
    a = [x.to("meta") for x in lv_rows_inputs(10, depth=3)]
    with pytest.raises(ValueError, match="device"):
        lv_rows.lv_rows(*a, **LV_ROWS_STATICS)
    pool = [x.to("meta") for x in lv_prune_inputs(10, n=4)]
    with pytest.raises(ValueError, match="device"):
        lv_prune.lv_prune(*pool, n=4, max_level=2, state_fn=po.LVStateFn(**LV_STATE))


# ------------------------------------------------------------- GP maths

@pytest.mark.parametrize("ell", [1.0, 0.6])
def test_cov_matern32_matches_jax(ell):
    rng = np.random.default_rng(23)
    x = rng.uniform(-2.0, 2.0, (73, 3)).astype(np.float32)
    z = rng.uniform(-2.0, 2.0, (64, 3)).astype(np.float32)
    ours = km.cov_matern32(_t(x), _t(z), 1.0, ell).numpy()
    ref = np.asarray(jkm.cov_matern32(jnp.asarray(x), jnp.asarray(z), 1.0, ell))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)
    # both operands scaled before the subtraction: K(x, x) has exact ones
    assert (km.cov_matern32(_t(x), _t(x), 1.0, ell).diagonal() == 1.0).all()
    d = np.linspace(0.0, 5.0, 501, dtype=np.float32)
    np.testing.assert_allclose(km.matern32(_t(d), 0.5, ell).numpy(),
                               np.asarray(jkm.matern32(jnp.asarray(d), 0.5, ell)),
                               atol=1e-7, rtol=1e-6)


def _gp_batch(seed, noise):
    """Three padded models (16, 5 and 1 points of 16) of ±1 labels."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.3, 0.3, (3, 16, 3)).astype(np.float32)
    valid = np.arange(16)[None] < np.array([16, 5, 1])[:, None]
    lab = np.where(rng.uniform(size=(3, 16)) > 0.5, 1.0, -1.0).astype(np.float32)
    xs = rng.uniform(-0.5, 0.5, (3, 20, 3)).astype(np.float32)
    return pts, lab, valid, xs, (1.0, 1.0, noise)


@pytest.mark.parametrize("noise", [0.01, -0.5])
def test_gp_train_and_predict_core_match_jax(noise):
    """Train and predict against JAX; with noise −0.5 the 16- and 5-point
    Grams are not positive definite: NaN exactly where JAX gives NaN (the
    whole factor of those models), the 1-point model still factors."""
    pts, lab, valid, xs, (sf2, ell, nz) = _gp_batch(24, noise)
    L, a = kgp.gp_train_core(_t(pts), _t(lab), _t(valid), sf2, ell, nz)
    jL, ja = jgpk.gp_train_core(jnp.asarray(pts), jnp.asarray(lab),
                                jnp.asarray(valid), sf2, ell, nz)
    jL, ja = np.asarray(jL), np.asarray(ja)
    np.testing.assert_array_equal(np.isnan(L.numpy()), np.isnan(jL))
    np.testing.assert_allclose(L.numpy(), jL, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(a.numpy(), ja, atol=1e-3, rtol=1e-3)
    mean, var = kgp.gp_predict_core(L, a, _t(pts), _t(valid), _t(xs), sf2, ell)
    jm, jv = jgpk.gp_predict_core(jnp.asarray(jL), jnp.asarray(ja), jnp.asarray(pts),
                                  jnp.asarray(valid), jnp.asarray(xs), sf2, ell)
    jm, jv = np.asarray(jm), np.asarray(jv)
    np.testing.assert_array_equal(np.isnan(mean.numpy()), np.isnan(jm))
    np.testing.assert_allclose(mean.numpy(), jm, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(var.numpy(), jv, atol=1e-5, rtol=1e-5)
    failed = np.isnan(jL[:, 0, 0])
    assert list(failed) == ([False] * 3 if noise > 0 else [True, True, False])


def test_bcm_update_sequential_matches_jax():
    rng = np.random.default_rng(25)
    mi = rng.uniform(-50, 50, (40, 64)).astype(np.float32)
    iv = rng.uniform(0.001, 80, (40, 64)).astype(np.float32)
    iv[:5] = 990.0                                 # these rows reach the chop
    m = rng.uniform(-1, 1, (40, 64, 7)).astype(np.float32)
    var = rng.uniform(0.005, 1.0, (40, 64, 7)).astype(np.float32)
    ok = rng.uniform(size=(40, 64, 7)) < 0.7
    a, b = kgp.bcm_update_sequential(_t(mi), _t(iv), _t(m), _t(var), _t(ok), **GP_BCM)
    ja, jb = jgpk.bcm_update_sequential(jnp.asarray(mi), jnp.asarray(iv), jnp.asarray(m),
                                        jnp.asarray(var), jnp.asarray(ok), **GP_BCM)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    assert (b.numpy() == 1000.0).any() and (b.numpy() < 50.0).any()   # chop, unknown


def test_gp_state_matches_jax():
    rng = np.random.default_rng(26)
    mi = rng.uniform(-30, 30, (24, 64)).astype(np.float32)
    iv = rng.uniform(0, 120, (24, 64)).astype(np.float32)
    touched = rng.uniform(size=(24, 64)) > 0.1
    ours = po.gp_state(_t(mi), _t(iv), _t(touched), **GP_STATE).numpy()
    ref = np.asarray(jpo.gp_state(jnp.asarray(mi), jnp.asarray(iv), jnp.asarray(touched),
                                  **GP_STATE))
    np.testing.assert_array_equal(ours, ref)
    assert set(np.unique(ours)) == {po.FREE, po.OCCUPIED, po.UNKNOWN}
    np.testing.assert_allclose(po.gp_prob(_t(mi), 100.0, 1000.0).numpy(),
                               np.asarray(jpo.gp_prob(mi, 100.0, 1000.0)), rtol=1e-6)
    vals = {"m_ivar": _t(mi), "ivar": _t(iv), "touched": _t(touched.astype(np.float32))}
    jvals = {k: jnp.asarray(v.numpy()) for k, v in vals.items()}
    np.testing.assert_array_equal(po.GPStateFn(**GP_STATE)(vals).numpy(),
                                  np.asarray(jpo.GPStateFn(**GP_STATE)(jvals)))


# ------------------------------------------------------- K4 / K5 plain paths

def _jax_gp_heavy(a, S):
    """la3dm_tpu's _gp_heavy on gp_heavy_inputs' dict, models padded with
    count-0 models to a multiple of its chunk."""
    x = {k: v.numpy() for k, v in a.items()}
    M, G = x["nb_rows"].shape
    Tp, Vall = len(x["centers"]), len(x["all_nodes"])
    chunk = jgp._chunk_for(S)
    Mp = -(-M // chunk) * chunk
    st, ct = np.zeros(Mp, np.int32), np.zeros(Mp, np.int32)
    nb = np.full((Mp, G), Tp, np.int32)
    st[:M], ct[:M], nb[:M] = x["starts"], x["counts"], x["nb_rows"]
    out = jgp._gp_heavy(jnp.zeros((Tp * G, Vall)), jnp.ones((Tp * G, Vall)),
                        jnp.zeros(Tp * G, bool), jnp.asarray(x["all_nodes"]),
                        jnp.asarray(x["pts"]), jnp.asarray(x["lab"]), jnp.asarray(st),
                        jnp.asarray(ct), jnp.asarray(nb), jnp.asarray(x["centers"]),
                        S=S, chunk=chunk, G=G, **GP_STATICS)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("depth,S", [(3, 128), (4, 128), (3, 256), (4, 512)])
def test_gp_heavy_plain_matches_jax(depth, S):
    """Both tiers, demo and large-map node tables, the JAX step padded to S
    and the port's to the tier's largest count: the factor's rounding order
    differs between the two packages' LAPACKs, so means agree to
    2e-3 + 1e-3·|JAX| (α = K⁻¹y carries the Gram's conditioning) and
    variances to 1e-5."""
    a = gp_heavy_inputs(17, depth=depth, S=S)
    ref_mean, ref_var, ref_present = _jax_gp_heavy(a, S)
    before = gp_heavy.launches
    gp_heavy.gp_heavy(**a, host_counts=a["counts"].numpy(), **GP_STATICS)
    assert gp_heavy.launches == before                # CPU tensors: plain version
    np.testing.assert_array_equal(a["present"].numpy(), ref_present)
    assert ref_present.sum() > 50 and int(a["failed"]) == 0
    np.testing.assert_allclose(a["acc_mean"].numpy(), ref_mean, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(a["acc_var"].numpy(), ref_var, atol=1e-5, rtol=0)
    # rows no model serves keep the tables' fill
    idle = ~ref_present
    assert (a["acc_var"].numpy()[idle] == 1.0).all()


def test_gp_heavy_plain_counts_failed_models():
    a = gp_heavy_inputs(18)
    gp_heavy.gp_heavy(**a, host_counts=a["counts"].numpy(), sf2=1.0, ell=1.0, noise=-0.5)
    assert int(a["failed"]) == a["counts"].numel() - 1     # all but the 1-point model
    served = a["present"].numpy()
    nan_rows = np.isnan(a["acc_mean"].numpy()).all(-1)
    assert nan_rows.sum() > 0 and (nan_rows <= served).all()


def _jax_gp_light(pool, am, av, pr_, node_idx, slots, scans, depth):
    """la3dm_tpu's _gp_light; its pool has one spare row past the capacity."""
    cap = pool[0].shape[0]
    ext = [jnp.asarray(np.concatenate([x.numpy(), x.numpy()[:1] * 0]))
           for x in pool]
    out = jgp._gp_light(*ext, jnp.asarray(node_idx.numpy()), jnp.asarray(am.numpy()),
                        jnp.asarray(av.numpy()), jnp.asarray(pr_.numpy()),
                        jnp.asarray(slots.numpy()),
                        jnp.asarray(np.array([s for s, _ in scans], np.int32)),
                        jnp.asarray(np.array([c for _, c in scans], np.int32)),
                        G=7, **GP_BCM, n=2 ** (depth - 1), max_level=depth - 1,
                        state_fn=jpo.GPStateFn(**GP_STATE), do_prune=True,
                        scan_bt=max(c for _, c in scans))
    return [np.asarray(o)[:cap] for o in out]


@pytest.mark.parametrize("depth", [3, 4, 5])
def test_gp_light_plain_matches_jax(depth):
    am, av, pr_, *pool, node_idx, slots = gp_light_inputs(19, depth=depth)
    scans = [(0, 6), (6, 6)]
    ref = _jax_gp_light(pool, am, av, pr_, node_idx, slots, scans, depth)
    before = gp_light.launches
    for s, c in scans:
        gp_light.gp_light(am, av, pr_, *pool, node_idx, slots, s, c, G=7, **GP_BCM,
                          n=2 ** (depth - 1), max_level=depth - 1,
                          state_fn=po.GPStateFn(**GP_STATE), do_prune=True)
    assert gp_light.launches == before
    for ours, r in zip(pool, ref):
        np.testing.assert_array_equal(ours.numpy(), r)
    levels = set(np.unique(pool[3].numpy()).tolist())
    assert {0, 1, depth - 1} <= levels
    sl = slots[:-1].long()
    assert pool[2][sl].any() and not pool[2][slots[6].long()].any()   # no slot present


def test_gp_wrappers_reject_devices_without_a_kernel():
    cpu = gp_heavy_inputs(20)
    a = {k: v.to("meta") for k, v in cpu.items()}
    with pytest.raises(ValueError, match="device"):
        gp_heavy.gp_heavy(**a, host_counts=cpu["counts"].numpy(), **GP_STATICS)
    am, av, pr_, *pool, node_idx, slots = (x.to("meta") for x in gp_light_inputs(20))
    with pytest.raises(ValueError, match="device"):
        gp_light.gp_light(am, av, pr_, *pool, node_idx, slots, 0, 4, G=7, **GP_BCM, n=4,
                          max_level=2, state_fn=po.GPStateFn(**GP_STATE), do_prune=True)


# ------------------------------------------------------------- device ingest

def _face_entries(seed, n=400):
    """Entries round a few blocks, a quarter of their coordinates on block
    faces or centre planes (multiples of bs/2 = 0.2), two on block corners."""
    rng = np.random.default_rng(seed)
    e = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    on = rng.uniform(size=e.shape) < 0.25
    face = (rng.integers(-5, 6, e.shape) * np.float32(0.2)).astype(np.float32)
    corners = np.float32([[0.2, 0.2, 0.2], [-0.2, 0.6, -0.6]])
    return np.concatenate([np.where(on, face, e), corners]).astype(np.float32)


def test_closed_box_memberships_match_jax():
    e = _face_entries(30)
    valid = np.random.default_rng(31).uniform(size=len(e)) > 0.1
    mc, mok = ingest_members.closed_box_memberships(_t(e), _t(valid), 0.4)
    jmc, jmok = jdi._closed_box_memberships(jnp.asarray(e), jnp.asarray(valid), 0.4)
    np.testing.assert_array_equal(mok.numpy(), np.asarray(jmok))
    ok = mok.numpy()
    np.testing.assert_array_equal(mc.numpy()[ok], np.asarray(jmc)[ok])
    assert (ok.sum(1) == 8).any() and (ok.sum(1) == 2).any()   # corners and faces


def test_membership_keys_sort_as_jax_local_keys():
    """The port's keys (anchored 16-bit fields) and JAX's ``_local_keys``
    (10 bits from the scan's minimum) name the same blocks, and a stable sort
    orders the memberships alike."""
    e = _face_entries(32)
    valid = np.ones(len(e), bool)
    anchor = np.array([[1, -2, 0]], np.int32)
    keys = ingest_members.memberships_plain(_t(e), torch.zeros(len(e), dtype=torch.int32),
                                            _t(valid), _t(anchor), block_size=0.4).numpy()
    jmc, jmok = jdi._closed_box_memberships(jnp.asarray(e), jnp.asarray(valid), 0.4)
    jkey, bmin = jdi._local_keys(jmc, jmok)
    jkey = np.asarray(jkey).reshape(-1)
    np.testing.assert_array_equal(keys == ingest_keys.SENT, jkey == jdi._SENT)
    ok = keys != ingest_keys.SENT
    np.testing.assert_array_equal(ingest_keys.unpack_np(keys[ok], anchor)[1],
                                  jdi.unpack_local_keys(jkey[ok], np.asarray(bmin)))
    np.testing.assert_array_equal(np.argsort(keys, kind="stable"),
                                  np.argsort(jkey, kind="stable"))


@pytest.mark.parametrize("corners", [False, True])
def test_compact_memberships_are_the_dense_keys_in_order(corners):
    """K7c's compact layout (the point family's): the dense plain keys that
    are not the sentinel, in their order, each with its entry (index // 8)
    and their count; on entries strictly inside a block and on one, two or
    three face planes (1, 2, 4 and 8 memberships; corner-heavy with
    ``corners``) among runs of invalid entries.  The wrapper on CPU tensors
    gives the compact plain version and its count, or the dense one; the
    dense keys are JAX's memberships."""
    ent, scan, valid, anchors = member_entries(40 + corners, corners=corners)
    dense = ingest_members.memberships_plain(ent, scan, valid, anchors, block_size=0.4)
    keys, rows = ingest_members.compact_memberships_plain(ent, scan, valid, anchors,
                                                          block_size=0.4)
    at = np.flatnonzero(dense.numpy() != ingest_keys.SENT)
    np.testing.assert_array_equal(keys.numpy(), dense.numpy()[at])
    np.testing.assert_array_equal(rows.numpy(), at // 8)
    assert keys.dtype == torch.int64 and rows.dtype == torch.int32
    per_entry = (dense.reshape(-1, 8) != ingest_keys.SENT).sum(1)
    assert set(per_entry[valid].tolist()) == {1, 2, 4, 8}
    assert not per_entry[~valid].any()
    before = ingest_members.launches
    k, r, m = ingest_members.memberships(ent, scan, valid, anchors, block_size=0.4)
    assert torch.equal(k, keys) and torch.equal(r, rows)
    assert m.dtype == torch.int32 and m.tolist() == [len(at)]
    kd, rd, none = ingest_members.memberships(ent, scan, valid, anchors, block_size=0.4,
                                              dense=True)
    assert torch.equal(kd, dense) and none is None
    assert torch.equal(rd, torch.arange(8 * len(ent), dtype=torch.int32) // 8)
    assert ingest_members.launches == before
    _, jmok = jdi._closed_box_memberships(jnp.asarray(ent.numpy()), jnp.asarray(valid.numpy()),
                                          0.4)
    np.testing.assert_array_equal(np.flatnonzero(np.asarray(jmok).reshape(-1)), at)


def test_downsample_plain_matches_jax():
    """Hit downsample of one scan (outlier masked, a voxel of origin copies
    on a block face): the same voxels in the same z-major order, centroids
    within 1e-6·(1 + |JAX|) (JAX sums each voxel in a tree, the port in
    sorted order), the origin's voxel exact in both."""
    pts, scan, origins, cell_anchor, _ = ingest_scene(33, n_scans=1)
    ds, mr = INGEST["ds"], INGEST["mr"]
    inv = float(np.float32(1 / ds))
    lim = float(np.float32((mr + np.sqrt(3.0) * ds) ** 2))
    before = ingest_beams.launches, ingest_downsample.launches
    keys = ingest_beams.point_keys(pts, scan, origins, cell_anchor, inv_leaf=inv, lim=lim)
    ukey, cent = device_ingest._downsample(pts, keys, cell_anchor, float(np.float32(ds)))
    assert (ingest_beams.launches, ingest_downsample.launches) == before
    spec = jdi.spec_for(type("C", (), {"method": "bgk", "block_size": 0.4})(), ds, 0.5, mr,
                        len(pts))
    valid = jdi._outlier_mask(jnp.asarray(pts.numpy()), jnp.asarray(origins[0].numpy()), spec)
    np.testing.assert_array_equal(keys.numpy() != ingest_keys.SENT, np.asarray(valid))
    jc, jok, jn = jdi._downsample(jnp.asarray(pts.numpy()), valid, ds, len(pts))
    jc = np.asarray(jc)[np.asarray(jok)]
    assert int(jn) == len(cent) > 100
    np.testing.assert_allclose(cent.numpy(), jc, rtol=1e-6, atol=1e-6)
    o = origins[0].numpy()
    assert (cent.numpy() == o).all(1).sum() == 1 and (jc == o).all(1).sum() == 1


def test_centroids_plain_sums_in_sorted_order():
    """Each run is summed member by member in sorted order, compensated."""
    pts, scan, origins, cell_anchor, _ = ingest_scene(34, n_scans=2, n=100)
    keys = ingest_beams.point_keys(pts, scan, origins, cell_anchor, inv_leaf=10.0, lim=100.0)
    perm, ukey, starts, counts, _ = ingest_sort.sort_runs(
        keys, ingest_sort.widest_window(len(origins)))
    cent = ingest_downsample.centroids(pts, perm, starts, counts, ukey, cell_anchor, leaf=0.1)
    corner = ingest_keys.unpack(ukey, cell_anchor).to(torch.float32) * 0.1
    for r in range(len(ukey)):
        s = torch.zeros(3)
        for q in range(int(starts[r]), int(starts[r] + counts[r])):
            s = s + (pts[perm[q]] - corner[r])
        assert torch.equal(cent[r], corner[r] + s / float(counts[r]))


def test_aligned_heavy_plain_matches_jax():
    """K1′'s plain version against JAX ``_aligned_heavy`` + the ``u_targets``
    gather on random Wa-aligned tables: 1e-5 + 1e-5·|JAX|."""
    a = aligned_heavy_inputs(35, U=12, T=20)
    G, U = 7, 12
    ucount = a["ucount"].numpy()
    Vall = a["ext_nodes"].shape[0] // G
    # the JAX layout: each block's run padded to a multiple of Wa = 8
    pad = -(-ucount // 8) * 8
    jstart = np.concatenate([[0], np.cumsum(pad)[:-1]])
    M = int(pad.sum())
    ent = np.zeros((M, 3), np.float32)
    lab = np.zeros(M, np.float32)
    vm = np.zeros(M, bool)
    urank = np.zeros(M // 8, np.int32)
    for u in range(U):
        s0, c = int(a["ustart"][u]), int(ucount[u])
        ent[jstart[u]:jstart[u] + c] = a["ent_rel"][s0:s0 + c].numpy()
        lab[jstart[u]:jstart[u] + c] = a["labels"][s0:s0 + c].numpy()
        vm[jstart[u]:jstart[u] + c] = True
        urank[jstart[u] // 8:(jstart[u] + pad[u]) // 8] = u
    u_tgt, tb_rows = jdi.u_targets(jnp.asarray(urank[None]), jnp.asarray(a["tb_u"].numpy()[None]),
                                   U, G)
    acc = jbgk._aligned_heavy(jnp.zeros((U + 1, 2 * G * Vall), jnp.float32),
                              jnp.asarray(a["ext_nodes"].numpy()), jnp.asarray(ent),
                              jnp.asarray(lab), jnp.asarray(vm), u_tgt, Wa=8, chunk=1,
                              G=G, sf2=1.0, ell=0.2, segments=False)
    acc4 = np.asarray(acc).reshape(U + 1, 2, G, Vall)
    rows = np.asarray(tb_rows)
    ref = np.stack([acc4[rows, 0, np.arange(G)], acc4[rows, 1, np.arange(G)]], 2)
    before = bgk_aligned_heavy.launches
    ours = bgk_aligned_heavy.bgk_aligned_heavy(**a, G=G, sf2=1.0, ell=0.2)
    assert bgk_aligned_heavy.launches == before
    ours = ours.numpy().reshape(-1, Vall, 2, G).transpose(0, 3, 2, 1)
    assert (ref[:, :, 1] > 0).sum() > 500 and (ref[:, :, 1] == 0).sum() > 500
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_ingest_wrappers_reject_devices_without_a_kernel():
    pts, scan, origins, ca, ba = (x.to("meta") for x in ingest_scene(36, n_scans=1, n=20))
    with pytest.raises(ValueError, match="device"):
        ingest_beams.point_keys(pts, scan, origins, ca, inv_leaf=10.0, lim=1.0)
    hk = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        ingest_beams.beam_samples(pts[:4], hk, origins, ca, kf=3, mr=8.0, fr=0.5,
                                  inv_leaf=10.0)
    with pytest.raises(ValueError, match="device"):
        ingest_downsample.centroids(pts, hk, hk, hk, hk, ca, leaf=0.1)
    with pytest.raises(ValueError, match="device"):
        ingest_members.memberships(pts, scan, scan.bool(), ba, block_size=0.4)
    a = {k: v.to("meta") for k, v in aligned_heavy_inputs(36).items()}
    with pytest.raises(ValueError, match="device"):
        bgk_aligned_heavy.bgk_aligned_heavy(**a, G=7, sf2=1.0, ell=0.2)


# ------------------------------------------------------- K7d, K6 plain paths

def test_ray_pairs_plain_dedups_like_the_host_tables():
    """K7d's plain version: each ray's distinct closed-box blocks of its
    proxy samples (the origin and the backward samples), in ray order and
    key order — the set the host path's ``segment_block_entries`` takes for
    the same samples."""
    from la3dm_tpu_torch.geometry import blocks as g

    args, kw = ray_inputs(45)
    hits, hkey, origins, ba = args
    before = ingest_rays.launches
    occ, seg, inr, pray, pkey, samples = ingest_rays.ray_pairs(*args, **kw, want_samples=True)
    assert ingest_rays.launches == before                # CPU tensors: plain version
    R, S = hits.shape[0], kw["kf"] + 1
    assert samples.shape == (R, S, 3) and inr.sum() > 0.9 * R
    assert (torch.diff(pray) >= 0).all()
    same_ray = pray[1:] == pray[:-1]
    assert (pkey[1:][same_ray] > pkey[:-1][same_ray]).all()          # distinct, ascending
    scan, coords = ingest_keys.unpack_np(pkey.numpy(), ba.numpy())
    smask = np.ones((R, S), bool)
    d = (torch.sqrt(((hits - origins[hkey >> 48]) ** 2).sum(1))[:, None]
         - torch.arange(1, S).float() * kw["fr"]).numpy()
    smask[:, 1:] = d > 0
    smask &= inr.numpy()[:, None]
    ray_of = np.repeat(np.arange(R), S)[smask.reshape(-1)]
    mc, mi = g.point_block_memberships(samples.reshape(-1, 3).numpy()[smask.reshape(-1)],
                                       kw["block_size"])
    want = {(int(r), tuple(c)) for r, c in zip(ray_of[mi], mc)}
    got = {(int(r), tuple(c)) for r, c in zip(pray.numpy(), coords)}
    assert got == want and len(got) > 5 * R


def test_ray_work_counts_the_samples_and_memberships():
    """K7d's bound counts what the rays need: each in-range ray's proxy
    samples with d > 0 (the origin among them) and their closed-box
    memberships, of which the dedup keeps the distinct blocks."""
    args, kw = ray_inputs(47)
    hits, hkey, origins, _ = args
    n_smp, n_mem = ingest_rays.ray_work(hits, hkey, origins, **kw)
    _, _, inr, pray, _, _ = ingest_rays.ray_pairs_plain(*args, **kw)
    assert (n_smp[~inr] == 0).all() and (n_smp[inr] >= 1).all()
    assert (n_smp <= kw["kf"] + 1).all() and (n_mem >= n_smp).all()
    kept = torch.bincount(pray, minlength=hits.shape[0])
    assert (kept <= n_mem).all() and int(n_mem.sum()) > int(kept.sum())


def test_raycast_plain_steps_and_exits():
    """K6's plain version on synthetic tables: a ray stops at its first
    target voxel (dist = t there) or once past the range; steps never exceed
    max_steps; a state table of UNKNOWN only gives no hits."""
    args, kw = raycast_inputs(7, n_rays=300)
    before = k6.launches
    hit, dist, steps = k6.raycast(*args, **kw)
    assert k6.launches == before                         # CPU tensors: plain version
    assert hit.any() and (~hit).any() and int(steps.max()) <= kw["max_steps"]
    assert torch.isinf(dist[~hit]).all() and (dist[hit] <= kw["max_range"]).all()
    blank = (torch.full_like(args[0], po.UNKNOWN),) + args[1:]
    h2, d2, s2 = k6.raycast(*blank, **kw)
    assert not h2.any() and (s2 >= steps).all()
    # the f64 control runs the same loop; it reads other voxels at ties
    hc, dc, sc = k6.raycast_plain(*args[:4], args[4].double(), args[5].double(), **kw)
    assert dc.dtype == torch.float64 and 0.8 < (hc == hit).float().mean() < 1.0


def test_ray_and_raycast_wrappers_reject_devices_without_a_kernel():
    args, kw = ray_inputs(45)
    with pytest.raises(ValueError, match="device"):
        ingest_rays.ray_pairs(*(x.to("meta") for x in args), **kw)
    args, kw = raycast_inputs(8, n_rays=10)
    with pytest.raises(ValueError, match="device"):
        k6.raycast(*(x.to("meta") for x in args), **kw)
