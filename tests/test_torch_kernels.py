"""The port's kernel modules against their JAX counterparts, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
CUDA kernels themselves run only on a card: tests/test_torch_cuda.py holds
them against their plain versions there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from la3dm_tpu.geometry import blocks as jgeo
from la3dm_tpu.kernels import math as jkm, predict as jkp
from la3dm_tpu.models import bgklv as jlv, posterior as jpo, pruning as jpr

from la3dm_tpu_torch.geometry import blocks as geo
from la3dm_tpu_torch.kernels import (bgk_heavy, bgk_light, lv_prune, lv_rows,
                                     math as km, predict as kp)
from la3dm_tpu_torch.models import posterior as po, pruning as pr

from torch_cases import (LV_ROWS_STATICS, LV_STATE, heavy_inputs as _heavy_inputs,
                         light_inputs as _light_inputs, lv_prune_inputs, lv_rows_inputs,
                         one_torch_thread)  # noqa: F401  (autouse fixture)


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
    """The heavy pass through the JAX package's cov_sparse and _slot_rhs,
    one row at a time."""
    x = {k: v.numpy() for k, v in a.items()}
    acc = np.zeros((len(x["centers"]), len(x["all_nodes"]), 2 * G), np.float32)
    for b, s, c in zip(x["row_block"], x["row_start"], x["row_count"]):
        ids = x["ids"][s:s + c]
        K = jkm.cov_sparse(jnp.asarray(x["all_nodes"] + x["centers"][b]),
                           jnp.asarray(x["entries"][ids]), sf2, ell)
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
    fields, jt, je = jlv._prune_step_tilemajor(
        {"A": jnp.asarray(A.numpy()), "B": jnp.asarray(B.numpy())},
        jnp.asarray(T.numpy()), jnp.asarray(E.numpy()), jnp.asarray(slots.numpy()),
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
