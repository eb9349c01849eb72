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
from la3dm_tpu.models import posterior as jpo, pruning as jpr

from la3dm_tpu_torch.geometry import blocks as geo
from la3dm_tpu_torch.kernels import bgk_heavy, bgk_light, math as km, predict as kp
from la3dm_tpu_torch.models import posterior as po, pruning as pr

from torch_cases import (heavy_inputs as _heavy_inputs, light_inputs as _light_inputs,
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
