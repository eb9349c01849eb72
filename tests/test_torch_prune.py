"""The vote-based prune of K2, K5 and K8 on the CPU: the Morton order the
kernels use (``la3dm_tpu_torch/kernels/group_prune.py``, the twin of
``csrc/group_prune.cuh``), and the plain versions of the three kernels
against the JAX package's steps on near-collapsible pools
(``kernels/group_prune.py::near_collapsible_rows``).  The kernels themselves
run on a card: tests/test_torch_cuda.py holds them against these plain
versions on the same pools.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from la3dm_tpu.kernels import predict as jkp
from la3dm_tpu.models import bgklv as jlv, gp as jgp, posterior as jpo, pruning as jpr

from la3dm_tpu_torch.geometry import blocks as geo
from la3dm_tpu_torch.kernels import bgk_light, gp_light, group_prune, lv_prune
from la3dm_tpu_torch.models import posterior as po, pruning as pr

from torch_cases import (GP_BCM, GP_STATE, LV_STATE, near_bgk_light_inputs,  # noqa: F401
                         near_gp_light_inputs, near_lv_prune_inputs,
                         one_torch_thread)  # (one_torch_thread: autouse fixture)

NEAR_KINDS, near_collapsible_rows = group_prune.NEAR_KINDS, group_prune.near_collapsible_rows


@pytest.mark.parametrize("e", [2, 4, 8], ids=lambda e: f"edge{e}")
@pytest.mark.parametrize("what", ["voxels", "tiles"])
def test_morton_order_groups_are_aligned_runs(what, e):
    """Voxels of a cube of edge 2, 4 and 8, and the tiles of blocks of
    n = 16, 32 and 64 (8 × e): the order is a permutation, every level's
    group is the run of 8^L indices from a multiple of 8^L, and its first
    index is the group's minimum corner."""
    order = group_prune.morton_order(e)
    assert sorted(order.tolist()) == list(range(e ** 3))
    x, y, z = order % e, order // e % e, order // (e * e)
    for L in range(1, e.bit_length()):
        m = 1 << L
        for start in range(0, e ** 3, m ** 3):
            run = slice(start, start + m ** 3)
            cx, cy, cz = x[start], y[start], z[start]
            assert cx % m == cy % m == cz % m == 0
            assert (cx, cy, cz) == (x[run].min(), y[run].min(), z[run].min())
            cube = {(cx + i, cy + j, cz + k) for i in range(m) for j in range(m)
                    for k in range(m)}
            assert set(zip(x[run].tolist(), y[run].tolist(), z[run].tolist())) == cube


def test_morton_order_refuses_larger_cubes():
    with pytest.raises(ValueError, match="edge"):
        group_prune.morton_order(16)


def _near_kinds(n, i, levels, kinds):
    """The level and each group's kind (raster group order) of block i of
    :func:`near_collapsible_rows`."""
    L = 1 + i % levels
    g = n >> L
    return L, [kinds[(i // levels + j) % len(kinds)] for j in range(g ** 3)]


@pytest.mark.parametrize("family", ["lv", "gp"])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_near_collapsible_rows_collapse_only_where_unchanged(n, family):
    """Each block's groups at its level collapse where their kind is
    ``collapse`` or ``uncertain`` (an UNCERTAIN group collapses), and stay
    where one change keeps them (the last Morton member's or the corner's
    state, one member's eff, an UNKNOWN group); nothing collapses above."""
    states = (po.FREE, po.OCCUPIED) + ((po.UNCERTAIN,) if family == "lv" else ())
    levels = n.bit_length() - 1
    kinds = [k for k in NEAR_KINDS if k != "uncertain" or family == "lv"]
    S = len(kinds) * levels
    st, eff = near_collapsible_rows(n, S, states, seed=n)
    vals = {"s": torch.from_numpy(st).float()}
    _, new_eff = pr.prune_blocks(vals, torch.from_numpy(eff), n=n, max_level=levels,
                                 state_fn=lambda v: v["s"].to(torch.int8))
    seen = set()
    for i in range(S):
        L, kind = _near_kinds(n, i, levels, kinds)
        grp = pr._group_view(new_eff[i], n, 1 << L)         # [groups, m³]
        collapsed = (grp == L).all(dim=-1).tolist()
        assert collapsed == [k in ("collapse", "uncertain") for k in kind]
        assert int(new_eff[i].max()) <= L
        seen.update((L, k) for k in kind)
    assert seen == {(L, k) for L in range(1, levels + 1) for k in kinds}


def _jax_gp_light(pool, am, av, pr_, node_idx, slots, scans, depth):
    """la3dm_tpu's _gp_light; its pool has one spare row past the capacity."""
    cap = pool[0].shape[0]
    ext = [jnp.asarray(np.concatenate([x.numpy(), x.numpy()[:1] * 0])) for x in pool]
    out = jgp._gp_light(*ext, jnp.asarray(node_idx.numpy()), jnp.asarray(am.numpy()),
                        jnp.asarray(av.numpy()), jnp.asarray(pr_.numpy()),
                        jnp.asarray(slots.numpy()),
                        jnp.asarray(np.array([s for s, _ in scans], np.int32)),
                        jnp.asarray(np.array([c for _, c in scans], np.int32)),
                        G=7, **GP_BCM, n=2 ** (depth - 1), max_level=depth - 1,
                        state_fn=jpo.GPStateFn(**GP_STATE), do_prune=True,
                        scan_bt=max(c for _, c in scans))
    return [np.asarray(o)[:cap] for o in out]


@pytest.mark.parametrize("seed", [31, 32])
@pytest.mark.parametrize("depth", [3, 4, 5])
def test_gp_light_plain_matches_jax_on_near_collapsible_pools(depth, seed):
    """K5's plain version (BCM, then the prune) against the JAX step at
    4³, 8³ and 16³ voxels a block: m_ivar and ivar bit for bit (the prune
    copies), touched, eff and state equal; every level reached."""
    am, av, pr_, *pool, node_idx, slots = near_gp_light_inputs(seed, depth=depth)
    scans = [(0, 12), (12, 12)]
    ref = _jax_gp_light(pool, am, av, pr_, node_idx, slots, scans, depth)
    for s, c in scans:
        gp_light.gp_light(am, av, pr_, *pool, node_idx, slots, s, c, G=7, **GP_BCM,
                          n=2 ** (depth - 1), max_level=depth - 1,
                          state_fn=po.GPStateFn(**GP_STATE), do_prune=True)
    for ours, r in zip(pool, ref):
        np.testing.assert_array_equal(ours.numpy(), r)
    vals = {"m_ivar": pool[0], "ivar": pool[1], "touched": pool[2].float()}
    jvals = {"m_ivar": jnp.asarray(ref[0]), "ivar": jnp.asarray(ref[1]),
             "touched": jnp.asarray(ref[2].astype(np.float32))}
    np.testing.assert_array_equal(po.GPStateFn(**GP_STATE)(vals).numpy(),
                                  np.asarray(jpo.GPStateFn(**GP_STATE)(jvals)))
    sl = slots[:-1].long()
    assert all((pool[3][sl] == L).any() for L in range(1, depth))


#: the BGK configs' state thresholds (var_thresh, free, occupied)
BGK_STATE = (100.0, 0.3, 0.7)


def _jax_bgk_light(pool, acc, node_idx, slots, scans, n, G):
    """la3dm_tpu's light pass, scan by scan: the body of ``_bgk_seq_step``'s
    ``light_step`` (models/bgk.py:140-177) with the JAX package's
    ``beta_update``, ``prune_blocks`` and ``BetaStateFn``, at the gate 0;
    its pool has one spare row past the capacity (the padding slot's)."""
    cap = pool[0].shape[0]
    A, Bv, touched, eff = (jnp.asarray(np.concatenate([x.numpy(), x.numpy()[:1] * 0]))
                           for x in pool)
    accj, ntab, sl = (jnp.asarray(x.numpy()) for x in (acc, node_idx, slots))
    Tp, V = acc.shape[0], node_idx.shape[1]
    vcol = jnp.arange(V, dtype=jnp.int32)
    brow = jnp.arange(max(c for _, c in scans), dtype=jnp.int32)
    for start, count in scans:
        bidx = jnp.minimum(start + brow, Tp - 1)
        slots_k = jnp.where(brow < count, sl[bidx], cap + 1)
        accb = accj[bidx]
        dAall, dBall, tchall = jkp.beta_update(accb[..., :G], accb[..., G:], 0.0)
        eff_b = eff[jnp.minimum(slots_k, cap)]
        nidx = ntab[eff_b.astype(jnp.int32), vcol[None, :]]
        A = A.at[slots_k].add(jnp.take_along_axis(dAall, nidx, axis=1), mode="drop")
        Bv = Bv.at[slots_k].add(jnp.take_along_axis(dBall, nidx, axis=1), mode="drop")
        touched = touched.at[slots_k].max(jnp.take_along_axis(tchall, nidx, axis=1),
                                          mode="drop")
        safe = jnp.minimum(slots_k, cap)
        vals = {"A": A[safe], "B": Bv[safe], "touched": touched[safe].astype(jnp.float32)}
        new_vals, new_eff = jpr.prune_blocks(vals, eff[safe], n=n, max_level=n.bit_length() - 1,
                                             state_fn=jpo.BetaStateFn(*BGK_STATE))
        A = A.at[slots_k].set(new_vals["A"], mode="drop")
        Bv = Bv.at[slots_k].set(new_vals["B"], mode="drop")
        touched = touched.at[slots_k].set(new_vals["touched"] > 0, mode="drop")
        eff = eff.at[slots_k].set(new_eff, mode="drop")
    return [np.asarray(x)[:cap] for x in (A, Bv, touched, eff)]


@pytest.mark.parametrize("acc", ["gated", "updates"])
@pytest.mark.parametrize("G", bgk_light.SLOT_COUNTS)
@pytest.mark.parametrize("n", [4, 8, 16])
def test_bgk_light_plain_matches_jax_on_near_collapsible_pools(n, G, acc):
    """K2's plain version (the gated Beta update, then the prune) against
    the JAX light pass at 4³, 8³ and 16³ voxels a block, with the 7 face
    neighbours' slots and the 27 of ``predict``, from an accumulator that
    the gate leaves out entirely (the near-collapsible states reach the
    prune as made) and from one that updates every block: A and B bit for
    bit (the updates are sums of eighths, exact in any order), touched, eff
    and state equal; every level reached."""
    depth = n.bit_length()
    a, *pool, node_idx, slots = near_bgk_light_inputs(50 + depth, depth=depth, G=G,
                                                      gated=acc == "gated")
    unpruned = [x.clone() for x in pool]
    bgk_light.bgk_light_plain(a, *unpruned, node_idx, slots, 0, 24, G=G, gate=0.0, n=n,
                              max_level=depth - 1, state_fn=po.BetaStateFn(*BGK_STATE),
                              do_prune=False)
    assert torch.equal(unpruned[0], pool[0]) == (acc == "gated")    # the updates
    scans = [(0, 12), (12, 12)]
    ref = _jax_bgk_light(pool, a, node_idx, slots, scans, n, G)
    before = bgk_light.launches
    for s, c in scans:
        bgk_light.bgk_light(a, *pool, node_idx, slots, s, c, G=G, gate=0.0, n=n,
                            max_level=depth - 1, state_fn=po.BetaStateFn(*BGK_STATE),
                            do_prune=True)
    assert bgk_light.launches == before               # the CPU: the plain version
    for ours, r in zip(pool, ref):
        np.testing.assert_array_equal(ours.numpy(), r)
    vals = {"A": pool[0], "B": pool[1], "touched": pool[2].float()}
    jvals = {"A": jnp.asarray(ref[0]), "B": jnp.asarray(ref[1]),
             "touched": jnp.asarray(ref[2].astype(np.float32))}
    np.testing.assert_array_equal(po.BetaStateFn(*BGK_STATE)(vals).numpy(),
                                  np.asarray(jpo.BetaStateFn(*BGK_STATE)(jvals)))
    sl = slots[:-1].long()
    assert all((pool[3][sl] == L).any() for L in range(1, depth))


@pytest.mark.parametrize("seed", [41, 42])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_lv_prune_plain_matches_jax_on_near_collapsible_pools(n, seed):
    """K8's plain version against the JAX tile-major prune step on
    near-collapsible blocks (OCCUPIED, FREE and UNCERTAIN groups): A and B
    bit for bit, touched, eff and state equal; every level reached."""
    levels = n.bit_length() - 1
    B = 6 * levels
    A, Bv, T, E, slots = near_lv_prune_inputs(seed, n=n, B=B, cap=B + 8)
    perm = geo.tile_vox_map(n).reshape(-1)
    # copies: the JAX step donates its pool inputs
    fields, jt, je = jlv._prune_step_tilemajor(
        {"A": jnp.asarray(A.numpy().copy()), "B": jnp.asarray(Bv.numpy().copy())},
        jnp.asarray(T.numpy().copy()), jnp.asarray(E.numpy().copy()),
        jnp.asarray(slots.numpy()), jnp.asarray(np.argsort(perm)), jnp.asarray(perm),
        state_fn=jpo.LVStateFn(**LV_STATE), n=n, max_level=levels)
    lv_prune.lv_prune(A, Bv, T, E, slots, n=n, max_level=levels,
                      state_fn=po.LVStateFn(**LV_STATE))
    np.testing.assert_array_equal(E.numpy(), np.asarray(je))
    np.testing.assert_array_equal(T.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(A.numpy(), np.asarray(fields["A"]))
    np.testing.assert_array_equal(Bv.numpy(), np.asarray(fields["B"]))
    vals = {"A": A, "B": Bv, "touched": T.float()}
    jvals = {"A": fields["A"], "B": fields["B"], "touched": jt.astype(jnp.float32)}
    np.testing.assert_array_equal(po.LVStateFn(**LV_STATE)(vals).numpy(),
                                  np.asarray(jpo.LVStateFn(**LV_STATE)(jvals)))
    sl = slots[:-1].long()
    assert all((E[sl] == L).any() for L in range(1, levels + 1))
