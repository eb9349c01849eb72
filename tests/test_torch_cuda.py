"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false: a hand-written kernel has no CPU
mode.  The file imports no JAX, so on a machine with a card and without JAX
it runs apart from tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import json
import os

import pytest
import torch

import numpy as np

from la3dm_tpu_torch.geometry import device_ingest
from la3dm_tpu_torch.kernels import (bgk_aligned_heavy, bgk_heavy, bgk_light, gp_heavy,
                                     gp_light, group_prune, ingest_beams, ingest_bucket,
                                     ingest_downsample, ingest_keys, ingest_members,
                                     ingest_rays, ingest_slots, ingest_sort, lv_prune, lv_rows,
                                     raycast)
from la3dm_tpu_torch.models import posterior as po
from la3dm_tpu_torch.pipeline import build_map
from la3dm_tpu_torch.utils import profiling
from la3dm_tpu_torch.utils.config import MapConfig

from torch_cases import (BETA_TEMPLATES, GP_BCM, GP_STATE,  # tests/ on sys.path
                         GP_STATICS, GP_TEMPLATES, INGEST, LV_ROWS_STATICS, LV_STATE,
                         RAY_CONFIGS, aligned_heavy_inputs, beam_edge_hits, beam_kwargs,
                         bucket_inputs, collapsible_raster_pool, edge_rays, gp_heavy_inputs,
                         gp_light_inputs, heavy_inputs, ingest_scene, light_inputs,
                         lv_prune_inputs, lv_rows_inputs, member_entries,
                         near_bgk_light_inputs, near_gp_light_inputs, near_lv_prune_inputs,
                         ray_inputs, raycast_chain_inputs, raycast_inputs)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("G", [7, 27])
def test_bgk_heavy_kernel_matches_plain(cuda_dev, G):
    a = heavy_inputs(9, G=G, n_blocks=40, dev=cuda_dev)
    before = bgk_heavy.launches
    acc = bgk_heavy.bgk_heavy(**a, G=G, sf2=1.0, ell=0.2)
    assert bgk_heavy.launches == before + 1
    ref = bgk_heavy.bgk_heavy_plain(**a, G=G, sf2=1.0, ell=0.2)
    torch.cuda.synchronize()
    assert ((acc - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("G", [7, 27])
def test_bgk_heavy_segment_kernel_matches_plain(cuda_dev, G):
    """K1's segment branch (BGKL): degenerate, sub-threshold and axis-aligned
    segments among the rays."""
    a = heavy_inputs(19, G=G, n_blocks=40, dev=cuda_dev, segments=True)
    before = bgk_heavy.launches
    acc = bgk_heavy.bgk_heavy(**a, G=G, sf2=0.1, ell=0.2)
    assert bgk_heavy.launches == before + 1
    ref = bgk_heavy.bgk_heavy_plain(**a, G=G, sf2=0.1, ell=0.2)
    torch.cuda.synchronize()
    assert ((acc - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all()
    assert (ref[..., G:] > 0).sum() > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [False, True])
def test_bgk_heavy_kernel_equals_plain_bit_for_bit(cuda_dev, segments):
    """K1 sums each row, then adds a block's rows in row order, as its plain
    version does: on blocks of up to three rows the two agree bit for bit."""
    a = heavy_inputs(29, G=7, n_blocks=40, dev=cuda_dev, segments=segments)
    assert int(torch.bincount(a["row_block"].long()).max()) >= 3
    kw = dict(G=7, sf2=0.1 if segments else 1.0, ell=0.2)
    acc = bgk_heavy.bgk_heavy(**a, **kw)
    ref = bgk_heavy.bgk_heavy_plain(**a, **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, ref)


@pytest.mark.cuda
def test_bgk_light_kernel_matches_plain(cuda_dev):
    acc, A, B, touched, eff, node_idx, slots = light_inputs(10, dev=cuda_dev)
    kw = dict(G=7, gate=0.0, n=4, max_level=2,
              state_fn=po.BetaStateFn(100.0, 0.3, 0.7), do_prune=True)
    k = [x.clone() for x in (A, B, touched, eff)]
    p = [x.clone() for x in (A, B, touched, eff)]
    for s, c in ((0, 6), (6, 6)):
        bgk_light.bgk_light(acc, *k, node_idx, slots, s, c, **kw)
        bgk_light.bgk_light_plain(acc, *p, node_idx, slots, s, c, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
    assert (k[0] - p[0]).abs().max() <= 1e-6 and (k[1] - p[1]).abs().max() <= 1e-6


def _collapsible_start(pool, slots, templates, seed):
    """``pool`` with the rows of ``slots`` (padding dropped) replaced by
    :func:`collapsible_raster_pool` rows."""
    cap, V = pool[0].shape
    n = round(V ** (1 / 3))
    sl = slots[slots < cap].long()
    rows = collapsible_raster_pool(n, len(sl), templates, seed=seed)
    out = [x.clone() for x in pool]
    for x, r in zip(out, rows):
        x[sl] = torch.from_numpy(r).to(x.device)
    return out


def _light_runs(kernel, plain, args, pool, scans):
    """The kernel's pool and the plain version's after ``scans``, from
    copies of ``pool``; ``args`` are the wrapper's leading inputs."""
    k = [x.clone() for x in pool]
    p = [x.clone() for x in pool]
    for s, c in scans:
        kernel(*args, *k, s, c)
        plain(*args, *p, s, c)
    torch.cuda.synchronize()
    return k, p


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["prior", "collapsible"])
@pytest.mark.parametrize("depth", [5, 6, 7])
def test_bgk_light_tiled_kernel_equals_plain(cuda_dev, depth, start):
    """K2 on blocks of 16³, 32³ and 64³ voxels (one CTA per 8³ tile, the
    levels across tiles in each block's last CTA): bit for bit, from the
    prior and from a raster pool that collapses at every level."""
    acc, *pool, node_idx, slots = light_inputs(10, depth=depth, dev=cuda_dev)
    if start == "collapsible":
        pool = _collapsible_start(pool, slots, BETA_TEMPLATES, seed=depth)
    n = 2 ** (depth - 1)
    kw = dict(G=7, gate=0.0, n=n, max_level=depth - 1,
              state_fn=po.BetaStateFn(100.0, 0.3, 0.7), do_prune=True)
    before = bgk_light.launches

    def kernel(*a):
        bgk_light.bgk_light(*a[:5], node_idx, slots, *a[5:], **kw)

    def plain(*a):
        bgk_light.bgk_light_plain(*a[:5], node_idx, slots, *a[5:], **kw)

    k, p = _light_runs(kernel, plain, (acc,), pool, [(0, 6), (6, 6)])
    assert bgk_light.launches == before + 2
    for x, y in zip(k, p):
        assert torch.equal(x, y)
    sl = slots[:-1].long()
    assert int((k[3][sl] == depth - 1).sum()) >= n ** 3   # a whole block collapsed
    assert start == "prior" or (k[3][sl] == 1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("G", bgk_light.SLOT_COUNTS)
@pytest.mark.parametrize("start", ["prior", "collapsible", "near"])
@pytest.mark.parametrize("depth", [2, 3, 4, 5, 6, 7])
def test_bgk_light_kernel_equals_plain_on_every_pool(cuda_dev, depth, start, G):
    """K2 at 2³ (eight blocks a CTA), 4³, 8³ (a block a CTA), 16³, 32³ and
    64³ (a CTA a tile, the levels across tiles in each block's last CTA),
    with the 7 face neighbours' slots and the 27 of ``predict``, from the
    prior, from a raster pool that collapses at every level and from
    near-collapsible blocks (each group one change from collapsing): bit
    for bit with its plain version; every level reached from the
    near-collapsible blocks, the first and the block's own from the
    collapsible pool (its cubes have edges n, 8, 4 and 2)."""
    n = 2 ** (depth - 1)
    if start == "near":
        acc, *pool, node_idx, slots = near_bgk_light_inputs(40 + depth, depth=depth, G=G,
                                                            dev=cuda_dev)
        scans = [(0, 12), (12, 12)]
    else:
        acc, *pool, node_idx, slots = light_inputs(40 + depth, G=G, depth=depth,
                                                   dev=cuda_dev)
        if start == "collapsible":
            pool = _collapsible_start(pool, slots, BETA_TEMPLATES, seed=depth)
        scans = [(0, 6), (6, 6)]
    kw = dict(G=G, gate=0.0, n=n, max_level=depth - 1,
              state_fn=po.BetaStateFn(100.0, 0.3, 0.7), do_prune=True)
    before = bgk_light.launches

    def kernel(*a):
        bgk_light.bgk_light(*a[:5], node_idx, slots, *a[5:], **kw)

    def plain(*a):
        bgk_light.bgk_light_plain(*a[:5], node_idx, slots, *a[5:], **kw)

    k, p = _light_runs(kernel, plain, (acc,), pool, scans)
    assert bgk_light.launches == before + 2
    for x, y in zip(k, p):
        assert torch.equal(x, y)
    sl = slots[:-1].long()
    levels = {"prior": [], "collapsible": [1, depth - 1], "near": range(1, depth)}[start]
    assert all((k[3][sl] == L).any() for L in levels)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["prior", "collapsible"])
def test_gp_light_tiled_kernel_equals_plain(cuda_dev, start):
    """K5 on blocks of 16³ voxels: bit for bit with its plain version."""
    am, av, pr, *pool, node_idx, slots = gp_light_inputs(16, depth=5, dev=cuda_dev)
    if start == "collapsible":
        pool = _collapsible_start(pool, slots, GP_TEMPLATES, seed=5)
    kw = dict(G=7, **GP_BCM, n=16, max_level=4, state_fn=po.GPStateFn(**GP_STATE),
              do_prune=True)
    before = gp_light.launches

    def kernel(*a):
        gp_light.gp_light(*a[:7], node_idx, slots, *a[7:], **kw)

    def plain(*a):
        gp_light.gp_light_plain(*a[:7], node_idx, slots, *a[7:], **kw)

    k, p = _light_runs(kernel, plain, (am, av, pr), pool, [(0, 6), (6, 6)])
    assert gp_light.launches == before + 2
    for x, y in zip(k, p):
        assert torch.equal(x, y)
    assert int((k[3][slots[:-1].long()] == 4).sum()) >= 4096


@pytest.mark.cuda
@pytest.mark.parametrize("G", gp_light.SLOT_COUNTS)
@pytest.mark.parametrize("depth", [2, 3, 4, 5])
def test_gp_light_kernel_equals_plain_on_near_collapsible_pools(cuda_dev, depth, G):
    """K5 at 2³ (eight blocks a CTA), 4³, 8³ and 16³, with the 7 face
    neighbours' slots and the 27 of ``predict``, on blocks whose groups are
    each one change away from collapsing
    (kernels/group_prune.py::near_collapsible_rows): bit for bit with its
    plain version, every level reached, across tiles at 16³."""
    am, av, pr, *pool, node_idx, slots = near_gp_light_inputs(23, depth=depth, G=G,
                                                              dev=cuda_dev)
    kw = dict(G=G, **GP_BCM, n=2 ** (depth - 1), max_level=depth - 1,
              state_fn=po.GPStateFn(**GP_STATE), do_prune=True)
    before = gp_light.launches

    def kernel(*a):
        gp_light.gp_light(*a[:7], node_idx, slots, *a[7:], **kw)

    def plain(*a):
        gp_light.gp_light_plain(*a[:7], node_idx, slots, *a[7:], **kw)

    k, p = _light_runs(kernel, plain, (am, av, pr), pool, [(0, 12), (12, 12)])
    assert gp_light.launches == before + 2
    for x, y in zip(k, p):
        assert torch.equal(x, y)
    sl = slots[:-1].long()
    assert all((k[3][sl] == L).any() for L in range(1, depth))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64])
def test_lv_prune_kernel_equals_plain_on_near_collapsible_pools(cuda_dev, n):
    """K8 at 2³ to 64³ on near-collapsible blocks (OCCUPIED,
    FREE and UNCERTAIN groups): bit for bit with its plain version, every
    level reached, the levels across tiles included."""
    levels = n.bit_length() - 1
    B = 6 * levels                     # every kind at every level
    pool = near_lv_prune_inputs(29, n=n, B=B, cap=B + 8, dev=cuda_dev)
    kw = dict(n=n, max_level=levels, state_fn=po.LVStateFn(**LV_STATE))
    k = [x.clone() for x in pool[:4]]
    p = [x.clone() for x in pool[:4]]
    before = lv_prune.launches
    lv_prune.lv_prune(*k, pool[4], **kw)
    assert lv_prune.launches == before + 1
    lv_prune.lv_prune_plain(*p, pool[4], **kw)
    torch.cuda.synchronize()
    for x, y in zip(k, p):
        assert torch.equal(x, y)
    sl = pool[4][:-1].long()
    assert all((k[3][sl] == L).any() for L in range(1, levels + 1))


@pytest.mark.cuda
def test_prune_kernels_leave_their_counters_zero(cuda_dev):
    """K5 at 16³ and K8 at 32³ keep their tile scratch per device and
    stream: each block's last CTA sets its counter back to zero, so the next
    launch finds them zero; launches from the same start give the same
    bits, and the counters are zero after them."""
    pool = near_lv_prune_inputs(37, n=32, B=30, cap=38, dev=cuda_dev)
    kw = dict(n=32, max_level=5, state_fn=po.LVStateFn(**LV_STATE))
    runs = []
    for _ in range(3):
        k = [x.clone() for x in pool[:4]]
        lv_prune.lv_prune(*k, pool[4], **kw)
        runs.append(k)
    am, av, pr, *gpool, node_idx, slots = near_gp_light_inputs(38, depth=5, dev=cuda_dev)
    gkw = dict(G=7, **GP_BCM, n=16, max_level=4, state_fn=po.GPStateFn(**GP_STATE),
               do_prune=True)
    gruns = []
    for _ in range(3):
        k = [x.clone() for x in gpool]
        for s, c in ((0, 12), (12, 12)):
            gp_light.gp_light(am, av, pr, *k, node_idx, slots, s, c, **gkw)
        gruns.append(k)
    torch.cuda.synchronize()
    for a, b in ((runs[0], runs[1]), (runs[0], runs[2]), (gruns[0], gruns[1]),
                 (gruns[0], gruns[2])):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    key = (str(pool[0].device), torch.cuda.current_stream(cuda_dev).cuda_stream)
    assert int(torch.count_nonzero(group_prune._SCRATCH[key][3])) == 0
    assert (runs[0][3][pool[4][:-1].long()] == 5).any()


@pytest.mark.cuda
def test_light_tiled_kernels_repeat_and_skip_padding(cuda_dev):
    """K2 and K5 at 16³: a padding slot inside a scan's range leaves every
    tile of that block alone (no row outside the scans' slots moves), and a
    second run from the same start gives the same bits (the last CTA of
    each block is found anew on every launch)."""
    acc, *pool, node_idx, slots = light_inputs(12, depth=5, dev=cuda_dev)
    cap = pool[0].shape[0]
    slots[3] = cap                                     # padding inside scan 1
    pool = _collapsible_start(pool, slots, BETA_TEMPLATES, seed=3)
    kw = dict(G=7, gate=0.0, n=16, max_level=4,
              state_fn=po.BetaStateFn(100.0, 0.3, 0.7), do_prune=True)
    am, av, pr, *gpool, gnode_idx, gslots = gp_light_inputs(17, depth=5, dev=cuda_dev)
    gslots[4] = cap
    gpool = _collapsible_start(gpool, gslots, GP_TEMPLATES, seed=4)
    gkw = dict(G=7, **GP_BCM, n=16, max_level=4, state_fn=po.GPStateFn(**GP_STATE),
               do_prune=True)

    def k2(st):
        for s, c in ((0, 6), (6, 6)):
            bgk_light.bgk_light(acc, *st, node_idx, slots, s, c, **kw)
        return st

    def k5(st):
        for s, c in ((0, 6), (6, 6)):
            gp_light.gp_light(am, av, pr, *st, gnode_idx, gslots, s, c, **gkw)
        return st

    for run, start, sl, plain in (
            (k2, pool, slots, lambda st: [bgk_light.bgk_light_plain(
                acc, *st, node_idx, slots, s, c, **kw) for s, c in ((0, 6), (6, 6))]),
            (k5, gpool, gslots, lambda st: [gp_light.gp_light_plain(
                am, av, pr, *st, gnode_idx, gslots, s, c, **gkw)
                for s, c in ((0, 6), (6, 6))])):
        first = run([x.clone() for x in start])
        second = run([x.clone() for x in start])
        p = [x.clone() for x in start]
        plain(p)
        torch.cuda.synchronize()
        outside = torch.ones(cap, dtype=torch.bool, device=cuda_dev)
        outside[sl[sl < cap].long()] = False
        for a, b, c, s0 in zip(first, second, p, start):
            assert torch.equal(a, b) and torch.equal(a, c)
            assert torch.equal(a[outside], s0[outside])
        assert (first[3][sl[sl < cap].long()] == 4).any()


@pytest.mark.cuda
def test_light_wrappers_refuse_blocks_above_64_voxels_an_edge(cuda_dev):
    acc, *pool, node_idx, slots = light_inputs(13, dev=cuda_dev)
    big = [torch.zeros((1, 128 ** 3), dtype=x.dtype, device=cuda_dev) for x in pool]
    with pytest.raises(ValueError, match="≤ 64"):
        bgk_light.bgk_light(acc, *big, node_idx, slots, 0, 1, G=7, gate=0.0, n=128,
                            max_level=7, state_fn=po.BetaStateFn(100.0, 0.3, 0.7),
                            do_prune=True)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [3, 5, 6])
def test_lv_rows_kernel_matches_plain(cuda_dev, depth):
    a = lv_rows_inputs(12, depth=depth, dev=cuda_dev)
    k = [x.clone() for x in a[:4]]
    p = [x.clone() for x in a[:4]]
    before = lv_rows.launches
    lv_rows.lv_rows(*k, *a[4:], **LV_ROWS_STATICS)
    assert lv_rows.launches == before + 1
    lv_rows.lv_rows_plain(*p, *a[4:], **LV_ROWS_STATICS)
    torch.cuda.synchronize()
    # the same sums in the same order; sinf/cosf and the plain version's
    # separate ops round alike, so 1e-5 relative covers the rest
    for x, y in zip(k[:2], p[:2]):
        assert ((x - y).abs() <= 1e-5 + 1e-5 * y.abs()).all()
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], a[3])
    assert (k[0] != a[0]).any()


def _lv_rows_every_scan(dev):
    """A 12-scan dispatch in which one pool row is reached by every scan,
    with its padding tile (slot == cap) and one more in the middle."""
    a = list(lv_rows_inputs(61, depth=5, n_scans=12, tiles_per_scan=5, dev=dev))
    slots, pos = a[11], a[12]
    slots[0:-1:5], pos[0:-1:5] = 2, 3        # the first tile of each scan
    slots[7] = a[0].shape[0]                 # a padding tile among them
    return a


def _lv_culled(a):
    """The (warp, entry) pairs of real tiles that lv_rows_cull skips."""
    vbt, ent, _, ids, rt, rs, rn, slots, pos, ctr = a[4:]
    cull = lv_rows.lv_rows_cull(vbt, ent, ids, rt, rs, rn, pos, ctr,
                                ell=LV_ROWS_STATICS["ell"])
    real = slots[rt.long()] < a[0].shape[0]
    return int(cull[real].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("max_rows", [None, 9])
def test_lv_rows_kernel_pool_row_of_every_scan(cuda_dev, max_rows, monkeypatch):
    """K3 on a pool row that all 12 scans reach, with padding tiles: the
    plain version's limit, chunks of the tile list (a scratch cap of
    ``max_rows`` rows) bit-equal to one chunk, two launches bit-equal, the
    warps' own cull count that of lv_rows_cull."""
    a = _lv_rows_every_scan(cuda_dev)
    p = [x.clone() for x in a[:4]]
    lv_rows.lv_rows_plain(*p, *a[4:], **LV_ROWS_STATICS)
    one = [x.clone() for x in a[:4]]
    lv_rows.lv_rows(*one, *a[4:], **LV_ROWS_STATICS)
    if max_rows is not None:
        monkeypatch.setattr(lv_rows, "SCRATCH_BYTES", max_rows * 8 * a[4].shape[1])
    runs = []
    for _ in range(2):
        k = [x.clone() for x in a[:4]]
        culled = torch.zeros(1, dtype=torch.int64, device=cuda_dev)
        lv_rows.lv_rows(*k, *a[4:], **LV_ROWS_STATICS, culled=culled)
        runs.append((k, int(culled)))
    torch.cuda.synchronize()
    k = runs[0][0]
    for x, y in zip(k[:2], p[:2]):
        assert ((x - y).abs() <= 1e-5 + 1e-5 * y.abs()).all()
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], a[3])
    assert all(torch.equal(x, y) for x, y in zip(k, runs[1][0]))
    assert all(torch.equal(x, y) for x, y in zip(k, one))
    assert runs[0][1] == runs[1][1] == _lv_culled(a) > 0
    assert (k[0][2].view(-1, 512)[3] != a[0][2].view(-1, 512)[3]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [3, 5, 6])
def test_lv_rows_kernel_repeats_and_counts_its_cull(cuda_dev, depth):
    a = lv_rows_inputs(13, depth=depth, dev=cuda_dev)
    outs = []
    for _ in range(2):
        k = [x.clone() for x in a[:4]]
        culled = torch.zeros(1, dtype=torch.int64, device=cuda_dev)
        lv_rows.lv_rows(*k, *a[4:], **LV_ROWS_STATICS, culled=culled)
        outs.append((k, int(culled)))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(outs[0][0], outs[1][0]))
    assert outs[0][1] == outs[1][1] == _lv_culled(a)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [7, 27])
@pytest.mark.parametrize("depth,res,ell", [(3, 0.1, 0.2), (5, 0.2, 0.6)])
def test_bgk_heavy_segment_kernel_equals_plain_at_depth(cuda_dev, depth, res, ell, G):
    """K1's segment branch at block_depth 3 (73 nodes) and 5 (4681): bit for
    bit its plain version, twice; the warps' cull count that of
    bgk_heavy_cull."""
    a = heavy_inputs(37, G=G, n_blocks=6 if depth == 5 else 40, dev=cuda_dev,
                     segments=True, depth=depth, res=res)
    kw = dict(G=G, sf2=0.1, ell=ell)
    ref = bgk_heavy.bgk_heavy_plain(**a, **kw)
    accs, counts = [], []
    for _ in range(2):
        culled = torch.zeros(1, dtype=torch.int64, device=cuda_dev)
        accs.append(bgk_heavy.bgk_heavy(**a, **kw, culled=culled))
        counts.append(int(culled))
    torch.cuda.synchronize()
    assert torch.equal(accs[0], ref) and torch.equal(accs[1], ref)
    cull = bgk_heavy.bgk_heavy_cull(a["entries"], a["ids"], a["row_block"], a["row_start"],
                                    a["row_count"], a["centers"], a["all_nodes"], ell=ell)
    assert counts[0] == counts[1] == int(cull.sum()) > 0
    assert (ref[..., G:] > 0).sum() > 1000


def _k1_launch_and_check(a, kw):
    """K1 twice with its cull counter, against its plain version: bit for
    bit, both launches; each count that of ``bgk_heavy_cull``.  Returns
    (plain acc, culled pairs)."""
    before = bgk_heavy.launches
    accs, counts = [], []
    for _ in range(2):
        culled = torch.zeros(1, dtype=torch.int64, device=a["entries"].device)
        accs.append(bgk_heavy.bgk_heavy(**a, **kw, culled=culled))
        counts.append(int(culled))
    assert bgk_heavy.launches == before + 2
    ref = bgk_heavy.bgk_heavy_plain(**a, **kw)
    torch.cuda.synchronize()
    assert torch.equal(accs[0], ref) and torch.equal(accs[1], ref)
    cull = bgk_heavy.bgk_heavy_cull(a["entries"], a["ids"], a["row_block"], a["row_start"],
                                    a["row_count"], a["centers"], a["all_nodes"],
                                    ell=kw["ell"])
    assert counts[0] == counts[1] == int(cull.sum())
    return ref, counts[0]


@pytest.mark.cuda
@pytest.mark.parametrize("G", [7, 27])
@pytest.mark.parametrize("depth,res,ell", [(3, 0.1, 0.2), (5, 0.2, 0.6)])
def test_bgk_heavy_point_kernel_equals_plain_at_depth(cuda_dev, depth, res, ell, G):
    """K1's point branch (BGK) at block_depth 3 (73 nodes) and 5 (4681): bit
    for bit its plain version, twice; the warps' cull count that of
    bgk_heavy_cull."""
    a = heavy_inputs(39, G=G, n_blocks=6 if depth == 5 else 40, dev=cuda_dev, depth=depth,
                     res=res)
    ref, culled = _k1_launch_and_check(a, dict(G=G, sf2=1.0, ell=ell))
    assert (ref[..., G:] > 0).sum() > 1000 and culled > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rows", "all_culled", "far_30", "far_100", "no_test_block"])
def test_bgk_heavy_point_kernel_edge_cases(cuda_dev, case):
    """K1's point branch where its walk turns: rows of 1, 31, 32, 33 and 64
    entries and a 65-entry block (rows of 64 and 1), a block with no rows, a
    block whose entries all cull (moved 100 m off), block centres 30 m and
    100 m from the origin, and Tp = 0; bit for bit its plain version,
    twice, with its cull count the predicate's."""
    G, kw = 27, dict(G=27, sf2=1.0, ell=0.2)
    counts = [1, 31, 32, 33, 64, 0, 65, 100]
    offset = {"far_30": 30.0, "far_100": 100.0}.get(case, 0.0)
    a = heavy_inputs(59, G=G, dev=cuda_dev, counts=counts, offset=offset)
    if case == "no_test_block":
        acc = bgk_heavy.bgk_heavy(**{**a, "centers": a["centers"][:0].contiguous()}, **kw)
        assert acc.shape == (0, 73, 2 * G)
        return
    if case == "all_culled":
        # block 7's 100 entries lie 100 m away
        s7 = sum(counts[:7])
        a["entries"][s7:s7 + 100] += 100.0
    ref, culled = _k1_launch_and_check(a, kw)
    assert (ref[..., G:] > 0).sum() > 100
    assert int(torch.count_nonzero(ref[5])) == 0               # the block without rows
    if case == "all_culled":
        assert int(torch.count_nonzero(ref[7])) == 0
        assert culled >= 100 * 3                  # every warp (3 a block) skips them all


@pytest.mark.cuda
def test_sparse_kernel_is_zero_from_r_c_on_the_card(cuda_dev):
    """The r_c scan: the segment kernel's own sparse_kernel_r is exactly 0
    at every f32 r in [R_CULL, 2)."""
    r = torch.arange(0x3F800000, 0x40000000, dtype=torch.int32,
                     device=cuda_dev).view(torch.float32)
    assert float(r[0]) == bgk_heavy.R_CULL
    for sf2 in (0.1, 1.0):
        k = bgk_heavy.sparse_kernel_scan(r, sf2)
        assert int(torch.count_nonzero(k)) == 0
        assert (bgk_heavy.sparse_kernel_scan(r - 0.5, sf2) > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 16, 32])
def test_lv_prune_kernel_matches_plain(cuda_dev, n):
    pool = lv_prune_inputs(13, n=n, dev=cuda_dev)
    kw = dict(n=n, max_level=n.bit_length() - 1, state_fn=po.LVStateFn(**LV_STATE))
    k = [x.clone() for x in pool[:4]]
    p = [x.clone() for x in pool[:4]]
    before = lv_prune.launches
    lv_prune.lv_prune(*k, pool[4], **kw)
    assert lv_prune.launches == before + 1
    lv_prune.lv_prune_plain(*p, pool[4], **kw)
    torch.cuda.synchronize()
    # copies and f32 state rules only: bit-identical
    for x, y in zip(k, p):
        assert torch.equal(x, y)
    assert int(k[3].max()) == kw["max_level"]


@pytest.mark.cuda
@pytest.mark.parametrize("depth,S", [(3, 128), (4, 128), (3, 256), (4, 512)])
def test_gp_heavy_kernel_matches_plain(cuda_dev, depth, S):
    """Both tiers (models up to 128 points: at most two factor tiles; more
    above) against the plain version (cuSOLVER/cuBLAS through torch.linalg):
    the factor's rounding order differs, so means agree to
    1e-3 + 1e-3·|plain| (α = K⁻¹y carries the Gram's conditioning) and
    variances to 1e-4 + 1e-4·|plain|."""
    a = gp_heavy_inputs(14, depth=depth, S=S, dev=cuda_dev)
    p = {k: v.clone() for k, v in a.items()}
    hc = a["counts"].cpu().numpy()
    before = gp_heavy.launches
    gp_heavy.gp_heavy(**a, host_counts=hc, **GP_STATICS)
    assert gp_heavy.launches == before + 1
    gp_heavy.gp_heavy_plain(**p, cmax=int(hc.max()), **GP_STATICS)
    torch.cuda.synchronize()
    assert torch.equal(a["present"], p["present"]) and int(a["present"].sum()) > 50
    assert int(a["failed"]) == int(p["failed"]) == 0
    for k, tol in (("acc_mean", 1e-3), ("acc_var", 1e-4)):
        x, y = a[k], p[k]
        assert torch.isfinite(x).all()
        assert ((x - y).abs() <= tol + tol * y.abs()).all(), k


@pytest.mark.cuda
def test_gp_heavy_kernel_fails_like_plain(cuda_dev):
    """A Gram that is not positive definite (negative noise) gives NaN
    outputs and counts the model; the one-point model still factors."""
    a = gp_heavy_inputs(15, dev=cuda_dev)
    p = {k: v.clone() for k, v in a.items()}
    kw = dict(sf2=1.0, ell=1.0, noise=-0.5)
    gp_heavy.gp_heavy(**a, host_counts=a["counts"].cpu().numpy(), **kw)
    gp_heavy.gp_heavy_plain(**p, cmax=128, **kw)
    torch.cuda.synchronize()
    assert int(a["failed"]) == int(p["failed"]) == a["counts"].numel() - 1
    assert torch.equal(torch.isnan(a["acc_mean"]), torch.isnan(p["acc_mean"]))
    assert torch.equal(torch.isnan(a["acc_var"]), torch.isnan(p["acc_var"]))


def _k4(a, **kw):
    """K4 and its plain version on copies of the inputs ``a``: (kernel
    tables, plain tables)."""
    k = {n: v.clone() for n, v in a.items()}
    p = {n: v.clone() for n, v in a.items()}
    hc = a["counts"].cpu().numpy()
    statics = {**GP_STATICS, **kw}
    gp_heavy.gp_heavy(**k, host_counts=hc, **statics)
    gp_heavy.gp_heavy_plain(**p, cmax=int(hc.max()), **statics)
    torch.cuda.synchronize()
    return k, p


def _close(k, p, tol=(1e-3, 1e-5), rows=None):
    """present equal, no failure, and |Δ|/(1+|plain|) within ``tol``
    (means, variances) on the served rows."""
    assert torch.equal(k["present"], p["present"])
    assert int(k["failed"]) == int(p["failed"]) == 0
    rows = k["present"] if rows is None else rows
    for name, t in zip(("acc_mean", "acc_var"), tol):
        x, y = k[name][rows], p[name][rows]
        assert torch.isfinite(x).all(), name
        assert ((x - y).abs() <= t * (1 + y.abs())).all(), name


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [[1], [1, 1, 2], [128, 129], [100, 150, 64, 65, 17],
                                    [300]])
@pytest.mark.parametrize("depth", [3, 4])
def test_gp_heavy_kernel_tile_edges(cuda_dev, counts, depth):
    """Models of 1 point, at the tier boundary (128: two factor tiles; 129:
    three), counts that are no multiple of a tile (16 or 64), the single
    300-point model; at depth 3 (73 nodes) and depth 4 (585 nodes, no
    multiple of the query tile), against the plain version at the limits
    of chip_smoke.py (means 1e-3 up to 128 points, 4e-3 above; variances
    1e-5, relative to 1 + |plain|)."""
    a = gp_heavy_inputs(40, depth=depth, counts=counts, dev=cuda_dev)
    Vall = a["all_nodes"].shape[0]
    nq, n_tiles, _ = gp_heavy.predict_tiling(-(-max(counts) // 16) * 16, Vall)
    assert depth == 3 or (n_tiles > 1 and Vall % nq)
    k, p = _k4(a)
    _close(k, p, (1e-3 if max(counts) <= 128 else 4e-3, 1e-5))
    assert int(k["present"].sum()) > 0


@pytest.mark.cuda
def test_gp_heavy_kernel_skips_models_without_slots(cuda_dev):
    """A model that serves no slot writes nothing; rows no model serves
    keep the tables' fill."""
    a = gp_heavy_inputs(41, n_models=6, dev=cuda_dev)
    Tp = a["centers"].shape[0]
    a["nb_rows"][2] = Tp
    a["nb_rows"][4, :3] = Tp + 3
    k, p = _k4(a)
    _close(k, p)
    idle = ~k["present"]
    assert idle.any() and (k["acc_var"][idle] == 1).all() and (k["acc_mean"][idle] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("S", [24, 150])
def test_gp_heavy_kernel_fails_one_model(cuda_dev, S):
    """One model with a NaN point among good ones: its pivots are NaN, so
    it fails alone (``failed`` == 1), NaN in exactly its served rows, the
    other models' rows as the plain version's; models of up to 24 points
    (factored one a warp, a base tier) and up to 150 (tiles)."""
    a = gp_heavy_inputs(42, S=S, n_models=6, dev=cuda_dev)
    bad = 3
    st = int(a["starts"][bad])
    a["pts"][st + 5, 1] = float("nan")
    k = {n: v.clone() for n, v in a.items()}
    gp_heavy.gp_heavy(**k, host_counts=a["counts"].cpu().numpy(), **GP_STATICS)
    torch.cuda.synchronize()
    assert int(k["failed"]) == 1
    G, Tp = a["nb_rows"].shape[1], a["centers"].shape[0]
    nb = a["nb_rows"][bad].long()
    bad_rows = torch.zeros_like(k["present"])
    bad_rows[(nb * G + torch.arange(G, device=cuda_dev))[nb < Tp]] = True
    nan_rows = torch.isnan(k["acc_mean"]).all(1) & torch.isnan(k["acc_var"]).all(1)
    assert torch.equal(nan_rows, bad_rows) and bad_rows.any()
    assert not torch.isnan(k["acc_mean"][~bad_rows]).any()
    good = {n: v.clone() for n, v in a.items()}
    good["pts"][st + 5, 1] = a["pts"][st + 4, 1]
    good["nb_rows"][bad] = Tp
    kg, pg = _k4(good)
    _close(kg, pg, (4e-3, 1e-5))
    served = kg["present"]
    for name in ("acc_mean", "acc_var"):
        assert torch.equal(k[name][served], kg[name][served])
    assert torch.equal(k["present"], kg["present"] | bad_rows)


def _f64_pivot_test_fails(x, noise, sf2=1.0, ell=1.0) -> bool:
    """LAPACK's pivot test in f64 on the f32 Gram of points ``x`` [c, 3]
    (the plain version's arithmetic): True where the factor fails."""
    p = x.astype(np.float32) * np.float32(1.73205 / ell)
    d = p[:, None, :] - p[None, :, :]
    d2 = d[..., 0] * d[..., 0]
    d2 = d2 + d[..., 1] * d[..., 1]
    d2 = d2 + d[..., 2] * d[..., 2]
    r = np.sqrt(d2)
    gram = (np.float32(1) + r) * np.exp(-r) * np.float32(sf2)
    gram[np.diag_indices(len(x))] += np.float32(noise)
    try:
        np.linalg.cholesky(gram.astype(np.float64))
    except np.linalg.LinAlgError:
        return True
    return False


@pytest.mark.cuda
@pytest.mark.parametrize("noise", ["rounds_away", "c_eps"])
@pytest.mark.parametrize("S", [24, 100, 150])
def test_gp_heavy_kernel_near_singular_gram(cuda_dev, S, noise):
    """K4 factors in f64 from the f32 Gram; the plain version (and the JAX
    step) factor in f32.  Three models of S points: 0 spaced 3 m apart
    (well conditioned), 1 the same with points 0 and 1 equal, 2 with its
    first 24 points equal; noise 1e-9 (1 + noise rounds to 1 in f32: models
    1 and 2 are singular, their second pivot exactly 0) or S·2⁻²³ (f32 eps
    times c: the smallest eigenvalue is the noise).  K4 fails exactly the
    models that LAPACK's pivot test fails in f64 on the same f32 Gram, and
    never one that the f32 plain version factors; the verdicts are printed
    (``-s``).  Model 0's rows agree with the plain version's at the base
    limits of chip_smoke.py."""
    eps_noise = S * 2.0 ** -23
    nz = 1e-9 if noise == "rounds_away" else eps_noise
    a = gp_heavy_inputs(46, counts=[S, S, S], dev=cuda_dev)
    pts = a["pts"].cpu().numpy()
    starts = a["starts"].cpu().numpy()
    line = np.zeros((S, 3), np.float32)
    line[:, 0] = 3.0 * np.arange(S)
    for m, dup in enumerate([0, 2, 24]):
        x = pts[starts[m]] + line
        x[:dup] = x[0]
        pts[starts[m]:starts[m] + S] = x
    a["pts"] = torch.from_numpy(pts).to(cuda_dev)
    ref = [_f64_pivot_test_fails(pts[starts[m]:starts[m] + S], nz) for m in range(3)]
    assert ref == ([False, True, True] if noise == "rounds_away" else [False] * 3)
    k, p = _k4(a, noise=nz)
    G, Tp = a["nb_rows"].shape[1], a["centers"].shape[0]

    def failed_models(t):
        out = []
        for m in range(3):
            nb = a["nb_rows"][m].long()
            rows = (nb * G + torch.arange(G, device=cuda_dev))[nb < Tp]
            out.append(bool(torch.isnan(t["acc_mean"][rows]).all()))
        return out

    kf, pf = failed_models(k), failed_models(p)
    print(f"S {S}, noise {nz:.3g}: f64 pivot test fails {ref}, K4 {kf} "
          f"(failed {int(k['failed'])}), f32 plain {pf} (failed {int(p['failed'])})")
    assert torch.equal(k["present"], p["present"])
    assert kf == ref and int(k["failed"]) == sum(ref)
    assert all(pm or not km for km, pm in zip(kf, pf))
    nb = a["nb_rows"][0].long()
    rows = (nb * G + torch.arange(G, device=cuda_dev))[nb < Tp]
    for name, t in (("acc_mean", 1e-3), ("acc_var", 1e-5)):
        x, y = k[name][rows], p[name][rows]
        assert torch.isfinite(x).all() and ((x - y).abs() <= t * (1 + y.abs())).all(), name


@pytest.mark.cuda
@pytest.mark.parametrize("S", [60, 300])
def test_gp_heavy_kernel_repeats_bit_for_bit(cuda_dev, S):
    """Two launches on the same inputs give equal tables: no float atomics,
    a fixed summation order (a base tier's warp units and the CTA units
    above)."""
    a = gp_heavy_inputs(43, depth=4, S=S, dev=cuda_dev)
    k1, _ = _k4(a)
    k2 = {n: v.clone() for n, v in a.items()}
    gp_heavy.gp_heavy(**k2, host_counts=a["counts"].cpu().numpy(), **GP_STATICS)
    torch.cuda.synchronize()
    for name in ("acc_mean", "acc_var", "present", "failed"):
        assert torch.equal(k1[name], k2[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("S", [100, 200])
def test_gp_heavy_kernel_global_ks_and_chunks_equal_shared(cuda_dev, monkeypatch, S):
    """The tier cut into several workspace chunks and, above the base tier,
    Ks in the global workspace (a shared-memory budget too small for 16
    columns) run the same sums: bit-equal tables."""
    a = gp_heavy_inputs(44, depth=4, S=S, dev=cuda_dev)
    ref, _ = _k4(a)
    monkeypatch.setattr(gp_heavy, "_SMEM_BYTES", 4096)
    monkeypatch.setattr(gp_heavy, "_WS_ELEMS", 3 * (2 * S) ** 2 // 4)
    hc = a["counts"].cpu().numpy()
    if S > gp_heavy.BASE_MAX_C:  # a base tier's Ks is always in shared memory
        assert not gp_heavy.predict_tiling(int(-(-hc.max() // 16) * 16), 585)[2]
    assert len(gp_heavy.plan_chunks(hc)) > 2
    k = {n: v.clone() for n, v in a.items()}
    gp_heavy.gp_heavy(**k, host_counts=hc, **GP_STATICS)
    torch.cuda.synchronize()
    for name in ("acc_mean", "acc_var", "present"):
        assert torch.equal(k[name], ref[name]), name


@pytest.mark.cuda
def test_gp_heavy_kernel_2000_points_near_f64(cuda_dev):
    """One model of 2,000 points in a 3.2 m block (block_depth 5 at 0.2 m,
    ℓ = 1): held against the plain version in f64, the kernel's largest
    |Δ|/(1+|f64|) at most twice the f32 plain version's (cuSOLVER), as
    chip_smoke.py holds the block_depth-5 tier."""
    a = gp_heavy_inputs(45, depth=5, counts=[2000], G=3, dev=cuda_dev)
    k, p = _k4(a)
    assert torch.equal(k["present"], p["present"]) and int(k["failed"]) == 0
    r = {n: v.clone() for n, v in a.items()}
    r["acc_mean"], r["acc_var"] = r["acc_mean"].double(), r["acc_var"].double()
    gp_heavy.gp_heavy_plain(**{**r, **{n: r[n].double() for n in
                                       ("pts", "lab", "centers", "all_nodes")}},
                            cmax=2000, **GP_STATICS)
    torch.cuda.synchronize()
    rows = k["present"]
    assert rows.sum() >= 2
    for name in ("acc_mean", "acc_var"):
        ref = r[name][rows]
        def err(t):
            return float(((t[name][rows].double() - ref).abs() / (1 + ref.abs())).max())
        assert err(k) <= 2 * err(p), (name, err(k), err(p))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [3, 4])
def test_gp_light_kernel_matches_plain(cuda_dev, depth):
    am, av, pr, *pool, node_idx, slots = gp_light_inputs(16, depth=depth, dev=cuda_dev)
    kw = dict(G=7, **GP_BCM, n=2 ** (depth - 1), max_level=depth - 1,
              state_fn=po.GPStateFn(**GP_STATE), do_prune=True)
    k = [x.clone() for x in pool]
    p = [x.clone() for x in pool]
    before = gp_light.launches
    for s, c in ((0, 6), (6, 6)):
        gp_light.gp_light(am, av, pr, *k, node_idx, slots, s, c, **kw)
        gp_light.gp_light_plain(am, av, pr, *p, node_idx, slots, s, c, **kw)
    torch.cuda.synchronize()
    assert gp_light.launches == before + 2
    # the same operations in the same order: bit-identical
    for x, y in zip(k, p):
        assert torch.equal(x, y)
    assert int(k[3].max()) == depth - 1


def _ingest_params():
    ds, fr, mr = INGEST["ds"], INGEST["fr"], INGEST["mr"]
    return dict(inv_leaf=float(np.float32(1 / ds)),
                lim=float(np.float32((mr + np.sqrt(3.0) * ds) ** 2)),
                kf=device_ingest.beam_slots(ds, fr, mr, INGEST["block_size"]),
                mr=float(np.float32(mr)), fr=float(np.float32(fr)), leaf=float(np.float32(ds)))


@pytest.mark.cuda
def test_ingest_beams_kernels_match_plain(cuda_dev):
    """K7a: point keys equal to the plain version; the beam samples that
    exist, their keys, the in-range flags and the count equal to the dense
    plain version's kept rows, in order (the same f32 operations, no FMA)."""
    pts, scan, origins, ca, _ = ingest_scene(40, dev=cuda_dev)
    p = _ingest_params()
    before = ingest_beams.launches
    keys = ingest_beams.point_keys(pts, scan, origins, ca, inv_leaf=p["inv_leaf"], lim=p["lim"])
    ref = ingest_beams.point_keys_plain(pts, scan, origins, ca, inv_leaf=p["inv_leaf"],
                                        lim=p["lim"])
    assert torch.equal(keys, ref)
    hkey, hits = device_ingest._downsample(pts, keys, ca, p["leaf"])
    kw = dict(kf=p["kf"], mr=p["mr"], fr=p["fr"], inv_leaf=p["inv_leaf"])
    out = ingest_beams.beam_samples(hits, hkey, origins, ca, **kw)
    torch.cuda.synchronize()
    assert ingest_beams.launches == before + 2
    _assert_compact_beams(out, ingest_beams.beam_samples_plain(hits, hkey, origins, ca, **kw))
    assert int(out[3]) > 1000


def _assert_compact_beams(out, dense):
    """K7a's compact outputs (samples, keys, in range, count) against the
    dense plain layout: its kept rows in order, bit for bit."""
    fpts, fkeys, inr, count = out
    keep = dense[1] != ingest_keys.SENT
    n = int(count)
    assert count.dtype == torch.int32 and n == int(keep.sum())
    assert fpts.shape[0] == fkeys.shape[0] == keep.numel()     # room for every slot
    assert torch.equal(fpts[:n], dense[0][keep]) and torch.equal(fkeys[:n], dense[1][keep])
    assert torch.equal(inr, dense[2])


@pytest.mark.cuda
@pytest.mark.parametrize("fr", [0.5, 0.1, 0.3])
def test_ingest_beams_kernel_at_range_and_cell_edges(cuda_dev, fr):
    """K7a's closed-form kept count on the card at the boundaries: hits
    along x from an origin on a cell face, out of range, at the origin,
    within fr, at fr, at (k + 1)·fr and one ulp either side, at mr."""
    hits, keys, origins, anchors, names, kept = beam_edge_hits(fr, dev=cuda_dev)
    kw = beam_kwargs(fr=fr)
    out = ingest_beams.beam_samples(hits, keys, origins, anchors, **kw)
    dense = ingest_beams.beam_samples_plain(hits, keys, origins, anchors, **kw)
    torch.cuda.synchronize()
    _assert_compact_beams(out, dense)
    assert (dense[1] != ingest_keys.SENT).view(len(names), -1).sum(1).tolist() == kept


@pytest.mark.cuda
@pytest.mark.parametrize("n_hits", [1, "tile", "tile + 1", 20000])
def test_ingest_beams_kernel_across_look_back_tiles(cuda_dev, n_hits):
    """K7a's compaction over one hit, a tile (``ingest_beams.tile_hits``),
    a tile and one hit, and 20,000 hits, 187 tiles (ranges spread over (0,
    1.2 mr], a tenth of the hits out of range), three launches in a row (the
    look-back words of one launch must not count in the next): bit for bit
    the dense layout's kept rows, the scratch's tile counter (K7c's) left
    at 0."""
    tile = ingest_beams.tile_hits(_ingest_params()["kf"])
    n_hits = {"tile": tile, "tile + 1": tile + 1}.get(n_hits, n_hits)
    rng = np.random.default_rng(n_hits)
    origins = torch.tensor([[0.05, -0.2, 0.3], [1.0, 2.0, -0.5]], dtype=torch.float32)
    d = rng.normal(size=(n_hits, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    scan = rng.integers(0, 2, n_hits)
    hits = torch.from_numpy((origins.numpy()[scan] + d * rng.uniform(
        0, 1.2 * INGEST["mr"], (n_hits, 1))).astype(np.float32))
    ca = torch.from_numpy(device_ingest.anchors(origins.numpy(), INGEST["ds"]))
    p = _ingest_params()
    hkey = ingest_beams.point_keys_plain(hits, torch.from_numpy(scan.astype(np.int32)),
                                         origins, ca, inv_leaf=p["inv_leaf"],
                                         lim=float("inf"))
    args = [x.to(cuda_dev) for x in (hits, hkey, origins, ca)]
    kw = dict(kf=p["kf"], mr=p["mr"], fr=p["fr"], inv_leaf=p["inv_leaf"])
    dense = ingest_beams.beam_samples_plain(*args, **kw)
    for _ in range(3):
        _assert_compact_beams(ingest_beams.beam_samples(*args, **kw), dense)
    torch.cuda.synchronize()
    dev = args[0].device
    key = (str(dev), torch.cuda.current_stream(dev).cuda_stream)
    assert int(ingest_members._SCRATCH[key][0][0]) == 0        # the tile counter
    assert (n_hits < 100) or not bool(dense[2].all())


@pytest.mark.cuda
def test_ingest_downsample_kernel_matches_plain(cuda_dev):
    """K7b: the same sums in the same order, so equal centroids."""
    pts, scan, origins, ca, _ = ingest_scene(41, dev=cuda_dev)
    p = _ingest_params()
    keys = ingest_beams.point_keys_plain(pts, scan, origins, ca, inv_leaf=p["inv_leaf"],
                                         lim=p["lim"])
    perm, ukey, starts, counts, _ = ingest_sort.sort_runs_plain(
        keys, ingest_sort.widest_window(len(origins)))
    before = ingest_downsample.launches
    cent = ingest_downsample.centroids(pts, perm, starts, counts, ukey, ca, leaf=p["leaf"])
    ref = ingest_downsample.centroids_plain(pts, perm, starts, counts, ukey, ca,
                                            leaf=p["leaf"])
    torch.cuda.synchronize()
    assert ingest_downsample.launches == before + 1
    assert torch.equal(cent, ref) and int(counts.max()) >= 30


@pytest.mark.cuda
def test_ingest_members_kernel_matches_plain(cuda_dev):
    """K7c on a scene's points, a seventh invalid: the compact layout's keys,
    rows and count and the dense layout's keys and rows equal the plain
    versions'."""
    pts, scan, _, _, ba = ingest_scene(42, dev=cuda_dev)
    valid = torch.arange(len(pts), device=cuda_dev) % 7 != 0
    before = ingest_members.launches
    keys, rows, count = ingest_members.memberships(pts, scan, valid, ba,
                                                   block_size=INGEST["block_size"])
    dkeys, drows, _ = ingest_members.memberships(pts, scan, valid, ba,
                                                 block_size=INGEST["block_size"], dense=True)
    ref = ingest_members.memberships_plain(pts, scan, valid, ba,
                                           block_size=INGEST["block_size"])
    ckeys, crows = ingest_members.compact_memberships_plain(pts, scan, valid, ba,
                                                           block_size=INGEST["block_size"])
    torch.cuda.synchronize()
    assert ingest_members.launches == before + 2
    M = int(count.item())
    assert M == ckeys.shape[0] > 0
    assert torch.equal(keys[:M], ckeys) and torch.equal(rows[:M], crows)
    assert torch.equal(dkeys, ref)
    assert torch.equal(drows, torch.arange(ref.shape[0], device=cuda_dev,
                                           dtype=torch.int32) // 8)


def _members_equal_plain(ent, scan, valid, anchors):
    """K7c in both layouts against the plain versions; returns M."""
    keys, rows, count = ingest_members.memberships(ent, scan, valid, anchors, block_size=0.4)
    dkeys, drows, _ = ingest_members.memberships(ent, scan, valid, anchors, block_size=0.4,
                                                 dense=True)
    ckeys, crows = ingest_members.compact_memberships_plain(ent, scan, valid, anchors,
                                                           block_size=0.4)
    dense = ingest_members.memberships_plain(ent, scan, valid, anchors, block_size=0.4)
    torch.cuda.synchronize()
    M = int(count.item())
    assert M == ckeys.shape[0]
    assert keys.shape[0] == rows.shape[0] == 8 * ent.shape[0]
    assert torch.equal(keys[:M], ckeys) and torch.equal(rows[:M], crows)
    assert torch.equal(dkeys, dense)
    assert torch.equal(drows, torch.arange(dense.shape[0], device=ent.device,
                                           dtype=torch.int32) // 8)
    return M


@pytest.mark.cuda
@pytest.mark.parametrize("corners", [False, True])
@pytest.mark.parametrize("E", [1, 511, 1500, 200_001])
def test_ingest_members_kernel_compact_equals_plain(cuda_dev, E, corners):
    """K7c on entries inside blocks and on their faces, edges and corners
    (corner-heavy with ``corners``), among runs of invalid entries that span
    a 512-entry tile (:func:`member_entries`), E a tile's size less one, not
    a multiple of it, and enough for several waves of tiles: keys, rows and
    count of the compact layout (its tiles' places by the look-back) and
    the dense layout, equal to the plain versions."""
    ent, scan, valid, anchors = member_entries(70 + E, E=E, corners=corners, dev=cuda_dev)
    M = _members_equal_plain(ent, scan, valid, anchors)
    assert E < 600 or 0 < M < 8 * E


@pytest.mark.cuda
def test_ingest_members_kernel_repeats_across_launches(cuda_dev):
    """The compact launch's kept scratch (a tile counter each launch leaves
    at zero, look-back words tagged with the launch's epoch): launches of
    other sizes in turn, on other data, each equal to the plain version;
    no entry valid gives M = 0."""
    for i, E in enumerate([200_001, 3000, 200_001, 40_000, 1500]):
        ent, scan, valid, anchors = member_entries(90 + i, E=E, dev=cuda_dev)
        _members_equal_plain(ent, scan, valid, anchors)
    ent, scan, valid, anchors = member_entries(99, E=5000, dev=cuda_dev)
    assert _members_equal_plain(ent, scan, torch.zeros_like(valid), anchors) == 0
    key = (str(ent.device), torch.cuda.current_stream(cuda_dev).cuda_stream)
    assert int(ingest_members._SCRATCH[key][0][0]) == 0        # the tile counter


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["small", "large"])
@pytest.mark.parametrize("E", [300, 200_001])
def test_ingest_sort_kernel_with_a_device_count(cuda_dev, E, path, monkeypatch):
    """K7s on K7c's compact keys with their count on the card (the rest of
    the buffer set to valid keys of the window, which the sort must not
    read) equals the same sort of the exact-size keys, on the card and by
    the plain version, on both paths."""
    if path == "large":
        monkeypatch.setattr(ingest_sort, "SMALL_SORT_KEYS", 0)
    ent, scan, valid, anchors = member_entries(80 + E, E=E, dev=cuda_dev)
    keys, _, count = ingest_members.memberships(ent, scan, valid, anchors, block_size=0.4)
    M = int(count.item())
    if path == "small":
        keys, M = keys[:ingest_sort.SMALL_SORT_KEYS].contiguous(), min(M, 4000)
        count = torch.tensor([M], dtype=torch.int32, device=cuda_dev)
    keys[M:] = keys[0]
    w = ingest_sort.Window(16, 3)
    runs = ingest_sort.sort_runs(keys, w, want_rid=True, count=count)
    exact = ingest_sort.sort_runs(keys[:M].clone(), w, want_rid=True)
    ref = ingest_sort.sort_runs_plain(keys.cpu(), w, want_rid=True, count=count.cpu())
    torch.cuda.synchronize()
    for name, x, y, z in zip(runs._fields, runs, exact, ref):
        assert torch.equal(x, y) and torch.equal(x.cpu(), z), name
    assert runs.perm.shape[0] == M and int(runs.perm.max()) < M


def _sort_case(case: str):
    """(keys [N] int64 on the CPU, window) of a K7s card case: keys drawn from
    a pool of distinct keys (ties), a share of sentinels."""
    rng = np.random.default_rng(sum(map(ord, case)))
    mr, ds, bs = INGEST["mr"], INGEST["ds"], INGEST["block_size"]
    cases = {  # window, keys, distinct keys, sentinel share
        "demo_cells": (ingest_sort.cell_window(mr, ds, 16), 400_000, 60_000, 0.4),
        "demo_blocks": (ingest_sort.block_window(mr, ds, bs, 16), 300_000, 5_000, 0.8),
        "wide_u64": (ingest_sort.widest_window(16), 200_000, 150_000, 0.1),
        "one_scan": (ingest_sort.cell_window(mr, ds, 1), 50_000, 20_000, 0.2),
        "all_sentinel": (ingest_sort.cell_window(mr, ds, 4), 10_000, 1, 1.0),
        "one_key": (ingest_sort.cell_window(mr, ds, 4), 1, 1, 0.0),
        "long_run": (ingest_sort.cell_window(mr, ds, 16), 30_000, 3_000, 0.3),
        # more tiles than a wave of CTAs, in every pass: CTAs of several tiles
        "many_tiles": (ingest_sort.cell_window(mr, ds, 16), 3_000_000, 500_000, 0.3),
    }
    w, n, distinct, p_sent = cases[case]
    anchors = rng.integers(-3000, 3000, (w.scans, 3)).astype(np.int32)
    s = rng.integers(0, w.scans, distinct)
    ijk = anchors[s] + rng.integers(-w.radius, w.radius + 1, (distinct, 3))
    pool = ingest_keys.pack(torch.from_numpy(s), torch.from_numpy(ijk),
                            torch.from_numpy(anchors)).numpy()
    keys = pool[rng.integers(0, distinct, n)]
    keys[rng.random(n) < p_sent] = ingest_keys.SENT
    if case == "long_run":  # a run of 5,000 members or more among the rest
        keys = np.concatenate([keys, np.full(5000, pool[0])])[rng.permutation(n + 5000)]
    return torch.from_numpy(keys), w


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["demo_cells", "demo_blocks", "wide_u64", "one_scan",
                                  "all_sentinel", "one_key", "long_run", "many_tiles"])
def test_ingest_sort_kernel_equals_plain(cuda_dev, case):
    """K7s: the sort index, the runs and each row's run bit for bit equal to
    the plain version (torch.sort(stable=True) + unique_consecutive); the
    control, the kernel's sort index with one tie swapped, must fail."""
    keys, w = _sort_case(case)
    before = ingest_sort.launches
    runs = ingest_sort.sort_runs(keys.to(cuda_dev), w, want_rid=True)
    torch.cuda.synchronize()
    assert ingest_sort.launches == before + 1
    ref = ingest_sort.sort_runs_plain(keys, w, want_rid=True)
    for name, x, y in zip(runs._fields, runs, ref):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y), name
    if case == "long_run":
        assert int(ref.counts.max()) >= 5000
    if int((ref.counts > 1).sum()):
        r = int(torch.nonzero(ref.counts > 1)[0])
        perm = runs.perm.cpu().clone()
        a = int(ref.starts[r])
        perm[[a, a + 1]] = perm[[a + 1, a]]
        assert not torch.equal(perm, ref.perm)


@pytest.mark.cuda
def test_ingest_sort_kernel_raises_outside_its_window(cuda_dev):
    """A valid key one cell past its window raises at the sort's one sync."""
    keys, w = _sort_case("one_scan")
    bad = keys.clone()
    bad[123] = ingest_keys.pack(torch.tensor([0]), torch.tensor([[w.radius + 1, 0, 0]]),
                                torch.zeros((1, 3), dtype=torch.int32))[0]
    with pytest.raises(ValueError, match="outside their window"):
        ingest_sort.sort_runs(bad.to(cuda_dev), w)
    ingest_sort.sort_runs(keys.to(cuda_dev), w)  # the card is fine after it


def _sort_equals_plain(keys, w, dev, small: bool):
    """K7s on ``keys`` through the path ``small`` names: one sort, its
    kernels (one on the one-CTA path, passes + 2 above), every output bit
    for bit equal to the plain version's; the control, one tie swapped in
    the sort index, must fail."""
    assert ingest_sort.small_sort(keys.shape[0]) == small
    before = ingest_sort.launches, ingest_sort.kernel_launches
    runs = ingest_sort.sort_runs(keys.to(dev), w, want_rid=True)
    torch.cuda.synchronize()
    assert ingest_sort.launches == before[0] + 1
    assert ingest_sort.kernel_launches == before[1] + (1 if small else w.passes + 2)
    ref = ingest_sort.sort_runs_plain(keys, w, want_rid=True)
    for name, x, y in zip(runs._fields, runs, ref):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y), name
    if int((ref.counts > 1).sum()):
        r = int(torch.nonzero(ref.counts > 1)[0])
        perm = runs.perm.cpu().clone()
        a = int(ref.starts[r])
        perm[[a, a + 1]] = perm[[a + 1, a]]
        assert not torch.equal(perm, ref.perm)
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["small", "large"])
@pytest.mark.parametrize("case", ["demo_cells", "demo_blocks", "wide_u64", "one_scan",
                                  "all_sentinel", "one_key", "long_run", "many_tiles"])
def test_ingest_sort_kernel_paths_equal_plain(cuda_dev, case, path, monkeypatch):
    """K7s's two paths on the seven key sets of _sort_case: the one-CTA path on each
    set's first SMALL_SORT_KEYS keys (a u64 window among them), the
    multi-CTA path on the whole set with the threshold at 0 (so one key
    takes it too)."""
    keys, w = _sort_case(case)
    if path == "small":
        keys = keys[:ingest_sort.SMALL_SORT_KEYS].contiguous()
    else:
        monkeypatch.setattr(ingest_sort, "SMALL_SORT_KEYS", 0)
    _sort_equals_plain(keys, w, cuda_dev, path == "small")


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [4096, 1000])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_ingest_sort_kernel_at_the_threshold(cuda_dev, threshold, delta, monkeypatch):
    """N at the small-sort threshold ± 1 (the kernel's tile, and a lower
    threshold set by monkeypatch): the path follows N, both bit-equal."""
    monkeypatch.setattr(ingest_sort, "SMALL_SORT_KEYS", threshold)
    keys, w = _sort_case("demo_cells")
    keys = keys[:threshold + delta].contiguous()
    _sort_equals_plain(keys, w, cuda_dev, delta <= 0)


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [4096, 0])
def test_ingest_sort_kernel_raises_on_both_paths(cuda_dev, threshold, monkeypatch):
    """A valid key one cell past its window raises at the sort's one sync,
    on the one-CTA path and the multi-CTA path."""
    monkeypatch.setattr(ingest_sort, "SMALL_SORT_KEYS", threshold)
    keys, w = _sort_case("one_scan")
    keys = keys[:3000].contiguous()
    bad = keys.clone()
    bad[123] = ingest_keys.pack(torch.tensor([0]), torch.tensor([[0, w.radius + 1, 0]]),
                                torch.zeros((1, 3), dtype=torch.int32))[0]
    with pytest.raises(ValueError, match="outside their window"):
        ingest_sort.sort_runs(bad.to(cuda_dev), w)
    _sort_equals_plain(keys, w, cuda_dev, threshold > 0)


@pytest.mark.cuda
def test_ingest_downsample_kernel_long_runs_bit_for_bit(cuda_dev):
    """K7b on runs of every length round its warp threshold and a 5,000-member
    run: the same sums in the same order as its plain version, bit for bit;
    the control, one tie of the long run swapped in the sort index, must
    move its centroid."""
    rng = np.random.default_rng(61)
    keys, w = _sort_case("long_run")
    runs = ingest_sort.sort_runs_plain(keys, w)
    anchors = torch.zeros((w.scans, 3), dtype=torch.int32)
    pts = torch.from_numpy(rng.uniform(-8, 8, (len(keys), 3)).astype(np.float32))
    # runs of 1..300 members from the key pool's first keys
    lens = np.arange(1, 301)
    extra_keys = torch.repeat_interleave(runs.ukey[:300], torch.from_numpy(lens))
    keys2 = torch.cat([keys, extra_keys])
    pts2 = torch.cat([pts, torch.from_numpy(rng.uniform(-8, 8, (len(extra_keys), 3))
                                            .astype(np.float32))])
    runs2 = ingest_sort.sort_runs_plain(keys2, w)
    args = (pts2, runs2.perm, runs2.starts, runs2.counts, runs2.ukey, anchors)
    before = ingest_downsample.launches
    cent = ingest_downsample.centroids(*(a.to(cuda_dev) for a in args), leaf=0.1)
    torch.cuda.synchronize()
    assert ingest_downsample.launches == before + 1
    ref = ingest_downsample.centroids_plain(*args, leaf=0.1)
    assert torch.equal(cent.cpu(), ref)
    assert int(runs2.counts.max()) >= 5000 and len(set(runs2.counts.tolist())) > 200
    r = int(torch.argmax(runs2.counts))
    perm = runs2.perm.clone()
    a = int(runs2.starts[r])
    perm[[a, a + 2500]] = perm[[a + 2500, a]]
    moved = ingest_downsample.centroids(pts2.to(cuda_dev), perm.to(cuda_dev),
                                        *(x.to(cuda_dev) for x in args[2:]), leaf=0.1)
    assert not torch.equal(moved.cpu()[r], ref[r])


@pytest.mark.cuda
@pytest.mark.parametrize("method,sites", [
    ("bgk", {"la3dm.sync.sort_runs": 4, "la3dm.sync.fetch_small": 1}),
    ("bgkl", {"la3dm.sync.sort_runs": 3, "la3dm.sync.ray_pairs": 1,
              "la3dm.sync.fetch_small": 1})])
def test_device_ingest_dispatch_counts_its_host_syncs(cuda_dev, method, sites):
    """One 16-scan device-ingest dispatch waits for the card five times (BGK:
    four K7s status reads; BGKL: three and its ray-pair size; both: the key
    and count copy), and the map's ``synchronize`` a sixth, each a
    ``la3dm.sync.*`` span and a ``host_syncs`` count (utils/profiling.py)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = MapConfig(method=method, resolution=0.1, block_depth=3, sf2=1.0, ell=0.2,
                    free_resolution=0.5, ds_resolution=0.1, free_thresh=0.3,
                    occupied_thresh=0.7, var_thresh=100.0, prior_A=0.001, prior_B=0.001,
                    max_range=8.0, device_ingest="on")
    rng = np.random.default_rng(16)
    clouds, origins = [], []
    for i in range(16):
        y, z = rng.uniform(-2.0, 2.0, 300), rng.uniform(0.0, 2.0, 300)
        clouds.append(np.stack([2.0 + 0.05 * rng.standard_normal(300), y, z],
                               -1).astype(np.float32))
        origins.append(np.array([0.1, -0.2 + 0.05 * i, 0.3], np.float32))
    m = build_map(cfg, device=cuda_dev)
    m.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        m.insert_pointclouds(clouds, origins, max_range=6.0)
        after_insert = profiling.snapshot()
        m.synchronize()
        after_sync = profiling.snapshot()
    counts = dict(after_insert["counts"])
    blocks, tests = counts.pop("slot_blocks"), counts.pop("slot_tests")
    assert counts == {"scans": 16, "dispatches": 1, "host_syncs": 5,
                      "slot_dispatches_card": 1}
    assert 0 < blocks < tests
    assert {k: v["calls"] for k, v in after_insert["spans"].items()
            if k.startswith("la3dm.sync.")} == sites
    assert after_sync["counts"]["host_syncs"] == 6
    assert after_sync["spans"]["la3dm.sync.synchronize"]["calls"] == 1
    assert m.stats["scans"] == 16 and m.stats["ingest_host_chunks"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bgk", "bgkl"])
def test_sharded_device_ingest_dispatch_counts_its_host_syncs(cuda_dev, method):
    """A map on four shards of the card waits for one 16-scan dispatch five
    times too: the slot resolution's one copy also brings back the sort
    index and the runs, from which the host builds the slots it cuts per
    shard, with no wait of its own."""
    from torch.profiler import ProfilerActivity, profile

    from la3dm_tpu_torch.parallel import mesh as pm, sharded_map as smod

    cfg = MapConfig(method=method, resolution=0.1, block_depth=3, sf2=1.0, ell=0.2,
                    free_resolution=0.5, ds_resolution=0.1, free_thresh=0.3,
                    occupied_thresh=0.7, var_thresh=100.0, prior_A=0.001, prior_B=0.001,
                    max_range=8.0, device_ingest="on")
    rng = np.random.default_rng(16)
    clouds, origins = [], []
    for i in range(16):
        y, z = rng.uniform(-2.0, 2.0, 300), rng.uniform(0.0, 2.0, 300)
        clouds.append(np.stack([2.0 + 0.05 * rng.standard_normal(300), y, z],
                               -1).astype(np.float32))
        origins.append(np.array([0.1, -0.2 + 0.05 * i, 0.3], np.float32))
    cls = {"bgk": smod.ShardedBGKOctoMap, "bgkl": smod.ShardedBGKLOctoMap}[method]
    m, ref = cls(cfg, mesh=pm.block_mesh(4, cuda_dev)), build_map(cfg, device=cuda_dev)
    m.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        m.insert_pointclouds(clouds, origins, max_range=6.0)
        counts = profiling.snapshot()["counts"]
    assert counts["host_syncs"] == 5 and counts["slot_dispatches_card"] == 1
    assert "slot_dispatches_host" not in counts
    ref.insert_pointclouds(clouds, origins, max_range=6.0)
    assert m.pool.n_blocks == ref.pool.n_blocks > 0
    assert set(map(tuple, m.pool.coords[m.pool.active_slots()].tolist())) == \
        set(map(tuple, ref.pool.coords[:ref.pool.n_blocks].tolist()))


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [False, True])
def test_ingest_dispatch_sorts_and_tail_equal_plain(cuda_dev, segments, monkeypatch):
    """One dispatch on the card: every K7s sort (4 a dispatch, BGKL 3; the
    free samples' over K7a's count), the K7t launch (against both its plain
    versions) and both K7b launches (BGKL: one) equal their plain versions
    on the same card inputs bit for bit."""
    pts, scan, origins, ca, ba = ingest_scene(62)
    mr, ds, fr, bs = INGEST["mr"], INGEST["ds"], INGEST["fr"], INGEST["block_size"]
    off = torch.from_numpy(ingest_keys.pack_offsets(np.array(
        [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]])))
    kf = device_ingest.beam_slots(ds, fr, mr, bs)
    fn = device_ingest.ingest_batch_bgkl if segments else device_ingest.ingest_batch
    kw = dict(ds=ds, fr=fr, mr=mr, kf=kf, block_size=bs, **({} if segments else
                                                             {"free_label": 0.0}))
    calls = {}
    for mod, name in ((ingest_sort, "sort_runs"), (ingest_bucket, "bucket"),
                      (ingest_downsample, "centroids")):
        def rec(*a, _orig=getattr(mod, name), _name=name, **k):
            out = _orig(*a, **k)
            calls.setdefault(_name, []).append((a, k, out))
            return out
        monkeypatch.setattr(mod, name, rec)
        calls[name] = []
    before = ingest_sort.launches, ingest_bucket.launches
    tabs = fn(*(a.to(cuda_dev) for a in (pts, scan, origins, ca, ba, off)), **kw)
    torch.cuda.synchronize()
    n_sorts = 3 if segments else 4
    assert (ingest_sort.launches - before[0], ingest_bucket.launches - before[1]) == \
        (n_sorts, 1)
    assert [len(calls[k]) for k in ("sort_runs", "bucket", "centroids")] == \
        [n_sorts, 1, 1 if segments else 2]
    for a, k, out in calls["sort_runs"]:
        ref = ingest_sort.sort_runs_plain(*a, **k)
        for name, x, y in zip(out._fields, out, ref):
            assert (x is None and y is None) or torch.equal(x, y), name
    if not segments:   # the free downsample's sort reads K7a's count
        assert calls["sort_runs"][1][1].get("count") is not None
    for name, plain in (("bucket", ingest_bucket.bucket_plain),
                        ("bucket", ingest_bucket.bucket_runs_plain),
                        ("centroids", ingest_downsample.centroids_plain)):
        for a, k, out in calls[name]:
            ref = plain(*a, **k)
            for x, y in zip(out if name == "bucket" else (out,),
                            ref if name == "bucket" else (ref,)):
                assert torch.equal(x, y), name
    assert int(tabs["ucount"].sum()) == tabs["ent"].shape[0] > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("long_run", [0, 300])
@pytest.mark.parametrize("D", [3, 6])
@pytest.mark.parametrize("G", [7, 27])
def test_ingest_bucket_kernel_equals_both_plains(cuda_dev, G, D, long_run):
    """K7t on ``bucket_inputs`` (a test block fed at all G slots; runs of 1
    to 40 rows, or one of 300, longer than a warp's 64 rows; points and
    segments): every output bit for bit the searchsorted plain version's and
    the one read off the candidate runs, one launch."""
    a, kw = bucket_inputs(70 + G + D, G=G, D=D, long_run=long_run, dev=cuda_dev)
    before = ingest_bucket.launches
    out = ingest_bucket.bucket(*a, **kw)
    torch.cuda.synchronize()
    assert ingest_bucket.launches == before + 1
    for plain in (ingest_bucket.bucket_plain, ingest_bucket.bucket_runs_plain):
        for x, y in zip(out, plain(*a, **kw)):
            assert torch.equal(x, y), plain.__name__
    U = a[5].shape[0]
    assert bool((out[4] < U).all(1).any())            # a test block fed at every slot
    assert int(a[9].max()) == G and out[0].shape[1] == D
    assert long_run == 0 or int(torch.bincount(a[1].long()).max()) >= long_run


#: K1′'s cases: block_depth → (res, ℓ, T, U, spread): the demo's 0.4 m
#: blocks (73 nodes) and the large map's 3.2 m blocks (4681 nodes)
K1P_CASES = {3: (0.1, 0.2, 60, 40, 0.3), 5: (0.2, 0.6, 12, 20, 2.4)}


def _k1p_launch_and_check(a, G, sf2, ell):
    """K1′ twice with its cull counter, against its plain version: bit for
    bit, both launches; each count that of ``bgk_aligned_heavy_cull``.
    Returns (plain acc, culled pairs)."""
    before = bgk_aligned_heavy.launches
    kw = dict(G=G, sf2=sf2, ell=ell)
    accs, counts = [], []
    for _ in range(2):
        culled = torch.zeros(1, dtype=torch.int64, device=a["ent_rel"].device)
        accs.append(bgk_aligned_heavy.bgk_aligned_heavy(**a, **kw, culled=culled))
        counts.append(int(culled))
    assert bgk_aligned_heavy.launches == before + 2
    ref = bgk_aligned_heavy.bgk_aligned_heavy_plain(**a, **kw)
    torch.cuda.synchronize()
    assert torch.equal(accs[0], ref) and torch.equal(accs[1], ref)
    cull = bgk_aligned_heavy.bgk_aligned_heavy_cull(
        a["ent_rel"], a["ustart"], a["ucount"], a["tb_u"], a["ext_nodes"], G=G, ell=ell,
        per_warp=True)
    assert counts[0] == counts[1] == int(cull.sum())
    return ref, counts[0]


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [3, 5])
@pytest.mark.parametrize("G", [7, 27])
def test_aligned_heavy_kernel_matches_plain(cuda_dev, G, depth):
    """K1′'s point branch (BGK) at block_depth 3 (73 nodes) and 5 (4681):
    bit for bit its plain version, twice; its cull count the predicate's."""
    res, ell, T, U, spread = K1P_CASES[depth]
    a = aligned_heavy_inputs(43, G=G, U=U, T=T, dev=cuda_dev, depth=depth, res=res,
                             spread=spread)
    ref, culled = _k1p_launch_and_check(a, G, 1.0, ell)
    assert (ref[..., G:] > 0).sum() > 1000 and culled > 0


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [3, 5])
@pytest.mark.parametrize("G", [7, 27])
def test_aligned_heavy_segment_kernel_matches_plain(cuda_dev, G, depth):
    """K1′'s segment branch (BGKL), on the same segment mix as K1's."""
    res, ell, T, U, spread = K1P_CASES[depth]
    a = aligned_heavy_inputs(47, G=G, U=U, T=T, dev=cuda_dev, segments=True, depth=depth,
                             res=res, spread=spread)
    ref, culled = _k1p_launch_and_check(a, G, 0.1, ell)
    assert (ref[..., G:] > 0).sum() > 1000 and culled > 0


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("case", ["no_block", "no_test_block", "run_lengths", "all_culled",
                                  "degenerate"])
def test_aligned_heavy_kernel_edge_cases(cuda_dev, case, segments):
    """K1′ where its walk turns: every slot without an entry block (all
    zeros), T = 0, runs of 1, 7, 8, 9, 31, 33 and 150 entries (the Wa-row
    and 32-entry step boundaries), a run that culls entirely, degenerate
    segments (start = end); bit for bit its plain version, twice."""
    G, ell = 27, 0.2
    sf2 = 0.1 if segments else 1.0
    a = aligned_heavy_inputs(53, G=G, T=20, dev=cuda_dev, segments=segments,
                             counts=[1, 7, 8, 9, 31, 33, 150, 0])
    U = a["ucount"].shape[0]
    if case == "no_block":
        a["tb_u"].fill_(U)
    elif case == "no_test_block":
        a["tb_u"] = a["tb_u"][:0].contiguous()
        acc = bgk_aligned_heavy.bgk_aligned_heavy(**a, G=G, sf2=sf2, ell=ell)
        assert acc.shape == (0, 73, 2 * G)
        return
    elif case == "all_culled":
        # block 6 (150 entries) lies 100 m away
        s6 = int(a["ustart"][6])
        a["ent_rel"][s6:s6 + 150] += 100.0
        a["tb_u"][:, ::2] = 6
    elif case == "degenerate" and segments:
        a["ent_rel"][:, 3:] = a["ent_rel"][:, :3]
    ref, culled = _k1p_launch_and_check(a, G, sf2, ell)
    if case == "no_block":
        assert int(torch.count_nonzero(ref)) == 0 and culled == 0
    else:
        assert (ref[..., G:] > 0).sum() > 100
    if case == "all_culled":
        n6 = int((a["tb_u"] == 6).sum())
        assert culled >= n6 * 150 * 3         # every warp (3 a block) skips them all


@pytest.mark.cuda
def test_ingest_rays_kernel_matches_plain(cuda_dev):
    """K7d: occ, the segments, inr and the samples equal to the plain
    version's (the same f32 operations, no FMA), and the (ray, key) pair
    list identical (the plain version sorts each row with torch.sort)."""
    args, kw = ray_inputs(45, dev=cuda_dev)
    before = ingest_rays.launches
    out = ingest_rays.ray_pairs(*args, **kw, want_samples=True)
    assert ingest_rays.launches == before + 2
    ref = ingest_rays.ray_pairs_plain(*args, **kw, want_samples=True)
    torch.cuda.synchronize()
    for x, y in zip(out, ref):
        assert x.shape == y.shape and torch.equal(x, y)
    assert out[3].numel() > 5 * args[0].shape[0]
    main = ingest_rays.ray_pairs(*args, **kw)         # the main path's call
    assert main[5] is None and torch.equal(main[4], ref[4])


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(RAY_CONFIGS))
def test_ingest_rays_kernel_edge_rays(cuda_dev, config):
    """K7d on rays made to break its dedup by contiguity (samples on block
    faces and edges, rays along each axis, origins on faces, lengths within
    an ulp of k·fr and of the range, rays out of range) and 20,000 random
    ones, at the BGKL demo's 28 samples a ray, the large map's 6 (four rays a
    warp) and 82 (chunks of 32): every output bit-equal to the plain
    version, two launches."""
    args, kw = edge_rays(config, n_random=20_000, dev=cuda_dev)
    before = ingest_rays.launches
    out = ingest_rays.ray_pairs(*args, **kw, want_samples=True)
    torch.cuda.synchronize()
    assert ingest_rays.launches == before + 2
    ref = ingest_rays.ray_pairs_plain(*args, **kw, want_samples=True)
    for x, y in zip(out, ref):
        assert x.shape == y.shape and torch.equal(x, y)
    assert (~ref[2]).sum() > 0 and ref[3].numel() > 3 * args[0].shape[0]


@pytest.mark.cuda
def test_raycast_kernel_matches_plain(cuda_dev):
    """K6: hit and steps equal, distances bit-equal, on rays that start in
    absent blocks and rays along an axis."""
    args, kw = raycast_inputs(46, dev=cuda_dev)
    before = raycast.launches
    hit, dist, steps = raycast.raycast(*args, **kw)
    assert raycast.launches == before + 1
    rh, rd, rs = raycast.raycast_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(hit, rh) and torch.equal(steps, rs) and torch.equal(dist, rd)
    assert 0 < int(hit.sum()) < hit.numel()


def _k6_check(args, kw):
    """K6 against its plain version: hit, steps and dist equal, the kernel's
    (lookups that probed, probes) those of the plain block mode, a repeat
    launch equal.  Returns the plain (hit, dist, steps)."""
    counts = torch.zeros(2, dtype=torch.int64, device=args[0].device)
    out = raycast.raycast(*args, **kw, counts=counts)
    again = raycast.raycast(*args, **kw)
    hp, dp, sp, _, probes, probed = raycast.raycast_plain(*args, **kw, count_probes=True)
    torch.cuda.synchronize()
    for x in (out, again):
        assert torch.equal(x[0], hp) and torch.equal(x[1], dp) and torch.equal(x[2], sp)
    assert counts.tolist() == [int(probed.sum()), int(probes.sum())]
    return hp, dp, sp


@pytest.mark.cuda
def test_raycast_kernel_edge_rays(cuda_dev):
    """K6: rays from absent blocks and along each axis; on a column of
    blocks that is one probe chain of max_probes entries, rays that hit at
    step 0, rays that never hit and lookups that take max_probes probes
    (found and not found); one ray."""
    args, kw = raycast_inputs(47, dev=cuda_dev)
    hit, _, steps = _k6_check(args, kw)
    axis = (args[5].abs() < 1e-12).sum(1) == 2
    assert 0 < int(hit.sum()) < hit.numel() and int(axis.sum()) > 100
    args, kw = raycast_chain_inputs(dev=cuda_dev)
    hit, _, steps = _k6_check(args, kw)
    assert hit.tolist() == [True] * 6 + [False] * 3
    assert steps[3:6].tolist() == [0, 0, 0] and (steps[6:] > 70).all()
    one = tuple(x[:1].contiguous() if i >= 4 else x for i, x in enumerate(args))
    assert _k6_check(one, kw)[0].tolist() == [True]


@pytest.mark.cuda
def test_raycast_kernel_more_rays_than_the_grid(cuda_dev):
    """600,000 rays: more than one wave of the card's lanes holds, so lanes
    refill many times; equal to the plain version, counts included."""
    args, kw = raycast_inputs(48, n_rays=600_000, dev=cuda_dev)
    hit, _, _ = _k6_check(args, kw)
    assert 0 < int(hit.sum()) < hit.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bgk", "bgkl", "gp"])
def test_cuda_map_auto_takes_the_device_path(cuda_dev, method):
    from la3dm_tpu_torch import pipeline
    from la3dm_tpu_torch.utils.config import load_method_config

    pts, scan, origins, _, _ = ingest_scene(44, n_scans=2)
    clouds = [pts[scan == s].numpy() for s in range(2)]
    m = pipeline.build_map(load_method_config(method, max_range=INGEST["mr"]))
    assert m.cfg.device_ingest == "auto" and m._ingest_enabled()
    before = ingest_members.launches, ingest_rays.launches
    m.insert_pointclouds(clouds, [o.numpy() for o in origins])
    m.synchronize()
    assert ingest_members.launches == before[0] + 1
    assert ingest_rays.launches == before[1] + (2 if method == "bgkl" else 0)
    assert m.stats["ingest_host_chunks"] == 0 and m.pool.n_blocks > 0


def _recording(monkeypatch, mod, names):
    """Wrap ``mod``'s functions ``names`` to record (args, kwargs, out)."""
    calls = {n: [] for n in names}
    for n in names:
        def rec(*a, _orig=getattr(mod, n), _n=n, **k):
            out = _orig(*a, **k)
            calls[_n].append((a, k, out))
            return out
        monkeypatch.setattr(mod, n, rec)
    return calls


def _cpu(x):
    return x.cpu() if torch.is_tensor(x) else x


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["bgkl_room_vlp16", "gp_room_vlp16"])
def test_ingest_slots_kernels_equal_plain_on_the_benchmark_dispatch(cuda_dev, config,
                                                                   monkeypatch):
    """K7w on the first dispatch of each benchmark cell's configuration (16
    VLP-16 scans of ``benchmark/scene.py``, seed 3000000101, a fresh map):
    the world keys and scan counts, the world-key sort and the gather (GP:
    with centres) equal their plain versions bit for bit, and the map hands
    its engine the slots, scan runs and centres of the host resolution, with
    the same blocks in the same slots and the same pool after the dispatch."""
    from benchmark import scene

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", config + ".json")) as f:
        conf = json.load(f)
    clouds, origins = scene.scans(conf, 16, 3000000101)
    mcfg = MapConfig(**conf["method"])
    calls = _recording(monkeypatch, ingest_slots, ("world_keys", "sort_world", "gather"))
    card, host = build_map(mcfg, device=cuda_dev), build_map(mcfg, device=cuda_dev)
    host._resolve_slots = lambda tabs, banchor, banchor_dev, radius: host._host_slots(
        tabs, banchor)
    logs = []
    for m in (card, host):
        log, hook = [], m._dispatch_ingest_chunk

        def rec(tabs, ucount, slots, centers, ss, sc, _log=log, _hook=hook):
            _log.append((slots, centers, list(ss), list(sc)))
            return _hook(tabs, ucount, slots, centers, ss, sc)

        m._dispatch_ingest_chunk = rec
        logs.append(log)
        m.insert_pointclouds(clouds, origins, ds_resolution=mcfg.resolution,
                             free_resolution=mcfg.free_resolution,
                             max_range=float(conf["dataset"]["max_range"]))
        m.synchronize()
    assert [len(v) for v in calls.values()] == [1, 1, 1]

    (a, k, (wkey, count)), = calls["world_keys"]
    ref = ingest_slots.world_keys_plain(*map(_cpu, a), **k)
    assert torch.equal(wkey.cpu(), ref[0]) and torch.equal(count.cpu(), ref[1])
    T = wkey.shape[0]
    (a, k, (perm, ukey, rid, status)), = calls["sort_world"]
    runs = ingest_sort.sort_runs_plain(a[0].cpu(), a[1], want_rid=True)
    V, D, flag, _ = status.cpu().tolist()
    assert (V, D, flag) == (T, runs.ukey.shape[0], 0) and D < T
    assert torch.equal(perm[:V].cpu(), runs.perm) and torch.equal(rid[:V].cpu(), runs.rid)
    assert torch.equal(ukey[:D].cpu(), runs.ukey)
    (a, k, (slots, ctr)), = calls["gather"]
    ref = ingest_slots.gather_plain(*map(_cpu, a), **k)
    assert torch.equal(slots.cpu(), ref[0])
    assert (ctr is None) == (ref[1] is None) == (mcfg.method != "gp")
    if ctr is not None:
        assert torch.equal(ctr.cpu(), ref[1])

    (cs, cc, css, csc), = logs[0]
    (hs, hc, hss, hsc), = logs[1]
    assert torch.is_tensor(cs) and cs.device.type == "cuda" and not torch.is_tensor(hs)
    assert np.array_equal(cs.cpu().numpy(), hs) and (css, csc) == (hss, hsc)
    if mcfg.method == "gp":
        assert np.array_equal(cc.cpu().numpy(), hc)
    else:
        assert cc is None and hc is None
    assert card.pool.n_blocks == host.pool.n_blocks == D
    assert np.array_equal(card.pool.coords, host.pool.coords)
    for k in card.pool.fields:
        assert torch.equal(card.pool.fields[k], host.pool.fields[k]), k
    assert torch.equal(card.pool.touched, host.pool.touched)
    assert torch.equal(card.pool.eff_level, host.pool.eff_level)


@pytest.mark.cuda
def test_ingest_slots_kernels_equal_plain_on_edges(cuda_dev):
    """K7w on small inputs: a scan without test blocks, one test block,
    fields at the window's edge and past 16 bits (the sentinel), and
    more test blocks than one CTA's threads."""
    rng = np.random.default_rng(5)
    anchors = torch.tensor([[0, 0, 0], [3, -2, 1], [9, 9, 9]], dtype=torch.int32)
    for n, spread in ((1, 0), (5, 4), (3000, 12), (70000, 30)):
        scan = torch.from_numpy(np.sort(rng.choice([0, 2], n)))
        c = anchors[scan].long() + torch.from_numpy(rng.integers(-spread, spread + 1, (n, 3)))
        tkey = torch.unique(ingest_keys.pack(scan, c, anchors))
        for base in ([1, 0, 1], [0, 0, 40000]):
            ref = ingest_slots.world_keys_plain(tkey, anchors, np.array(base), 3)
            got = ingest_slots.world_keys(tkey.to(cuda_dev), anchors.to(cuda_dev),
                                          np.array(base), 3)
            torch.cuda.synchronize()
            assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
            assert ref[1].tolist()[1] == 0
        window, base = ingest_slots.world_window(spread, anchors.numpy())
        wkey = ingest_slots.world_keys_plain(tkey, anchors, base, 3)[0]
        perm, ukey, rid, status = ingest_slots.sort_world(wkey.to(cuda_dev), window)
        V, D, flag, _ = status.cpu().tolist()
        assert (V, flag) == (tkey.shape[0], 0)
        uslots = torch.from_numpy(rng.permutation(D).astype(np.int32))
        for bs in (None, 0.4, 0.8):
            got = ingest_slots.gather(perm[:V], rid[:V], uslots.to(cuda_dev), ukey, base,
                                      block_size=bs)
            ref = ingest_slots.gather_plain(perm[:V].cpu(), rid[:V].cpu(), uslots,
                                            ukey.cpu(), base, block_size=bs)
            torch.cuda.synchronize()
            assert torch.equal(got[0].cpu(), ref[0])
            assert (got[1] is None and ref[1] is None) or torch.equal(got[1].cpu(), ref[1])
