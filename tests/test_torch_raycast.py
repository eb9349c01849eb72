"""The PyTorch port's raycast (the host stepper, the snapshot and the device
DDA, K6 through its plain version) against the JAX package's, on the CPU.

Maps are built by the JAX package and loaded into the port's map of the
same class through the shared NPZ checkpoint, so both raycasts read the same
state.  Limits: the hash tables and the state tables array-equal; the host
steppers equal (hit, steps, distance); the device DDAs equal on every ray
(hit, steps, distance bit-equal) except rays named by the test, where XLA's
CPU code and the port's f32 arithmetic read different voxels at a tie: every
DDA voxel centre idx·res lies on a face of its block's voxel grid (n even),
so the local index trunc((p − c)/res + n/2) sits on an integer, where the
last ulp decides, and XLA rewrites those f32 expressions (a fused multiply-
add, constants folded across a multiply and a divide).  For each named ray
the test shows the tie on its path; the JAX host stepper arbitrates: the
port must agree with it (hit and steps) on at least as many rays as the JAX
DDA does, and on ≥ 95 % of them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from la3dm_tpu.models import bgk as jbgk, bgklv as jbgklv, raycast as jrc
from la3dm_tpu.utils.config import MapConfig as JMapConfig

from la3dm_tpu_torch.kernels import raycast as k6
from la3dm_tpu_torch.models import bgk, bgklv, posterior, raycast as rc
from la3dm_tpu_torch.utils.config import MapConfig

from tests.test_bgk_vs_oracle import CFG, synthetic_scan
from tests.test_families_vs_oracle import LV_CFG
from torch_cases import (one_torch_thread, raycast_chain_inputs,  # noqa: F401  (autouse
                         raycast_inputs)                          # fixture)


def _carry(jm, cls, tmp_path):
    """The port's map of class ``cls`` holding the JAX map's state."""
    path = str(tmp_path / "map.npz")
    jm.save(path)
    m = cls(MapConfig(**dataclasses.asdict(jm.cfg)), device="cpu")
    m.load(path)
    return m


def _wall_map():
    """tests/test_aux.py's map: an occupied wall at x ≈ 2, free space before."""
    cfg = JMapConfig(method="bgk", resolution=0.1, block_depth=3, ell=0.2, sf2=1.0)
    m = jbgk.BGKOctoMap(cfg)
    rng = np.random.default_rng(0)
    yz = rng.uniform(-0.4, 0.4, size=(400, 2)).astype(np.float32)
    wall = np.column_stack([np.full(len(yz), 2.0, np.float32), yz])
    free = np.column_stack([rng.uniform(0.1, 1.8, 400).astype(np.float32),
                            rng.uniform(-0.4, 0.4, (400, 2)).astype(np.float32)])
    pts = np.concatenate([wall, free]).astype(np.float32)
    labels = np.concatenate([np.ones(len(wall)), np.zeros(len(free))]).astype(np.float32)
    m.insert_training_data(pts, labels)
    return m


def _diagonal_map():
    """tests/test_aux.py's long-diagonal map: occupied walls every 40 blocks
    along the space diagonal (a bbox of ≈ 161³ blocks, ≈ 40 of them live)."""
    m = jbgk.BGKOctoMap(CFG)
    bs = m.block_size
    for k in range(0, 161, 40):
        c = np.float32(k * bs)
        pts = np.stack([np.full(25, c + 0.18),
                        c + np.tile(np.linspace(-0.15, 0.15, 5), 5),
                        c + np.repeat(np.linspace(-0.15, 0.15, 5), 5)],
                       axis=1).astype(np.float32)
        m.insert_training_data(pts, np.ones(len(pts), np.float32))
    return m


def _rays(seed, n, spread=0.5):
    """Random rays near the origin; every 8th along an axis (|d| < 1e-12 on
    the others), every 9th from outside any block (x = −3)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    i = np.arange(n)
    d[i % 8 == 0] = np.eye(3, dtype=np.float32)[i[i % 8 == 0] % 3]
    d[i % 8 == 4] = [1.0, 0.0, 0.0]
    o[i % 9 == 0, 0] = -3.0
    d[i % 9 == 0, 0] = np.abs(d[i % 9 == 0, 0]) + 0.5
    return o, d


# ------------------------------------------------ the tie at a voxel face

@jax.jit
def _jax_local_index(idx, res, bs, n):
    """The local index of a DDA voxel as XLA computes ``_raycast_loop``'s
    ``state_at`` expressions on the CPU (a copy of lines 176-193)."""
    resf = jnp.float32(res)
    p = idx.astype(jnp.float32) * resf
    blk = jnp.floor(p / jnp.float32(bs) + 0.5).astype(jnp.int32)
    c = blk.astype(jnp.float32) * jnp.float32(bs)
    v = jnp.clip(((p - c) / resf + jnp.float32(n) / 2.0).astype(jnp.int32), 0, n - 1)
    return blk, v


def _f32_local_index(idx, res, bs, n):
    """The same expressions in f32, one rounding an operation (the port)."""
    r, b = np.float32(res), np.float32(bs)
    p = idx.astype(np.float32) * r
    blk = np.floor(p / b + np.float32(0.5)).astype(np.int32)
    c = blk.astype(np.float32) * b
    return blk, np.clip(((p - c) / r + np.float32(n) / np.float32(2)).astype(np.int32),
                        0, n - 1)


def _path(o, d, res, steps):
    """The voxels a DDA ray visits in ``steps`` steps, in f32 as K6 steps."""
    r = np.float32(res)
    idx = np.floor(o / r + np.float32(0.5)).astype(np.int32)
    step = np.where(d > 0, 1, -1).astype(np.int32)
    tiny = np.abs(d) < np.float32(1e-12)
    safe = np.where(tiny, np.float32(1e-12), d).astype(np.float32)
    bound = (idx + (step > 0)).astype(np.float32) * r - r / np.float32(2)
    with np.errstate(divide="ignore"):
        t_max = np.where(tiny, np.float32(np.inf), (bound - o) / safe).astype(np.float32)
    t_delta = np.abs(r / safe).astype(np.float32)
    out = [idx.copy()]
    for _ in range(steps):
        ax = int(np.argmin(t_max))
        idx[ax] += step[ax]
        t_max[ax] = t_max[ax] + t_delta[ax]
        out.append(idx.copy())
    return np.stack(out)


def assert_matches_jax_device(m, jm, o, d, max_range, snapshot=None, jsnapshot=None):
    """Port raycast_device (plain K6) against JAX raycast_device: equal on
    every ray except named ones.  Each named ray has a voxel on its path that
    XLA's CPU code and the f32 expressions read apart, and each such voxel
    is a tie (its centre on a block or voxel face in exact arithmetic).  The
    JAX host stepper arbitrates: the port agrees with it (hit and steps) on
    at least as many rays as the JAX DDA does, and on ≥ 95 % of them (the
    JAX package's own bar, tests/test_aux.py:210).  Returns (port result,
    named rays)."""
    ours = rc.raycast_device(m, o, d, max_range, snapshot=snapshot)
    ref = {k: np.asarray(v) for k, v in
           jrc.raycast_device(jm, o.copy(), d.copy(), max_range, snapshot=jsnapshot).items()}
    same = ((ours["hit"] == ref["hit"]) & (ours["steps"] == ref["steps"])
            & (ours["distance"] == ref["distance"]))
    named = np.nonzero(~same)[0]
    host = jrc.raycast(jm, o, d, max_range)

    def agree(r):
        return int(((r["hit"] == host["hit"]) & (r["steps"] == host["steps"])).sum())

    assert agree(ours) >= agree(ref) and agree(ours) >= 0.95 * len(o), \
        (agree(ours), agree(ref), named)
    assert_ties_on_path(m, o, d, ours, named)
    return ours, named


def assert_ties_on_path(m, o, d, ours, named):
    """Each ray of ``named`` has a voxel on the port's path (``ours``) that
    XLA's CPU code and the f32 expressions read apart, and each such voxel
    is a tie: its centre on a block or voxel face in exact arithmetic."""
    cfg = m.cfg
    for i in named:
        dn = (d[i] / np.linalg.norm(d[i].astype(np.float64))).astype(np.float32)
        path = _path(o[i], dn, cfg.resolution, int(ours["steps"][i]))
        jb, jv = (np.asarray(x) for x in _jax_local_index(path, cfg.resolution,
                                                          m.block_size, m.n))
        fb, fv = _f32_local_index(path, cfg.resolution, m.block_size, m.n)
        apart = np.nonzero((jb != fb).any(1) | (jv != fv).any(1))[0]
        assert len(apart), f"ray {i}: no voxel of its path is read apart"
        # exact arithmetic: p/bs + 1/2 or (p − c)/res + n/2 is an integer
        # there (the voxel centre lies on a block or voxel face)
        k = path[apart].astype(np.int64)
        blk_exact = k / m.n + 0.5
        loc_exact = k - fb[apart].astype(np.int64) * m.n + m.n / 2
        tie = (blk_exact == np.round(blk_exact)) | (loc_exact == np.round(loc_exact))
        assert tie.all(), f"ray {i}: a voxel read apart off a face"


def test_raycast_plain_counts_the_probes_each_lookup_takes():
    """``count_probes``: per ray, the hash probes of the lookups it made —
    from the voxel's hash slot to the matching or an empty entry, at most
    ``max_probes`` — walked here in numpy over the ray's f32 path.  The
    count K6's bound uses."""
    args, kw = raycast_inputs(9, n_rays=200)
    hit, dist, steps, probes, _, _ = k6.raycast_plain(*args, **kw, count_probes=True)
    for x, y in zip((hit, dist, steps), k6.raycast_plain(*args, **kw)):
        assert torch.equal(x, y)
    _, hi, lo, _, o, d = (x.numpy() for x in args)
    H, res, bs = len(hi), np.float32(kw["res"]), np.float32(kw["bs"])
    assert int(probes.sum()) > int(steps.sum() + hit.sum())   # chains longer than 1
    for i in range(0, 200, 7):
        lookups = int(steps[i]) + int(hit[i])
        count = 0
        for idx in _path(o[i], d[i], kw["res"], int(steps[i]))[:lookups]:
            blk = np.floor(idx.astype(np.float32) * res / bs + np.float32(0.5))
            khi, klo = (int(k) for k in rc._split_keys(blk.astype(np.int64)))
            h = ((khi * k6.HC1) ^ (klo * k6.HC2)) & (H - 1)
            for j in range(kw["max_probes"]):
                pos = (h + j) & (H - 1)
                if (hi[pos] == khi and lo[pos] == klo) or hi[pos] == -1:
                    break
            count += j + 1
        assert int(probes[i]) == count, i


def _paths(o, d, res, L):
    """The voxels [N, L+1, 3] of N rays' first L steps, in f32 as K6 steps
    (:func:`_path` for every ray at once)."""
    r = np.float32(res)
    idx = np.floor(o / r + np.float32(0.5)).astype(np.int32)
    step = np.where(d > 0, 1, -1).astype(np.int32)
    tiny = np.abs(d) < np.float32(1e-12)
    safe = np.where(tiny, np.float32(1e-12), d).astype(np.float32)
    bound = (idx + (step > 0)).astype(np.float32) * r - r / np.float32(2)
    with np.errstate(divide="ignore"):
        t_max = np.where(tiny, np.float32(np.inf), (bound - o) / safe).astype(np.float32)
    t_delta = np.abs(r / safe).astype(np.float32)
    rows = np.arange(len(o))
    out = [idx.copy()]
    for _ in range(L):
        ax = np.argmin(t_max, axis=1)
        idx[rows, ax] += step[rows, ax]
        t_max[rows, ax] = t_max[rows, ax] + t_delta[rows, ax]
        out.append(idx.copy())
    return np.stack(out, 1)


def _cache_walk(args, kw, invalidate=True):
    """Every ray's lookups in order (its steps, and one more where it hit),
    looked up directly (``lookup_plain``) and through K6's block cache: the
    hash probed at the ray's first lookup and wherever the block differs
    from the previous lookup's (``invalidate`` False: a broken cache that
    keeps the first block's slot).  Returns (valid [N, L], the direct slot,
    the cached slot, probes, the lookups that probe [N, L] each) and the
    plain version's block-mode (probes, probed) per ray."""
    state, hi, lo, sl, o, d = args
    hit, _, steps, _, probes_b, probed_b = k6.raycast_plain(*args, **kw, count_probes=True)
    for x, y in zip((hit, steps), k6.raycast_plain(*args, **kw)[::2]):
        assert torch.equal(x, y)
    n = (steps + hit).numpy()
    L = int(n.max())
    path = _paths(o.numpy(), d.numpy(), kw["res"], L - 1)                  # [N,L,3]
    valid = np.arange(L)[None] < n[:, None]
    _, probes, blk, slot = k6.lookup_plain(
        state, hi, lo, sl, torch.from_numpy(path.reshape(-1, 3)),
        res=torch.tensor(np.float32(kw["res"])), bs=torch.tensor(np.float32(kw["bs"])),
        n=kw["n"], max_probes=kw["max_probes"])
    N = len(n)
    blk, slot, probes = blk.numpy().reshape(N, L, 3), slot.numpy().reshape(N, L), \
        probes.numpy().reshape(N, L)
    new = np.zeros((N, L), bool)
    new[:, 0] = True
    if invalidate:
        new[:, 1:] = (blk[:, 1:] != blk[:, :-1]).any(-1)
    last = np.maximum.accumulate(np.where(new, np.arange(L)[None], 0), axis=1)
    cached = np.take_along_axis(slot, last, axis=1)
    return (valid, slot, cached, probes, new), (probes_b.numpy(), probed_b.numpy())


def _wall_snapshot_case(tmp_path):
    m = _carry(_wall_map(), bgk.BGKOctoMap, tmp_path)
    s = rc.raycast_snapshot(m)
    o, d = _rays(3, 400)
    d = (d / np.linalg.norm(d.astype(np.float64), axis=1, keepdims=True)).astype(np.float32)
    args = (s.state_tab, s.tab_hi, s.tab_lo, s.tab_slot, torch.from_numpy(o),
            torch.from_numpy(d))
    kw = dict(res=s.res, bs=s.bs, n=s.n, max_steps=int(np.ceil(5.0 / s.res) * 3 + 8),
              target=posterior.OCCUPIED, max_range=5.0, max_probes=s.max_probes)
    return args, kw


def _k6_case(case, tmp_path):
    if case == "synthetic":
        return raycast_inputs(12, n_rays=600)
    if case == "chain":
        return raycast_chain_inputs()
    return _wall_snapshot_case(tmp_path)


@pytest.mark.parametrize("case", ["synthetic", "chain", "wall_map"])
def test_k6_block_cache_finds_each_lookups_slot(case, tmp_path):
    """K6's block cache: along every ray, the slot found once per block (at
    the ray's first lookup and at each block change) equals the direct
    lookup's slot at every step; the plain block-mode count equals a direct
    count of those lookups and their probes.  A control that never
    refreshes the cache after the first block reads a wrong slot."""
    args, kw = _k6_case(case, tmp_path)
    (valid, slot, cached, probes, new), (probes_b, probed_b) = _cache_walk(args, kw)
    assert (cached == slot)[valid].all()
    np.testing.assert_array_equal(probed_b, (new & valid).sum(1))
    np.testing.assert_array_equal(probes_b, np.where(new & valid, probes, 0).sum(1))
    # the cache saves probes: most lookups stay in the block of the last one
    assert (new & valid).sum() < 0.5 * valid.sum()
    (valid, slot, cached, _, _), _ = _cache_walk(args, kw, invalidate=False)
    assert (cached != slot)[valid].any()


# ------------------------------------------------ tables

def test_block_hash_matches_jax():
    rng = np.random.default_rng(0)
    for coords in (rng.integers(-50, 50, (300, 3)),
                   np.stack([np.arange(0, 161, 1)] * 3, 1),
                   np.stack(np.meshgrid(np.arange(-4, 5), np.arange(-4, 5), np.arange(-2, 3),
                                        indexing="ij"), -1).reshape(-1, 3)):
        slots = rng.permutation(len(coords)).astype(np.int32)
        for a, b in zip(rc._split_keys(coords), jrc._split_keys(coords)):
            np.testing.assert_array_equal(a, b)
        ours = rc._build_block_hash(coords, slots, len(coords) + 3)
        ref = jrc._build_block_hash(coords, slots, len(coords) + 3)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


def test_snapshot_tables_match_jax(tmp_path):
    jm = _wall_map()
    m = _carry(jm, bgk.BGKOctoMap, tmp_path)
    s, js = rc.raycast_snapshot(m), jrc.raycast_snapshot(jm)
    for k in ("tab_hi", "tab_lo", "tab_slot", "state_tab"):
        np.testing.assert_array_equal(getattr(s, k).numpy(), np.asarray(getattr(js, k)))
    assert (s.max_probes, s.res, s.bs, s.n) == (js.max_probes, js.res, js.bs, js.n)
    assert s.state_tab.dtype == torch.int8
    assert (s.state_tab[-1] == posterior.UNKNOWN).all()


# ------------------------------------------------ the host stepper

def test_host_raycast_matches_jax(tmp_path):
    jm = _wall_map()
    m = _carry(jm, bgk.BGKOctoMap, tmp_path)
    o, d = _rays(1, 120)
    ours, ref = rc.raycast(m, o, d, 5.0), jrc.raycast(jm, o, d, 5.0)
    for k in ("hit", "steps", "distance", "point"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert 0 < ours["hit"].sum() < len(o)


# ------------------------------------------------ the device DDA (plain K6)

def test_raycast_device_matches_jax(tmp_path):
    jm = _wall_map()
    m = _carry(jm, bgk.BGKOctoMap, tmp_path)
    o, d = _rays(2, 1500)
    k6.launches = 0
    ours, named = assert_matches_jax_device(m, jm, o, d, 5.0)
    assert k6.launches == 0                         # CPU: the plain version
    assert 0 < ours["hit"].sum() < len(o) and len(named) > 0
    # on this map the port agrees with the host stepper on every ray
    host = rc.raycast(m, o, d, 5.0)
    np.testing.assert_array_equal(ours["hit"], host["hit"])
    np.testing.assert_array_equal(ours["steps"], host["steps"])
    both = ours["hit"]
    np.testing.assert_allclose(ours["distance"][both], host["distance"][both], rtol=1e-5)


def test_raycast_device_long_diagonal_map_and_snapshot_reuse(tmp_path):
    jm = _diagonal_map()
    m = _carry(jm, bgk.BGKOctoMap, tmp_path)
    snap, jsnap = rc.raycast_snapshot(m), jrc.raycast_snapshot(jm)
    assert snap.tab_hi.shape[0] < 4096  # O(blocks), not O(bbox volume)
    bs = m.block_size
    o = np.array([[k * bs - 0.6] * 3 for k in range(0, 161, 40)], np.float32)
    d = np.tile(np.float32([1, 1, 1]) / np.sqrt(3), (len(o), 1))
    ours, _ = assert_matches_jax_device(m, jm, o, d, 2.0, snap, jsnap)
    assert ours["hit"].all()
    # snapshot reuse: a second query on the same tables, away from the walls
    again, _ = assert_matches_jax_device(m, jm, o, -d, 2.0, snap, jsnap)
    assert not again["hit"].any()
    fresh = rc.raycast_device(m, o, -d, 2.0)
    for k in again:
        np.testing.assert_array_equal(again[k], fresh[k])


def test_raycast_device_bgklv_map(tmp_path):
    """A BGKLV map at block_depth 5 (16³ voxels a block, stored tile-major
    in 8³ tiles): the snapshot reads its state in raster order through
    ``_stored_to_raster_dev``."""
    rng = np.random.default_rng(4)
    jm = jbgklv.BGKLVOctoMap(dataclasses.replace(LV_CFG, block_depth=5))
    cloud, origin = synthetic_scan(rng, n=40)
    jm.insert_pointcloud(cloud, origin, max_range=6.0)
    m = _carry(jm, bgklv.BGKLVOctoMap, tmp_path)
    s, js = rc.raycast_snapshot(m), jrc.raycast_snapshot(jm)
    np.testing.assert_array_equal(s.state_tab.numpy(), np.asarray(js.state_tab))
    cols = m._stored_to_raster_dev(torch.arange(m.V)[None])[0]
    assert torch.equal(cols, torch.as_tensor(m._vox_inv)) and (cols != torch.arange(m.V)).any()
    assert len(np.unique(s.state_tab.numpy())) == 4     # free, occupied, unknown, uncertain
    o, d = _rays(5, 600, spread=0.3)
    ours, _ = assert_matches_jax_device(m, jm, o, d, 4.0)
    assert 0 < ours["hit"].sum()


def test_raycast_device_rays_from_absent_blocks_and_along_axes():
    """Rays from outside every block and rays along an axis (t_max = inf on
    the others) through the plain K6 on synthetic tables, against a direct
    f32 replay of their paths."""
    from torch_cases import raycast_inputs

    args, kw = raycast_inputs(6, n_rays=400)
    hit, dist, steps = k6.raycast(*args, **kw)
    o, d = args[4].numpy(), args[5].numpy()
    axis = (np.abs(d) < 1e-12).sum(1) == 2
    assert axis.sum() > 20 and hit.any() and (~hit).any()
    for i in np.nonzero(axis)[0][:10]:
        path = _path(o[i], d[i], kw["res"], int(steps[i]))
        moved = np.nonzero((path[-1] != path[0]))[0]
        assert len(moved) <= 1                   # an axis ray moves along one axis
    # a miss runs until past the range or out of steps
    miss = ~hit.numpy()
    assert (steps.numpy()[miss] > 0).all()
