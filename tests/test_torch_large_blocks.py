"""The port at block_depth 5 (16³ = 4096 voxels a block, the light passes
K2 and K5 across 8³ tiles) and the BGK large map, against the JAX package,
on the CPU through the kernels' plain versions.

Configs: ``bgkloctomap_large_map.yaml`` (block_depth 5: resolution 0.2,
3.2 m blocks, ℓ 0.6, free_resolution 6.5, gate 0.001),
``bgkoctomap_large_map.yaml`` (block_depth 3) and ``gpoctomap_large_map``
with ``block_depth=5``.  Scans are the small walls of
tests/test_bgk_vs_oracle.py, from a numpy seed, for both packages.  Limits
are those of the depth-3 tests:

* the engine step (the captured JAX ``_bgk_seq_step(segments=True,
  gate=0.001)``) within 1e-4 (tests/test_torch_bgkl.py), here from a raster
  pool that collapses at every level, the 16³ level across tiles included;
* host-ingest maps within 2e-3 (one scan) and 5e-3 (several), eff and
  touched equal where the added mass exceeds 1e-5 (tests/test_torch_bgk.py);
* device-ingest maps against JAX's ``device_ingest="on"`` within 1e-5 +
  1e-5·|JAX| (tests/test_torch_ingest.py);
* GP maps as tests/test_torch_gp.py::assert_matches_jax.

JAX gets copies of every array it is handed (its steps donate their inputs
and run asynchronously).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from la3dm_tpu.models import bgk as jbgk, bgkl as jbgkl, gp as jgp
from la3dm_tpu.utils.config import load_method_config as jload_method_config

from la3dm_tpu_torch.kernels import bgk_aligned_heavy, bgk_heavy, bgk_light, gp_light
from la3dm_tpu_torch.models import bgk, bgkl, gp, posterior
from la3dm_tpu_torch.utils.config import MapConfig, load_method_config

from tests.test_bgk_vs_oracle import synthetic_scan
from tests.test_torch_bgk import MASS_TOL, _pool, assert_same_map
from tests.test_torch_gp import assert_matches_jax
from tests.test_torch_ingest import assert_bgk_matches
from torch_cases import (BETA_TEMPLATES, collapsible_raster_pool,  # noqa: F401
                         one_torch_thread)

BGKL_LARGE = jload_method_config("bgkloctomap_large_map")
BGK_LARGE = jload_method_config("bgkoctomap_large_map")
#: JAX's own smallest pads (not tests/test_torch_gp.py's larger seeds): at
#: 4681 nodes a block JAX predicts every padded (block, slot) row
GP_DEPTH5 = jload_method_config("gpoctomap_large_map", block_depth=5, max_range=8.0)


def _t(cfg):
    return MapConfig(**dataclasses.asdict(cfg))


def _scans(seed, k, n=60):
    rng = np.random.default_rng(seed)
    return [synthetic_scan(rng, n=n, origin=(0.1, -0.2 + 0.3 * i, 0.3)) for i in range(k)]


def _insert_both(ours, jm, scans):
    """One dispatch of ``scans`` into the port's map and the JAX map."""
    ours.insert_pointclouds([c for c, _ in scans], [o for _, o in scans])
    jm.insert_pointclouds([c.copy() for c, _ in scans], [o.copy() for _, o in scans])
    jax.block_until_ready(list(jm.pool.fields.values()))


def test_configs_are_the_jax_packages():
    """The port's copies of the large-map YAMLs and the depth-5 GP override
    load as the JAX package's: BGKL at block_depth 5, BGK at 3."""
    for name, ref, depth in (("bgkloctomap_large_map", BGKL_LARGE, 5),
                             ("bgkoctomap_large_map", BGK_LARGE, 3)):
        cfg = load_method_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.block_depth == depth and cfg.max_range == 30.0
    gp5 = load_method_config("gpoctomap_large_map", block_depth=5, max_range=8.0)
    assert dataclasses.asdict(gp5) == dataclasses.asdict(GP_DEPTH5)
    assert gp5.cells_per_edge == 16 and gp5.voxels_per_block == 4096


def test_light_wrappers_take_blocks_up_to_64_voxels_an_edge():
    """n ≤ 64 (block_depth ≤ 7) passes the wrappers' check; above, and off
    a power of two, the message names the limit."""
    for n in (2, 4, 8, 16, 32, 64):
        bgk_light.check_block_edge("bgk_light", n, n ** 3)
    for n, V in ((128, 128 ** 3), (12, 12 ** 3), (16, 512)):
        with pytest.raises(ValueError, match="≤ 64"):
            bgk_light.check_block_edge("gp_light", n, V)


# ------------------------------------------------ (a) the engine step

def test_seq_step_plain_matches_jax_step_from_a_collapsible_pool():
    """The captured JAX ``_bgk_seq_step(segments=True, gate=0.001)`` of a
    3-scan BGKL large-map dispatch, started from a raster pool whose blocks
    collapse at every level, against the port's step (plain K1's segment
    branch, plain K2) on the same inputs: A/B within 1e-4, touched and eff
    equal everywhere, and 16³ groups (level 4, across the 8³ tiles)
    collapse."""
    scans = _scans(40, 3, n=40)
    jm = jbgkl.BGKLOctoMap(BGKL_LARGE)
    jm._capture_step_args = True
    jm.insert_pointclouds([c.copy() for c, _ in scans], [o.copy() for _, o in scans])
    jax.block_until_ready(list(jm.pool.fields.values()))
    args = [np.array(a, copy=True) for a in jm._last_step_call[0]]
    st = jm._last_step_call[1]
    assert st["segments"] and st["gate"] == 0.001 and st["n"] == 16
    assert st["max_level"] == 4 and args[6].shape[1] == 6
    cap, n = args[0].shape[0], st["n"]
    slots = args[13]
    sl = np.unique(slots[slots < cap])
    A0, B0, T0, E0 = collapsible_raster_pool(n, len(sl), BETA_TEMPLATES, seed=41)
    for i, x in enumerate((A0, B0, T0, E0)):
        args[i][sl] = x
    start = [a.copy() for a in args[:4]]
    ref = [np.array(r) for r in jbgk._bgk_seq_step(*(a.copy() for a in args), **st)]

    # the port's step takes the tuple without JAX's padding rows (count 0,
    # inert: tests/test_torch_kernels.py::test_bgk_heavy_padding_rows_are_inert),
    # which its plain K1 would otherwise evaluate at every node
    rows = args[12] > 0
    targs = [torch.from_numpy(a[rows] if i in (10, 11, 12) else a.copy())
             for i, a in enumerate(args[:15])]
    sf = st["state_fn"]
    kw = dict(G=st["G"], sf2=st["sf2"], ell=st["ell"], gate=st["gate"], n=n,
              max_level=st["max_level"], do_prune=st["do_prune"],
              state_fn=posterior.BetaStateFn(sf.var_thresh, sf.free_thresh,
                                             sf.occupied_thresh))
    bgk._bgk_seq_step(*targs, args[15].tolist(), args[16].tolist(), **kw)
    A, B, touched, eff = (x.numpy() for x in targs[:4])
    np.testing.assert_allclose(A, ref[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(B, ref[1], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(touched, ref[2])
    np.testing.assert_array_equal(eff, ref[3])
    added = np.maximum(np.abs(ref[0] - start[0]), np.abs(ref[1] - start[1]))
    assert (added[sl] > MASS_TOL).sum() > 1000            # the scans updated the pool
    levels = np.bincount(eff[sl].reshape(-1), minlength=5)
    assert levels[4] >= 4096 and (levels[1:4] > 0).all()   # level 4 spans the tiles
    assert (eff[sl] != start[3][sl]).any()


# ------------------------------------------------ (b), (c) the BGKL large map

@pytest.mark.parametrize("n_scans,atol", [(1, 2e-3), (3, 5e-3)])
def test_bgkl_large_map_host_ingest_matches_jax(n_scans, atol):
    cfg = dataclasses.replace(BGKL_LARGE, device_ingest="off")
    ours, jm = bgkl.BGKLOctoMap(_t(cfg), device="cpu"), jbgkl.BGKLOctoMap(cfg)
    bgk_heavy.launches = bgk_light.launches = 0
    _insert_both(ours, jm, _scans(42, n_scans))
    assert ours.n == 16 and ours.stats["scans"] == n_scans
    assert bgk_heavy.launches == bgk_light.launches == 0      # the plain versions
    assert_same_map(ours, jm, atol=atol)
    assert (_pool(ours)[3] > 0).any()


def test_bgkl_large_map_device_ingest_matches_jax():
    """Two scans, one dispatch each: the port's device path (plain K7a, K7b,
    K7d, K7c, K1′'s segment branch, K2) against JAX's.  (JAX's device step
    at 4681 nodes a block takes about 11 s a scan on the CPU, and a 2-scan
    dispatch over 150 s: the test keeps to one scan a dispatch.)"""
    cfg = dataclasses.replace(BGKL_LARGE, device_ingest="on")
    scans = _scans(43, 2, n=30)
    ours, jm = bgkl.BGKLOctoMap(_t(cfg), device="cpu"), jbgkl.BGKLOctoMap(cfg)
    bgk_aligned_heavy.launches = 0
    _insert_both(ours, jm, scans[:1])
    _insert_both(ours, jm, scans[1:])
    assert ours.stats["scans"] == 2 and ours.stats["ingest_host_chunks"] == 0
    assert bgk_aligned_heavy.launches == 0
    assert ours.stats["kernel_evals"] == jm.stats["kernel_evals"]
    assert_bgk_matches(ours, jm)
    assert (_pool(ours)[3] > 0).any()


# ------------------------------------------------ (d) the BGK large map

@pytest.mark.parametrize("mode", ["off", "on"])
def test_bgk_large_map_matches_jax(mode):
    """bgkoctomap_large_map.yaml (block_depth 3) on either ingest path: 1
    scan, then 2 more in one dispatch."""
    cfg = dataclasses.replace(BGK_LARGE, device_ingest=mode)
    scans = _scans(44, 3, n=100)
    ours, jm = bgk.BGKOctoMap(_t(cfg), device="cpu"), jbgk.BGKOctoMap(cfg)
    _insert_both(ours, jm, scans[:1])
    if mode == "off":
        assert_same_map(ours, jm, atol=2e-3)
    _insert_both(ours, jm, scans[1:])
    assert ours.n == 4 and ours.stats["scans"] == 3
    if mode == "off":
        assert_same_map(ours, jm, atol=5e-3)
    else:
        assert ours.stats["ingest_host_chunks"] == 0
        assert_bgk_matches(ours, jm)
    assert (_pool(ours)[3] > 0).any()


# ------------------------------------------------ (e) GP at block_depth 5

@pytest.mark.parametrize("n_scans", [1, 2])
def test_gp_depth5_matches_jax(n_scans):
    """``gpoctomap_large_map`` at block_depth 5 (K4 at Vall = 4681, K5 at
    V = 4096 with the prune over 4 levels, plain versions), host ingest."""
    ours, jm = gp.GPOctoMap(_t(GP_DEPTH5), device="cpu"), jgp.GPOctoMap(GP_DEPTH5)
    gp_light.launches = 0
    _insert_both(ours, jm, _scans(45, n_scans, n=40))
    assert ours.n == 16 and gp_light.launches == 0
    assert_matches_jax(ours, jm, min_touched=100)
