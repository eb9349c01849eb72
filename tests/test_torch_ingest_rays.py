"""K7d's dedup by contiguity along the ray, in plain PyTorch on the CPU.

The kernel (``csrc/ingest_rays.cu``) finds each ray's distinct block keys
without a sort: walking the proxy samples in d-order (k = 1..Kf, then the
origin), a membership is the ray's first occurrence of its block exactly
when the kept sample before it does not hold that block.
``ingest_rays.first_in_ray_plain`` is that rule; here it must give the pair
list of ``ray_pairs_plain`` (each ray's row sorted, first-in-run flags) on
rays made to break it: samples exactly on block faces and edges, rays along
each axis, origins on a face, lengths within an ulp of k·fr and of the
range, rays out of range; at the BGKL demo's S = 28 samples a ray, the
large map's S = 6 and a config of S = 82 (chunks of 32 on the card).  The
rule with the samples in index order and the origin first must fail.  The
card tests of the kernel are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from la3dm_tpu_torch.kernels import ingest_rays

from torch_cases import RAY_CONFIGS as CONFIGS, edge_rays, face, ray_args, ray_slots
from torch_cases import one_torch_thread  # noqa: F401

F32 = np.float32


def _by_contiguity(args, kw, order=None):
    *_, keys, kept = ingest_rays.ray_keys_plain(*args, **kw)
    order = ingest_rays.d_order(kw["kf"]) if order is None else order
    return ingest_rays.first_in_ray_plain(keys, kept, order)


def _check(args, kw):
    _, _, inr, ray, key, _ = ingest_rays.ray_pairs_plain(*args, **kw)
    got_ray, got_key = _by_contiguity(args, kw)
    assert torch.equal(got_ray, ray) and torch.equal(got_key, key)
    return inr, ray


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_contiguity_rule_equals_the_sorted_dedup_on_edge_rays(config):
    args, kw = edge_rays(config)
    inr, ray = _check(args, kw)
    R = args[0].shape[0]
    assert (~inr).sum() >= 6 and inr.sum() > 0.8 * R
    # some sample holds 8 blocks (a corner) and some ray several dozen pairs
    *_, keys, kept = ingest_rays.ray_keys_plain(*args, **kw)
    n_mem = (keys != torch.iinfo(torch.int64).max).sum(-1)
    assert int(n_mem.max()) == 8 and int((n_mem == 4).sum()) > 10
    assert int(torch.bincount(ray).max()) > (20 if config != "large_map" else 8)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_index_order_rule_fails(config):
    """The deliberately broken rule — compare with the sample before in
    index order (k − 1), the origin first — keeps duplicate blocks."""
    args, kw = edge_rays(config)
    _, _, _, ray, key, _ = ingest_rays.ray_pairs_plain(*args, **kw)
    S = kw["kf"] + 1
    bad_ray, bad_key = _by_contiguity(args, kw, order=torch.arange(S))
    assert bad_ray.numel() > ray.numel()
    assert not torch.equal(bad_ray, ray)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), snap=st.lists(st.booleans(), min_size=6, max_size=6),
       n=st.integers(1, 60))
def test_contiguity_rule_on_random_rays(config, seed, snap, n):
    """Random rays from an origin with chosen coordinates on block faces (or
    at zero), directions snapped to an axis or a face plane half of the
    time, lengths anywhere up to past the range, a quarter of them within an
    ulp of k·fr."""
    mr, fr, bs = CONFIGS[config]
    kf = ray_slots(mr, fr)
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5 * bs, 5 * bs, 3).astype(F32)
    for a in range(3):
        if snap[a]:
            o[a] = face(int(rng.integers(-4, 4)), bs) if snap[3 + a] else F32(0)
    d = rng.normal(size=(n, 3))
    zero = rng.random((n, 3)) < 0.25
    zero[zero.all(1), 0] = False
    d[zero] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lengths = rng.uniform(0, 1.1 * mr, n).astype(F32)
    near = rng.random(n) < 0.25
    k = rng.integers(1, kf + 1, n)
    x = (k.astype(F32) * F32(fr)).astype(F32)
    lengths[near] = np.nextafter(x, F32(np.inf) * rng.choice([-1, 1], n))[near]
    args = ray_args(o[None], np.zeros(n, np.int64), d.astype(F32), lengths, bs)
    _check(args, dict(kf=kf, mr=float(F32(mr)), fr=float(F32(fr)), block_size=bs))


@pytest.mark.parametrize("kf", [0, 1])
def test_contiguity_rule_with_one_or_two_samples(kf):
    """Kf = 0 leaves the origin alone; Kf = 1 one sample before it."""
    args, kw = edge_rays("demo", seed=3, n_random=100)
    kw = dict(kw, kf=kf)
    _, ray = _check(args, kw)
    assert ray.numel() > 0
    assert ingest_rays.d_order(kf).tolist() == list(range(1, kf + 1)) + [0]


def test_lanes_per_ray():
    """One lane a sample up to a warp: the demo's 28 samples on 32 lanes
    (one ray a warp), the large map's 6 on 8 (four rays a warp), 82 in
    chunks of 32."""
    assert [ingest_rays.lanes_per_ray(k) for k in (0, 1, 5, 27, 31, 81)] == \
        [1, 2, 8, 32, 32, 32]
