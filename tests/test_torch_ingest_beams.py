"""K7a's beam samples on the CPU: the compact layout (only the samples that
exist, in the dense layout's (hit, slot) order, and their count) against
the dense layout's kept rows, at the range and cell boundaries; the kernel's
closed-form kept count, in a numpy twin of its f32 steps, against the dense
layout's masks; and the free downsample over the compact samples and their
count equal to the one over the dense layout.  The card tests of the kernel
are in tests/test_torch_cuda.py; the tables against the JAX package in
tests/test_torch_ingest.py.
"""

import numpy as np
import pytest
import torch

from la3dm_tpu_torch.geometry import device_ingest
from la3dm_tpu_torch.kernels import ingest_beams, ingest_keys

from torch_cases import (INGEST, beam_edge_hits, beam_kwargs,  # noqa: F401
                         ingest_scene, one_torch_thread)

F32 = np.float32


@pytest.mark.parametrize("fr", [0.5, 0.1, 0.3])
def test_compact_beam_samples_at_range_and_cell_edges(fr):
    """Each edge hit (``beam_edge_hits``) keeps the samples the dense layout
    keeps, in its order, their keys and the in-range flags equal, the count
    their number, and as many as the closed form says: none out of range or
    at the origin, the origin only within fr, a sample less where l is
    exactly (k + 1)·fr (the test is d < l)."""
    hits, keys, origins, anchors, names, kept = beam_edge_hits(fr)
    kw = beam_kwargs(fr=fr)
    fpts, fkeys, inr, count = ingest_beams.beam_samples(hits, keys, origins, anchors, **kw)
    dpts, dkeys, dinr = ingest_beams.beam_samples_plain(hits, keys, origins, anchors, **kw)
    keep = dkeys != ingest_keys.SENT
    n = int(count)
    assert count.dtype == torch.int32 and count.shape == (1,) and n == int(keep.sum())
    assert fpts.shape == (n, 3) and fkeys.shape == (n,)
    assert torch.equal(fpts, dpts[keep]) and torch.equal(fkeys, dkeys[keep])
    assert torch.equal(inr, dinr)
    per_hit = keep.view(len(names), -1).sum(1).tolist()
    assert per_hit == kept, list(zip(names, per_hit))


def _kept_prefix(l, kf: int, fr):
    """The kernel's kept k < kf, in numpy f32: the estimate l / fr (an IEEE
    division, truncated, at most kf), settled down while not (float)n·fr <
    l and up while (float)(n + 1)·fr < l."""
    l, fr = np.asarray(l, F32), F32(fr)
    est = l / fr
    n = np.where(est < F32(kf), est.astype(np.int64), kf)
    for _ in range(kf + 1):
        down = (n > 0) & ~(n.astype(F32) * fr < l)
        n = n - down
    for _ in range(kf + 1):
        up = (n < kf) & ((n + 1).astype(F32) * fr < l)
        n = n + up
    return n


@pytest.mark.parametrize("fr,mr", [(0.5, 8.0), (0.1, 8.0), (0.3, 8.0), (0.7, 30.0)])
def test_closed_form_kept_count_equals_the_masks(fr, mr):
    """The kept count of every hit in range: the kernel's estimate-and-settle
    prefix of k < kf, plus (l > fr), plus the origin, equals the dense
    layout's mask count, on l at every (k + 1)·fr in f32, 4 ulps either
    side, and 20,000 random ranges in (0, mr]."""
    kf = int(np.floor(mr / fr)) + 1
    d = F32(np.arange(1, kf + 1)) * F32(fr)
    near = [d]
    for toward in (F32(0), F32(2 * mr)):
        x = d
        for _ in range(4):
            x = np.nextafter(x, toward)
            near.append(x)
    rng = np.random.default_rng(7)
    l = np.concatenate(near + [rng.uniform(0, mr, 20000).astype(F32), [F32(mr), F32(fr)]])
    l = l[(l > 0) & (l <= F32(mr))]
    want = (d[None, :] < l[:, None]).sum(1) + (l > F32(fr)) + 1
    got = _kept_prefix(l, kf, fr) + (l > F32(fr)) + 1
    assert np.array_equal(got, want)


def test_free_downsample_over_the_compact_samples_equals_the_dense():
    """A real scene's beam samples: the compact layout is the dense one's
    kept rows; the free downsample (K7s, K7b) over them and their count
    gives the same voxel keys and centroids, bit for bit, as over the dense
    layout with its sentinels (the stable sort keeps each voxel's samples
    in the same order)."""
    pts, scan, origins, ca, _ = ingest_scene(44)
    kw = beam_kwargs()
    keys = ingest_beams.point_keys_plain(pts, scan, origins, ca, inv_leaf=kw["inv_leaf"],
                                         lim=float(F32((INGEST["mr"] + np.sqrt(3.0)
                                                        * INGEST["ds"]) ** 2)))
    leaf = float(F32(INGEST["ds"]))
    hkey, hits = device_ingest._downsample(pts, keys, ca, leaf)
    fpts, fkeys, inr, count = ingest_beams.beam_samples(hits, hkey, origins, ca, **kw)
    dpts, dkeys, dinr = ingest_beams.beam_samples_plain(hits, hkey, origins, ca, **kw)
    keep = dkeys != ingest_keys.SENT
    assert torch.equal(fpts, dpts[keep]) and torch.equal(fkeys, dkeys[keep])
    assert torch.equal(inr, dinr) and int(count) == int(keep.sum()) > 1000
    assert int(count) < 0.9 * keep.numel()          # slots dropped, not written
    # the compact arrays with room past the count, as on the card
    pad = torch.full((keep.numel() - int(count),), ingest_keys.SENT - 1)
    ckey, cfree = device_ingest._downsample(torch.cat([fpts, torch.zeros(len(pad), 3)]),
                                            torch.cat([fkeys, pad]), ca, leaf, count=count)
    dkey, dfree = device_ingest._downsample(dpts, dkeys, ca, leaf)
    assert torch.equal(ckey, dkey) and torch.equal(cfree, dfree)
