"""K7s (the stable sort and run cut of device ingest's keys) and K7t (the
bucket tail), their plain versions on the CPU.

The compact codes must round-trip and order keys as the int64 keys do, at
the windows' edges; a valid key outside its window must raise; the windows
the statics give must hold every key a reachable point or membership makes;
the plain sort must equal a numpy stable argsort and run cut (ties, all
sentinels, no keys, one long run); and the new tail (K7s + K7t) must give
the tables of the parent's ``_bucket`` (``torch.sort`` / ``unique`` /
``searchsorted`` over the padded sort) on a real dispatch's keys, on every
valid row.  The card tests of the kernels are in tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from la3dm_tpu_torch.geometry import blocks as geo, device_ingest
from la3dm_tpu_torch.kernels import (ingest_beams, ingest_bucket, ingest_keys, ingest_members,
                                     ingest_sort)

from torch_cases import (INGEST, bucket_inputs, ingest_scene,  # noqa: F401
                         one_torch_thread)

#: (mr, ds, block_size) of the demos (BGK, GP, BGKL: 8 m, ds 0.1, 0.4 m
#: blocks), the BGK large map (30 m, ds 0.1, 0.8 m blocks) and the BGKL
#: large map (30 m, ds 0.5, 3.2 m blocks)
CONFIGS = {"demo": (8.0, 0.1, 0.4), "bgk_large": (30.0, 0.1, 0.8),
           "bgkl_large": (30.0, 0.5, 3.2)}


def _windows(name: str, scans: int) -> dict:
    mr, ds, bs = CONFIGS[name]
    b = ingest_sort.block_window(mr, ds, bs, scans)
    return {"cell": ingest_sort.cell_window(mr, ds, scans), "block": b,
            "candidate": b.wider(1)}


def _keys_at_edges(rng, window, n: int, anchors) -> torch.Tensor:
    """n keys of the window's scans, a third on its faces and corners."""
    r = window.radius
    s = rng.integers(0, window.scans, n)
    off = rng.integers(-r, r + 1, (n, 3))
    edge = rng.random(n) < 0.35
    off[edge] = rng.choice([-r, r], (int(edge.sum()), 3))
    ijk = torch.from_numpy(anchors[s] + off)
    return ingest_keys.pack(torch.from_numpy(s), ijk, torch.from_numpy(anchors))


def _anchors(rng, scans: int) -> np.ndarray:
    return rng.integers(-5000, 5000, (scans, 3)).astype(np.int32)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("kind", ["cell", "block", "candidate"])
@settings(max_examples=25, deadline=None)
@given(scans=st.integers(1, 16), seed=st.integers(0, 2 ** 32 - 1))
def test_codes_round_trip_and_keep_the_key_order(config, kind, scans, seed):
    rng = np.random.default_rng(seed)
    w = _windows(config, scans)[kind]
    keys = _keys_at_edges(rng, w, 400, _anchors(rng, scans))
    codes, outside = ingest_sort.pack_plain(keys, w)
    assert not outside.any() and (codes >= 0).all()
    assert int(codes.max()) < 2 ** w.bits
    assert torch.equal(ingest_sort.unpack_plain(codes, w), keys)
    # the order of every pair (ties included)
    dk = torch.sign(keys[:, None] - keys[None, :])
    dc = torch.sign(codes[:, None] - codes[None, :])
    assert torch.equal(dk, dc)


def test_window_bits_and_passes():
    """The demo's cell keys take 27 bits (4 passes of 7), its block keys 21
    and its candidates 22 (3 passes); the BGK large map's cell keys still fit
    u32; the widest cell window device ingest accepts needs u64 codes."""
    demo = _windows("demo", 16)
    assert (demo["cell"].bits, demo["cell"].passes, demo["cell"].key_bytes) == (27, 4, 4)
    assert (demo["block"].bits, demo["block"].passes) == (21, 3)
    assert (demo["candidate"].bits, demo["candidate"].passes) == (22, 3)
    assert _windows("bgk_large", 16)["cell"].key_bytes == 4
    wide = ingest_sort.widest_window(16)
    assert wide.key_bytes == 8 and wide.bits == 35 and wide.passes == 5
    # one launch up to SMALL_SORT_KEYS keys; above, the histogram, a pass each
    # and the run cut
    assert ingest_sort.kernels_per_sort(demo["cell"], 56_000) == 6
    assert ingest_sort.kernels_per_sort(demo["block"], 3_556) == 1
    # the widest cell window covers every config beam_slots lets through
    for mr, ds in ((508 * 0.1, 0.1), (508 * 0.5, 0.5)):
        assert device_ingest.beam_slots(ds, ds, mr, 1.0) is not None
        assert ingest_sort.cell_window(mr, ds, 1).radius <= ingest_sort.MAX_CELL_RADIUS
    assert device_ingest.beam_slots(0.1, 0.1, 508.1 * 0.1, 1.0) is None


@pytest.mark.parametrize("threshold", [4096, 100, 0])
def test_sort_path_follows_the_threshold(threshold, monkeypatch):
    """The host picks K7s's path from N: the one-CTA path (one launch, its
    bytes the keys read once and the outputs) up to SMALL_SORT_KEYS keys,
    which the card tests move to reach both paths at N ± 1."""
    monkeypatch.setattr(ingest_sort, "SMALL_SORT_KEYS", threshold)
    w = _windows("demo", 16)["cell"]
    for n, small in ((threshold - 1, True), (threshold, True), (threshold + 1, False)):
        if n < 1:
            continue
        assert ingest_sort.small_sort(n) == small
        assert ingest_sort.kernels_per_sort(w, n) == (1 if small else w.passes + 2)
        # N keys, all valid, N runs, the rows' runs: 44 bytes a key on the
        # one-CTA path; above, keys read twice (16), four passes of u32 codes
        # and indices (8 + 16 + 16 + 20), the run cut (8 + 24 + 4)
        assert ingest_sort.passes_bytes(n, n, n, w, True) == (44 if small else 112) * n


@pytest.mark.parametrize("kind", ["cell", "block", "candidate"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_key_outside_its_window_raises(kind, axis):
    rng = np.random.default_rng(axis)
    w = _windows("demo", 4)[kind]
    anchors = _anchors(rng, 4)
    keys = _keys_at_edges(rng, w, 50, anchors)
    ijk = anchors[2].astype(np.int64).copy()
    ijk[axis] += w.radius + 1
    bad = ingest_keys.pack(torch.tensor([2]), torch.from_numpy(ijk[None]),
                           torch.from_numpy(anchors))
    keys = torch.cat([keys[:20], bad, torch.full((3,), ingest_keys.SENT), keys[20:]])
    codes, outside = ingest_sort.pack_plain(keys, w)
    assert int(outside.sum()) == 1 and bool(outside[20]) and int(codes[20]) == -1
    with pytest.raises(ValueError, match="outside their window"):
        ingest_sort.sort_runs_plain(keys, w)
    # a scan past the window's scans too
    other = ingest_keys.pack(torch.tensor([4]), torch.from_numpy(anchors[:1]),
                             torch.from_numpy(np.concatenate([anchors, anchors[:1]])))
    with pytest.raises(ValueError, match="outside their window"):
        ingest_sort.sort_runs_plain(other, w)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), config=st.sampled_from(sorted(CONFIGS)),
       scans=st.integers(1, 16))
def test_windows_hold_every_reachable_key(seed, config, scans):
    """Points within the outlier mask's reach of origins anywhere within
    2 km, pushed to the reach on an axis or a diagonal: their cell keys, the
    closed-box memberships of those points, and the candidates u + off_g
    (27 neighbours) lie in the statics' windows."""
    mr, ds, bs = CONFIGS[config]
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-2000, 2000, (scans, 3)).astype(np.float32)
    n = 300
    s = rng.integers(0, scans, n)
    d = rng.normal(size=(n, 3))
    d[: n // 3] = np.sign(d[: n // 3]) * (np.abs(d[: n // 3]) == np.abs(d[: n // 3]).max(1,
                                                                                 keepdims=True))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    reach = np.float32(mr + math.sqrt(3.0) * ds)
    t = np.where(rng.random(n) < 0.5, reach, rng.uniform(0, reach, n))
    pts = (origins[s] + d * t[:, None]).astype(np.float32)
    w = _windows(config, scans)
    canchor = torch.from_numpy(device_ingest.anchors(origins, ds))
    banchor = torch.from_numpy(device_ingest.anchors(origins, bs))
    sc = torch.from_numpy(s.astype(np.int32))
    lim = float(np.float32((mr + math.sqrt(3.0) * ds) ** 2))
    keys = ingest_beams.point_keys_plain(torch.from_numpy(pts), sc,
                                         torch.from_numpy(origins), canchor,
                                         inv_leaf=float(np.float32(1 / ds)), lim=lim)
    assert not ingest_sort.pack_plain(keys, w["cell"])[1].any()
    mkey = ingest_members.memberships_plain(torch.from_numpy(pts), sc,
                                            torch.ones(n, dtype=torch.bool), banchor,
                                            block_size=bs)
    assert not ingest_sort.pack_plain(mkey, w["block"])[1].any()
    off = torch.from_numpy(ingest_keys.pack_offsets(geo.full_neighbor_offsets()))
    valid = mkey[mkey != ingest_keys.SENT]
    cand = (valid[:, None] + off[None, :]).reshape(-1)
    assert not ingest_sort.pack_plain(cand, w["candidate"])[1].any()


def _numpy_runs(keys: np.ndarray):
    """(perm, ukey, starts, counts) of the valid keys by numpy."""
    perm = np.argsort(keys, kind="stable")
    skey = keys[perm]
    valid = skey != ingest_keys.SENT
    perm, skey = perm[valid], skey[valid]
    ukey, starts, counts = np.unique(skey, return_index=True, return_counts=True)
    return perm, ukey, starts, counts


@pytest.mark.parametrize("case", ["ties", "all_sentinel", "empty", "one_long_run", "one_key"])
def test_plain_sort_equals_a_stable_argsort_and_run_cut(case):
    rng = np.random.default_rng(7)
    w = _windows("demo", 16)["cell"]
    anchors = _anchors(rng, 16)
    if case == "ties":          # 20,000 keys over about 300 distinct, a fifth invalid
        pool = _keys_at_edges(rng, w, 300, anchors).numpy()
        keys = pool[rng.integers(0, 300, 20_000)]
        keys[rng.random(20_000) < 0.2] = ingest_keys.SENT
    elif case == "all_sentinel":
        keys = np.full(5000, ingest_keys.SENT, np.int64)
    elif case == "empty":
        keys = np.zeros(0, np.int64)
    elif case == "one_long_run":  # a 5,000-member run among 2,000 other keys
        other = _keys_at_edges(rng, w, 2000, anchors).numpy()
        keys = np.concatenate([other, np.full(5000, other[7])])
        keys = keys[rng.permutation(len(keys))]
    else:
        keys = _keys_at_edges(rng, w, 1, anchors).numpy()
    runs = ingest_sort.sort_runs_plain(torch.from_numpy(keys), w, want_rid=True)
    perm, ukey, starts, counts = _numpy_runs(keys)
    np.testing.assert_array_equal(runs.perm.numpy(), perm)
    np.testing.assert_array_equal(runs.ukey.numpy(), ukey)
    np.testing.assert_array_equal(runs.starts.numpy(), starts)
    np.testing.assert_array_equal(runs.counts.numpy(), counts)
    np.testing.assert_array_equal(runs.rid.numpy(), np.repeat(np.arange(len(ukey)), counts))
    assert runs.perm.dtype == runs.ukey.dtype == runs.starts.dtype == torch.int64
    if case == "one_long_run":
        assert int(runs.counts.max()) >= 5000
    # the sort through the public wrapper on the CPU is the plain version
    again = ingest_sort.sort_runs(torch.from_numpy(keys), w)
    assert torch.equal(again.perm, runs.perm) and again.rid is None


@pytest.mark.parametrize("where", ["none", "all", "middle"])
def test_plain_sort_with_a_count_reads_only_the_first_keys(where):
    """A sort with a count (K7c's compact keys, whose count stays on the
    card): the first ``count`` keys sorted as if they were all, whatever the
    rest holds (valid keys of the window here)."""
    rng = np.random.default_rng(9)
    w = _windows("demo", 4)["block"]
    anchors = _anchors(rng, 4)
    keys = _keys_at_edges(rng, w, 3000, anchors)
    M = {"none": 0, "all": 3000, "middle": 1777}[where]
    runs = ingest_sort.sort_runs_plain(keys, w, want_rid=True,
                                       count=torch.tensor([M], dtype=torch.int32))
    ref = ingest_sort.sort_runs_plain(keys[:M].clone(), w, want_rid=True)
    assert all(torch.equal(x, y) for x, y in zip(runs, ref))
    assert runs.perm.shape[0] == M and (M == 0 or int(runs.perm.max()) < M)


def _parent_bucket(mkey, mrow, ent, lab, block_anchor, off_keys, block_size):
    """The parent's ``device_ingest._bucket`` (torch.sort over the keys and a
    sentinel, unique_consecutive, torch.unique of the candidates,
    searchsorted; rows past the valid memberships padding)."""
    SENT = ingest_keys.SENT
    sent = torch.full((1,), SENT, dtype=torch.int64)
    skey, perm = torch.sort(torch.cat([mkey, sent]), stable=True)
    ukey, counts = torch.unique_consecutive(skey, return_counts=True)
    ukey, ucount = ukey[:-1], counts[:-1]
    ustart = torch.cumsum(ucount, 0) - ucount
    U = ukey.shape[0]
    eidx = torch.cat([mrow, mrow.new_zeros(1)])[perm]
    ent_s, lab_s = ent[eidx], lab[eidx]
    valid = skey != SENT
    ctr = ingest_keys.unpack(torch.where(valid, skey, 0), block_anchor).to(torch.float32) \
        * float(np.float32(block_size))
    ent_rel = torch.where(valid[:, None], ent_s - ctr.repeat(1, ent.shape[1] // 3), 0.0)
    tkey = torch.unique((ukey[:, None] + off_keys[None, :]).reshape(-1))
    nb_row = torch.searchsorted(tkey, ukey[:, None] - off_keys[None, :])
    want = tkey[:, None] + off_keys[None, :]
    pos = torch.searchsorted(ukey, want)
    found = ukey[torch.clamp_max(pos, U - 1)] == want
    tb_u = torch.where(found, pos, U)
    return {"ent": ent_s, "ent_rel": ent_rel, "lab": lab_s, "ukey": ukey, "ustart": ustart,
            "ucount": ucount, "tkey": tkey, "nb_row": nb_row, "tb_u": tb_u}


@pytest.mark.parametrize("plain", ["runs", "search"])
@pytest.mark.parametrize("G", [7, 27])
@pytest.mark.parametrize("segments", [False, True])
def test_plain_bucket_tail_equals_the_parents(G, segments, plain, monkeypatch):
    """On a real dispatch's membership keys (3 scans of ``ingest_scene``),
    K7s + K7t give the parent's tables: every table bit for bit, the entry
    columns on the valid rows (the parent padded them to its keys and a
    sentinel; the point family's compact keys are the valid memberships
    alone, BGKL's hits keep 8 slots a hit).  K7t's tail runs through each
    plain version (``runs``: the slot maps read off the candidate sort's
    runs, the kernel's; ``search``: torch.searchsorted), and the other gives
    the same on the same call."""
    pts, scan, origins, ca, ba = ingest_scene(50)
    mr, ds, fr, bs = INGEST["mr"], INGEST["ds"], INGEST["fr"], INGEST["block_size"]
    offsets = geo.FACE_NEIGHBOR_OFFSETS if G == 7 else geo.full_neighbor_offsets()
    off = torch.from_numpy(ingest_keys.pack_offsets(offsets))
    seen = {}

    def spy(mkey, mrow, ent, lab, block_anchor, off_keys, block_size, window, **kw):
        seen["args"] = (mkey, mrow, ent, lab, block_anchor, off_keys, block_size)
        return orig(mkey, mrow, ent, lab, block_anchor, off_keys, block_size, window, **kw)

    def tail(*a, **k):
        seen["tail"] = (a, k)
        return fns[plain](*a, **k)

    orig = device_ingest._bucket
    fns = {"runs": ingest_bucket.bucket_runs_plain, "search": ingest_bucket.bucket_plain}
    monkeypatch.setattr(device_ingest, "_bucket", spy)
    monkeypatch.setattr(ingest_bucket, "bucket", tail)
    kf = device_ingest.beam_slots(ds, fr, mr, bs)
    fn = device_ingest.ingest_batch_bgkl if segments else device_ingest.ingest_batch
    kw = {} if segments else {"free_label": 0.0}
    tabs = fn(pts, scan, origins, ca, ba, off, ds=ds, fr=fr, mr=mr, kf=kf, block_size=bs, **kw)
    ref = _parent_bucket(*seen["args"])
    M = int(tabs["ucount"].sum())
    assert tabs["ent"].shape[0] == M < ref["ent"].shape[0]
    if not segments:
        assert seen["args"][0].shape[0] == M     # the compact keys: no sentinel
    assert tabs["ent"].shape[1] == (6 if segments else 3)
    for k in ("ukey", "ustart", "ucount", "tkey", "nb_row", "tb_u"):
        assert torch.equal(tabs[k], ref[k]), k
    for k in ("ent", "ent_rel", "lab"):
        assert torch.equal(tabs[k], ref[k][:M]), k
    assert int(tabs["ucount"].max()) > 10 and (tabs["tb_u"] == len(tabs["ukey"])).any()
    a, k = seen["tail"]
    other = fns["search" if plain == "runs" else "runs"](*a, **k)
    names = ("ent", "ent_rel", "lab", "nb_row", "tb_u")
    assert all(torch.equal(tabs[n], x) for n, x in zip(names, other))


def test_plain_bucket_rows_follow_the_sort_index():
    """K7t's plain version row by row: entry e = mrow[perm[i]] (int64 rows,
    and K7c's int32 ones alike), its block's centre from ukey[rid[i]]."""
    rng = np.random.default_rng(3)
    w = _windows("demo", 2)["block"]
    anchors = _anchors(rng, 2)
    mkey = _keys_at_edges(rng, w, 64, anchors)
    mrow = torch.arange(64) // 8
    ent = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))
    lab = torch.from_numpy(rng.random(8).astype(np.float32))
    runs = ingest_sort.sort_runs_plain(mkey, w, want_rid=True)
    off = torch.from_numpy(ingest_keys.pack_offsets(geo.FACE_NEIGHBOR_OFFSETS))
    cand = ingest_sort.sort_runs_plain((runs.ukey[:, None] + off).reshape(-1), w.wider(1))
    tail = (runs.ukey, cand.ukey, cand.perm, cand.starts, cand.counts, off,
            torch.from_numpy(anchors))
    ent_s, ent_rel, lab_s, nb_row, tb_u = ingest_bucket.bucket(
        runs.perm, runs.rid, mrow, ent, lab, *tail, block_size=0.4)
    assert all(torch.equal(x, y) for x, y in zip(
        (ent_s, ent_rel, lab_s, nb_row, tb_u),
        ingest_bucket.bucket(runs.perm, runs.rid, mrow.to(torch.int32), ent, lab, *tail,
                             block_size=0.4)))
    for i in range(64):
        e = int(mrow[runs.perm[i]])
        c = ingest_keys.unpack(runs.ukey[runs.rid[i].long()][None], torch.from_numpy(anchors))
        ctr = c.to(torch.float32)[0] * np.float32(0.4)
        assert torch.equal(ent_s[i], ent[e]) and lab_s[i] == lab[e]
        assert torch.equal(ent_rel[i], ent[e] - ctr.repeat(2))
    assert torch.equal(cand.ukey[nb_row], runs.ukey[:, None] - off[None, :])

@pytest.mark.parametrize("G", [7, 27])
def test_mirror_slots_pair_the_offsets(G):
    """The mirror of each neighbour slot: off[mirror[g]] = −off[g]; the face
    offsets pair 2k − 1 with 2k, the 27-cell ones i with 27 − i (self first
    in both), from the offsets and from their key deltas alike."""
    offsets = geo.FACE_NEIGHBOR_OFFSETS if G == 7 else geo.full_neighbor_offsets()
    want = [0] + ([g + 1 if g % 2 else g - 1 for g in range(1, 7)] if G == 7
                  else [27 - g for g in range(1, 27)])
    for o in (offsets, ingest_keys.pack_offsets(offsets)):
        m = ingest_bucket.mirror_slots(o)
        assert m.dtype == np.int32 and m.tolist() == want
        assert np.array_equal(np.asarray(o)[m], -np.asarray(o))


@pytest.mark.parametrize("case", ["a face left out", "one offset moved"])
def test_bucket_raises_on_offsets_that_are_not_symmetric(case):
    """Slot maps read off the candidate runs need each offset's negative
    among the offsets: K7t's wrapper (its plain version here) and
    :func:`mirror_slots` raise where one has none."""
    offsets = geo.FACE_NEIGHBOR_OFFSETS.copy()
    if case == "a face left out":
        offsets = offsets[:6]
    else:
        offsets[3] = [1, 1, 0]
    off = torch.from_numpy(ingest_keys.pack_offsets(offsets))
    with pytest.raises(ValueError, match="not symmetric"):
        ingest_bucket.mirror_slots(off)
    rng = np.random.default_rng(4)
    w = _windows("demo", 1)["block"]
    anchors = _anchors(rng, 1)
    runs = ingest_sort.sort_runs_plain(_keys_at_edges(rng, w, 16, anchors), w, want_rid=True)
    cand = ingest_sort.sort_runs_plain((runs.ukey[:, None] + off).reshape(-1), w.wider(1))
    ent, lab = torch.zeros((16, 3)), torch.zeros(16)
    with pytest.raises(ValueError, match="not symmetric"):
        ingest_bucket.bucket(runs.perm, runs.rid, torch.arange(16, dtype=torch.int32), ent,
                             lab, runs.ukey, cand.ukey, cand.perm, cand.starts, cand.counts,
                             off, torch.from_numpy(anchors), block_size=0.4)


@pytest.mark.parametrize("D", [3, 6])
@pytest.mark.parametrize("G", [7, 27])
def test_plain_slot_maps_read_off_the_runs_equal_the_searched(G, D):
    """On ``bucket_inputs`` (a full 3×3×3 cube of blocks, so a test block
    fed at all G slots, and 300 blocks at random), the slot maps read off
    the candidate runs equal the searchsorted ones, and every one of their
    (u, g) and (t, g) is the key relation: tkey[nb_row[u, g]] = ukey[u] −
    off[g], ukey[tb_u[t, g]] = tkey[t] + off[g] where it is not U."""
    a, kw = bucket_inputs(80 + G + D, G=G, D=D)
    runs = ingest_bucket.bucket_runs_plain(*a, **kw)
    search = ingest_bucket.bucket_plain(*a, **kw)
    assert all(torch.equal(x, y) for x, y in zip(runs, search))
    ukey, tkey, off = a[5], a[6], a[10]
    nb_row, tb_u = runs[3], runs[4]
    U = ukey.shape[0]
    assert torch.equal(tkey[nb_row], ukey[:, None] - off[None, :])
    fed = tb_u < U
    assert torch.equal(ukey[tb_u[fed]], (tkey[:, None] + off[None, :])[fed])
    assert bool(fed.all(1).any()) and bool((~fed).any())
