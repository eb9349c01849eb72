"""K7w, the test blocks' slot resolution on the map's device, on the CPU.

A map on device ingest resolves its test blocks' pool slots through K7w's
plain versions (``kernels/ingest_slots.py``) and one K7s sort of world keys;
``DeviceIngestMixin._host_slots`` keeps the host resolution (every
test-block key copied back, ``np.unique``, ``BlockPool.ensure``,
``block_center``) for the dispatches that the world window cannot hold,
counted in the profiler counter ``slot_dispatches_host``.  The
maps here run both on the same scans, dispatch for dispatch, and must hand
the engine the same slots, per-scan starts and counts and GP centres, and
leave the same ``pool.coords`` (a sharded pool: the same placement).  The
scenes are box rooms round origins that move from one insert to the next,
so that a dispatch finds every block new, none new, or some.  No JAX here.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from la3dm_tpu_torch.geometry import blocks as geo, device_ingest
from la3dm_tpu_torch.kernels import ingest_keys, ingest_slots, ingest_sort
from la3dm_tpu_torch.models import bgk, bgkl, gp
from la3dm_tpu_torch.parallel import mesh as pm, sharded_map as sm
from la3dm_tpu_torch.utils import profiling
from la3dm_tpu_torch.utils.config import MapConfig

from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

MAX_RANGE = 6.0
CFG = dict(resolution=0.1, block_depth=3, sf2=1.0, ell=0.2, free_resolution=0.5,
           ds_resolution=0.1, free_thresh=0.3, occupied_thresh=0.7, var_thresh=100.0,
           prior_A=0.001, prior_B=0.001, max_range=MAX_RANGE, device_ingest="on")
CLASSES = {"bgk": (bgk.BGKOctoMap, sm.ShardedBGKOctoMap),
           "bgkl": (bgkl.BGKLOctoMap, sm.ShardedBGKLOctoMap),
           "gp": (gp.GPOctoMap, sm.ShardedGPOctoMap)}


def _cfg(method):
    return MapConfig(method=method, **CFG)


def room_scans(seed, origins, n=150):
    """A box room's walls (4 m in x, 3 m back) round each origin, 1 cm noise."""
    rng = np.random.default_rng(seed)
    out = []
    for o in origins:
        o = np.asarray(o, np.float32)
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        t = np.min(np.abs(np.where(d > 0, 4.0, -3.0) / np.where(d == 0, 1e-9, d)), axis=1)
        out.append(((o + d * (t + rng.normal(0, 0.01, n))[:, None]).astype(np.float32), o))
    return out


#: three inserts of 3 scans: every block new, the same scans again (none
#: new), then origins moved 2 m (some new)
def _inserts(seed):
    a = room_scans(seed, [(0.1, -0.2 + 0.3 * i, 0.3) for i in range(3)])
    b = room_scans(seed + 1, [(2.1, 0.5 + 0.3 * i, 0.3) for i in range(3)])
    return [a, a, b]


def _host(x):
    return None if x is None else (x.numpy() if torch.is_tensor(x) else np.asarray(x)).copy()


def _recorded(m, host: bool):
    """Wrap the map's engine hook to log what each dispatch hands it (and,
    with ``host``, resolve every dispatch on the host)."""
    log = []
    hook = m._dispatch_ingest_chunk

    def rec(tabs, ucount, slots, centers, ss, sc):
        log.append({"slots": _host(slots), "slots_on_host": not torch.is_tensor(slots),
                    "centers": _host(centers), "ss": list(ss),
                    "sc": list(sc), "n_blocks": m.pool.n_blocks,
                    "coords": m.pool.coords.copy()})
        return hook(tabs, ucount, slots, centers, ss, sc)

    m._dispatch_ingest_chunk = rec
    if host:
        m._resolve_slots = lambda tabs, banchor, banchor_dev, radius: m._host_slots(
            tabs, banchor)
    return log


def _insert(m, scans):
    m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans], max_range=MAX_RANGE)


def _counted(fn) -> dict:
    """The profiler counters that ``fn()`` adds (``utils/profiling.py``
    counts while a profiler session records)."""
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset()
        fn()
        return profiling.snapshot()["counts"]


def _insert_counted(maps, scans, counts):
    """Insert ``scans`` into each map, adding its counters to ``counts``."""
    for m, n in zip(maps, counts):
        n.update(_counted(lambda m=m: _insert(m, scans)))


def assert_same_dispatches(card, host, centres: bool):
    assert len(card) == len(host) > 0
    for i, (c, h) in enumerate(zip(card, host)):
        assert c["slots"].dtype == h["slots"].dtype == np.int32, i
        np.testing.assert_array_equal(c["slots"], h["slots"], err_msg=f"dispatch {i}")
        assert (c["ss"], c["sc"], c["n_blocks"]) == (h["ss"], h["sc"], h["n_blocks"]), i
        np.testing.assert_array_equal(c["coords"], h["coords"], err_msg=f"dispatch {i}")
        if centres:
            assert c["centers"].dtype == np.float32
            np.testing.assert_array_equal(c["centers"], h["centers"], err_msg=f"dispatch {i}")
        else:
            assert c["centers"] is None and h["centers"] is None


def assert_same_pool(a, b):
    assert a.pool.n_blocks == b.pool.n_blocks and a.pool.capacity == b.pool.capacity
    np.testing.assert_array_equal(a.pool.coords, b.pool.coords)
    for k in a.pool.fields:
        assert torch.equal(a.pool.fields[k], b.pool.fields[k]), k
    assert torch.equal(a.pool.touched, b.pool.touched)
    assert torch.equal(a.pool.eff_level, b.pool.eff_level)


# ------------------------------------------------------------ the maps

@pytest.mark.parametrize("method", ["bgk", "bgkl", "gp"])
def test_card_resolution_equals_the_host_resolution(method):
    """All new, none new, some new: the same slots, scan runs, centres and
    pool, every dispatch resolved by the plain K7w, none on the host."""
    cls = CLASSES[method][0]
    card, host = cls(_cfg(method), device="cpu"), cls(_cfg(method), device="cpu")
    logs = _recorded(card, host=False), _recorded(host, host=True)
    counts = Counter(), Counter()
    for scans in _inserts(11):
        _insert_counted((card, host), scans, counts)
    assert_same_dispatches(*logs, centres=method == "gp")
    assert_same_pool(card, host)
    assert counts[0]["slot_dispatches_card"] == 3 and counts[0]["slot_dispatches_host"] == 0
    assert counts[1]["slot_dispatches_host"] == 3
    assert not any(r["slots_on_host"] for r in logs[0])
    # the three kinds of dispatch
    log = logs[0]
    d = [len(np.unique(r["slots"])) for r in log]
    assert log[0]["n_blocks"] == d[0]                               # every block new
    assert log[1]["n_blocks"] == log[0]["n_blocks"]                 # none new
    new = log[2]["n_blocks"] - log[1]["n_blocks"]
    assert 0 < new < d[2]                                           # some new
    for r in log:
        assert sum(r["sc"]) == len(r["slots"]) and r["ss"][0] == 0


@pytest.mark.parametrize("method", ["bgk", "gp"])
def test_sharded_pool_places_as_the_host_resolution(method):
    """A sharded pool from capacity 16 (growth and its relayout inside the
    first dispatch): the same placement, loads, slots and pool; the engine
    gets the slots as a host array (built from the resolution's one copy),
    GP's centres on the map's device."""
    cls = CLASSES[method][1]

    def make():
        return cls(_cfg(method), mesh=pm.block_mesh(4, "cpu"), capacity=16)

    card, host = make(), make()
    logs = _recorded(card, host=False), _recorded(host, host=True)
    counts = Counter(), Counter()
    for scans in _inserts(12):
        _insert_counted((card, host), scans, counts)
    assert card.pool.generation == host.pool.generation >= 1
    assert_same_dispatches(*logs, centres=method == "gp")
    assert_same_pool(card, host)
    np.testing.assert_array_equal(card.pool.dev_load, host.pool.dev_load)
    np.testing.assert_array_equal(card.pool._dev_count, host.pool._dev_count)
    assert card.pool._order == host.pool._order
    assert counts[0]["slot_dispatches_card"] == 3 and counts[0]["slot_dispatches_host"] == 0
    assert all(r["slots_on_host"] for r in logs[0])


def test_anchors_beyond_the_window_fall_back_and_are_counted():
    """Two scans 27 km apart in one dispatch: their anchors spread past the
    widest world window (32767 blocks round the middle), so the host
    resolves that dispatch; the scans one a dispatch resolve on the card."""
    far = room_scans(13, [(0.1, -0.2, 0.3), (27000.1, -0.2, 0.3)])
    bs = _cfg("bgk").block_size
    radius = ingest_sort.block_window(MAX_RANGE, 0.1, bs, 2).wider(1).radius
    anchors = device_ingest.anchors(np.stack([o for _, o in far]), bs)
    assert ingest_slots.world_window(radius, anchors) is None
    assert ingest_slots.world_window(radius, anchors[:1]) is not None
    card, host = bgk.BGKOctoMap(_cfg("bgk"), device="cpu"), bgk.BGKOctoMap(_cfg("bgk"),
                                                                          device="cpu")
    logs = _recorded(card, host=False), _recorded(host, host=True)
    counts = Counter(), Counter()
    _insert_counted((card, host), far, counts)
    assert counts[0]["slot_dispatches_host"] == 1 and counts[0]["slot_dispatches_card"] == 0
    for scan in far:
        _insert_counted((card, host), [scan], counts)
    assert counts[0]["slot_dispatches_host"] == 1                   # the last two on the card
    assert counts[0]["slot_dispatches_card"] == 2
    assert_same_dispatches(*logs, centres=False)
    assert_same_pool(card, host)


def test_a_flagged_sort_falls_back_and_is_counted(monkeypatch):
    """A window too narrow for the dispatch's keys: the sort's flag sends the
    dispatch to the host resolution (counted), never to the engine with
    wrong slots."""
    real = ingest_slots.world_window
    monkeypatch.setattr(ingest_slots, "world_window",
                        lambda radius, anchors: real(radius // 4, anchors))
    scans = _inserts(14)[0]
    card, host = gp.GPOctoMap(_cfg("gp"), device="cpu"), gp.GPOctoMap(_cfg("gp"), device="cpu")
    logs = _recorded(card, host=False), _recorded(host, host=True)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset()
        for m in (card, host):
            _insert(m, scans)
        counts = profiling.snapshot()["counts"]
    assert counts["slot_dispatches_host"] == 2 and "slot_dispatches_card" not in counts
    assert_same_dispatches(*logs, centres=True)
    assert_same_pool(card, host)


def test_counters_say_how_often_the_card_resolves():
    """``slot_dispatches_card`` a dispatch, ``slot_blocks`` its distinct
    blocks and ``slot_tests`` its test blocks, while a profiler records."""
    m = bgkl.BGKLOctoMap(_cfg("bgkl"), device="cpu")
    log = _recorded(m, host=False)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.reset()
        for scans in _inserts(15):
            _insert(m, scans)
        counts = profiling.snapshot()["counts"]
    assert counts["slot_dispatches_card"] == counts["dispatches"] == 3
    assert counts["slot_tests"] == sum(len(r["slots"]) for r in log)
    assert counts["slot_blocks"] == sum(len(np.unique(r["slots"])) for r in log)
    assert counts["slot_blocks"] < counts["slot_tests"]
    assert "slot_dispatches_host" not in counts


# ------------------------------------------------------------ the plain twins

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_world_keys_sort_as_pack_key_and_count_each_scan(seed):
    """World keys order test blocks as ``geo.pack_key`` does, decode to their
    coordinates, and the counts are each scan's run of the sorted keys."""
    rng = np.random.default_rng(seed)
    K = 5
    anchors = rng.integers(-40, 40, (K, 3)).astype(np.int32)
    scan = np.sort(rng.integers(0, K, 400))
    scan[scan == 2] = 3                                             # a scan with none
    coords = anchors[scan] + rng.integers(-12, 13, (400, 3))
    tkey = torch.unique(ingest_keys.pack(torch.from_numpy(scan), torch.from_numpy(coords),
                                         torch.from_numpy(anchors)))
    tscan, tcoords = ingest_keys.unpack_np(tkey.numpy(), anchors)
    window, base = ingest_slots.world_window(12, anchors)
    wkey, count = ingest_slots.world_keys(tkey, torch.from_numpy(anchors), base, K)
    np.testing.assert_array_equal(count.numpy(), np.bincount(tscan, minlength=K))
    np.testing.assert_array_equal(ingest_slots.unpack_world_np(wkey.numpy(), base), tcoords)
    assert not ingest_sort.pack_plain(wkey, window)[1].any()
    np.testing.assert_array_equal(np.argsort(wkey.numpy(), kind="stable"),
                                  np.argsort(geo.pack_key(tcoords), kind="stable"))
    perm, ukey, rid, status = ingest_slots.sort_world(wkey, window)
    uniq, inv = np.unique(geo.pack_key(tcoords), return_inverse=True)
    V, D, flag, _ = status.tolist()
    assert (V, D, flag) == (len(tkey), len(uniq), 0)
    np.testing.assert_array_equal(geo.pack_key(ingest_slots.unpack_world_np(ukey[:D].numpy(),
                                                                            base)), uniq)
    uslots = torch.from_numpy(rng.permutation(D).astype(np.int32))
    slots, ctr = ingest_slots.gather(perm, rid, uslots, ukey, base, block_size=0.4)
    np.testing.assert_array_equal(slots.numpy(), uslots.numpy()[inv.reshape(-1)])
    np.testing.assert_array_equal(ctr.numpy(), geo.block_center(tcoords, 0.4))


def test_world_window_and_the_fields_at_its_edge():
    """The window is the radius widened by the anchors' spread round their
    box's middle; a key past 16 bits is the sentinel, a key past the window
    sets the sort's flag."""
    anchors = np.array([[0, 0, 0], [10, -4, 3]], np.int32)
    window, base = ingest_slots.world_window(20, anchors)
    assert base.tolist() == [5, -2, 1] and window.radius == 25 and window.scans == 1
    assert ingest_slots.world_window(ingest_slots.MAX_RADIUS - 4, anchors) is None
    assert ingest_slots.world_window(ingest_slots.MAX_RADIUS - 5, anchors) is not None
    assert ingest_slots.world_window(ingest_slots.MAX_RADIUS, anchors[:1]) is not None
    a = torch.from_numpy(anchors)
    tkey = ingest_keys.pack(torch.tensor([0, 0, 1]), torch.tensor(
        [[0, 0, 0], [0, 0, 30], [10, -4, 3]]), a)
    wkey, count = ingest_slots.world_keys(tkey, a, base, 2)
    assert count.tolist() == [2, 1]
    status = ingest_slots.sort_world(wkey, window)[3]
    assert status.tolist()[2] == 1                                  # z = 30 > 1 + 25
    far = np.array([0, 0, -40000])
    wkey, _ = ingest_slots.world_keys(tkey, a, far, 2)
    assert (wkey == ingest_keys.SENT).all()                          # z − base > 65535 − 32768
