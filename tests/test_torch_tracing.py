"""The port's spans and counters (``la3dm_tpu_torch/utils/profiling.py``) on
the CPU: the recorder's rules, the spans a traced device-ingest insert
records (``device_ingest: on`` through the kernels' plain versions), the
benchmark's gap labels by those spans and its readers of them.

The sync spans (``la3dm.sync.*``) sit where the host waits for a CUDA stream,
so the CPU paths record none; tests/test_torch_cuda.py counts them on a card.
"""

import gc
import os
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import run
from la3dm_tpu_torch.parallel import mesh as pm, sharded_map as sm
from la3dm_tpu_torch.pipeline import build_map
from la3dm_tpu_torch.utils import profiling
from la3dm_tpu_torch.utils.config import MapConfig

from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

CONFIGS = {
    "bgkl": MapConfig(method="bgkl", resolution=0.1, block_depth=3, sf2=0.1, ell=0.2,
                      free_resolution=0.3, ds_resolution=0.1, free_thresh=0.3,
                      occupied_thresh=0.7, var_thresh=0.15, prior_A=0.001, prior_B=0.001,
                      max_range=8.0, device_ingest="on"),
    "gp": MapConfig(method="gp", resolution=0.1, block_depth=3, sf2=1.0, ell=1.0,
                    free_resolution=0.5, ds_resolution=0.1, free_thresh=0.3,
                    occupied_thresh=0.7, noise=0.01, l=100.0, min_var=0.001,
                    max_var=1000.0, max_known_var=0.02, max_range=8.0, device_ingest="on"),
}
#: the spans a CPU device-ingest insert reaches
CPU_SPANS = ("la3dm.map.build", "la3dm.map.insert", "la3dm.pool.ensure",
             "la3dm.ingest.prepare", "la3dm.ingest.slots", "la3dm.ingest.tables",
             "la3dm.heavy.launch", "la3dm.light.launch")
#: scans a sequence, and scans a dispatch (two dispatches)
N_SCANS, BATCH = 4, 2
METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "benchmark", "metrics")


def wall_scans(seed, k=N_SCANS, n=120):
    """``k`` scans of a wall of hits 2 m in front of a moving origin."""
    rng = np.random.default_rng(seed)
    clouds, origins = [], []
    for i in range(k):
        y, z = rng.uniform(-2.0, 2.0, n), rng.uniform(0.0, 2.0, n)
        x = 2.0 + 0.05 * rng.standard_normal(n)
        clouds.append(np.stack([x, y, z], -1).astype(np.float32))
        origins.append(np.array([0.1, -0.2 + 0.3 * i, 0.3], np.float32))
    return clouds, origins


def traced_insert(m_factory, clouds, origins):
    """A map built and fed ``clouds`` in dispatches of BATCH scans under a
    CPU profiler session: (the map, the session, the recorder's snapshot).
    The garbage collector waits meanwhile: a collection that starts between
    a span's clock and the profiler's would hold one of them alone."""
    profiling.reset()
    gc.collect()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("bench.window"):
                m = m_factory()
                m.SCAN_BATCH = BATCH
                m.insert_pointclouds(clouds, origins, max_range=6.0)
                m.synchronize()
    finally:
        gc.enable()
    return m, prof, profiling.snapshot()


def traced_family(method):
    """:func:`traced_insert` of a ``method`` map on the CPU, with each span's
    event durations in the session (seconds)."""
    clouds, origins = wall_scans(3)
    m, prof, snap = traced_insert(lambda: build_map(CONFIGS[method], device="cpu"),
                                  clouds, origins)
    durations = {}
    for e in prof.events():
        if e.name.startswith("la3dm."):
            durations.setdefault(e.name, []).append(
                (e.time_range.end - e.time_range.start) * 1e-6)
    return {"map": m, "prof": prof, "snap": snap, "durations": durations}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def traced(request):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield traced_family(request.param)
    finally:
        torch.set_num_threads(n)


# ------------------------------------------------------------ the recorder

def test_span_off_opens_no_profiler_range_and_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} opened with no session")

    profiling.reset()
    before = profiling.snapshot()
    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    assert not profiling._recording()
    with profiling.span("la3dm.map.insert"):
        with profiling.span("la3dm.pool.ensure"):
            profiling.count("scans", 3)
    profiling.traced("la3dm.map.build")(lambda: None)()
    assert profiling.snapshot() == before == {"spans": {}, "counts": {}}


def test_self_time_nesting_and_threads():
    """Self time is the duration less the child spans'; a span inside one of
    its own name is counted once; another thread's spans are no children."""
    profiling.reset()
    out = {}

    def worker():
        with profiling.span("la3dm.test.worker"):
            time.sleep(0.03)

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("la3dm.test.outer"):
            t = threading.Thread(target=worker)
            t.start()
            with profiling.span("la3dm.test.inner"):
                with profiling.span("la3dm.test.inner"):
                    time.sleep(0.01)
            t.join(timeout=30)
            profiling.count("dispatches")
        out = profiling.snapshot()
    assert not t.is_alive()
    spans = out["spans"]
    assert {k: v["calls"] for k, v in spans.items()} == {
        "la3dm.test.outer": 1, "la3dm.test.inner": 1, "la3dm.test.worker": 1}
    outer, inner = spans["la3dm.test.outer"], spans["la3dm.test.inner"]
    assert inner["s"] == inner["self_s"] >= 0.01
    assert outer["self_s"] == pytest.approx(outer["s"] - inner["s"], abs=1e-9)
    assert outer["s"] >= 0.03 and spans["la3dm.test.worker"]["self_s"] >= 0.03
    assert out["counts"] == {"dispatches": 1}
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counts": {}}


# ---------------------------------------------------- a traced device insert

def test_every_cpu_span_is_on_the_profilers_timeline(traced):
    for name in CPU_SPANS:
        assert name in traced["durations"], name
        assert traced["snap"]["spans"][name]["calls"] == len(traced["durations"][name])
    assert not any(k.startswith("la3dm.sync.") for k in traced["durations"])
    counts = dict(traced["snap"]["counts"])
    blocks, tests = counts.pop("slot_blocks"), counts.pop("slot_tests")
    gp = {k: counts.pop(k) for k in ("gp_models", "gp_model_points", "gp_overflow_models",
                                     "gp_tier_launches") if k in counts}
    if traced["map"].cfg.method == "gp":
        assert gp["gp_tier_launches"] == traced["map"].stats["heavy_tiers"]
        assert 0 < gp["gp_models"] <= gp["gp_model_points"]
        assert gp["gp_overflow_models"] == 0      # walls of 120 points a scan
    else:
        assert gp == {}
    dispatches = -(-N_SCANS // BATCH)
    assert counts == {"scans": N_SCANS, "dispatches": dispatches,
                      "slot_dispatches_card": dispatches}
    assert 0 < blocks < tests
    assert traced["map"].stats["scans"] == N_SCANS


def test_span_totals_agree_with_the_profilers_events(traced):
    for name, v in traced["snap"]["spans"].items():
        events = sum(traced["durations"][name])
        assert v["s"] == pytest.approx(events, rel=0.05), name


def test_child_self_times_fit_in_their_parents(traced):
    spans = traced["snap"]["spans"]
    for v in spans.values():
        assert 0.0 <= v["self_s"] <= v["s"]
    insert = spans["la3dm.map.insert"]
    inside = sum(v["self_s"] for k, v in spans.items()
                 if k not in ("la3dm.map.insert", "la3dm.map.build"))
    assert inside <= insert["s"]
    assert inside + insert["self_s"] == pytest.approx(insert["s"], rel=1e-9)
    slots = spans["la3dm.ingest.slots"]
    assert spans["la3dm.pool.ensure"]["s"] <= slots["s"] - slots["self_s"] + 1e-9
    heavy = spans["la3dm.heavy.launch"]
    assert spans["la3dm.light.launch"]["s"] <= heavy["s"] - heavy["self_s"] + 1e-9


def test_sharded_map_spans_count_once():
    """A sharded map calls its family's methods once a shard inside its own
    spans of the same names: each is counted once a call of the outer one."""
    clouds, origins = wall_scans(4)
    cfg = CONFIGS["bgkl"]
    _, _, snap = traced_insert(
        lambda: sm.ShardedBGKLOctoMap(cfg, mesh=pm.block_mesh(2, "cpu"), capacity=64),
        clouds, origins)
    calls = {k: v["calls"] for k, v in snap["spans"].items()}
    dispatches = -(-N_SCANS // BATCH)
    assert calls["la3dm.map.build"] == calls["la3dm.map.insert"] == 1
    assert calls["la3dm.heavy.launch"] == dispatches
    assert calls["la3dm.pool.ensure"] == dispatches
    assert calls["la3dm.light.launch"] >= N_SCANS     # once a (scan, shard)


# ------------------------------------------------------------ the benchmark

def test_read_trace_names_a_gap_inside_a_span_by_it(traced):
    """An idle gap of the card that opens with ``la3dm.ingest.prepare`` and
    ends before its first operation is labelled by the span."""
    evs = list(traced["prof"].events())
    cpu = [e for e in evs if e.device_type == DeviceType.CPU]
    window = next(e.time_range for e in cpu if e.name == "bench.window")
    prep = next(e.time_range for e in cpu if e.name == "la3dm.ingest.prepare")
    first = min((e.time_range.start for e in cpu if e.name != "la3dm.ingest.prepare"
                 and prep.start < e.time_range.start < prep.end), default=prep.end)

    def kernel(a, b):
        return types.SimpleNamespace(name="bgk_aligned_heavy_kernel",
                                     device_type=DeviceType.CUDA,
                                     time_range=types.SimpleNamespace(start=a, end=b))

    trace = types.SimpleNamespace(
        events=lambda: evs + [kernel(window.start, prep.start), kernel(first, window.end)])
    tr = run.read_trace(trace, [["heavy pass", "bgk_aligned_heavy"]])
    assert [g[0] for g in tr["idle_gaps"]] == ["la3dm.ingest.prepare"]
    assert tr["idle_gaps"][0][1] == pytest.approx((first - prep.start) * 1e-6)


SNAPSHOT = {
    "spans": {"la3dm.map.build": {"s": 0.02, "self_s": 0.02, "calls": 2},
              "la3dm.map.insert": {"s": 0.9, "self_s": 0.01, "calls": 2},
              "la3dm.pool.ensure": {"s": 0.05, "self_s": 0.05, "calls": 8},
              "la3dm.ingest.tables": {"s": 0.3, "self_s": 0.18, "calls": 8},
              "la3dm.sync.sort_runs": {"s": 0.1, "self_s": 0.1, "calls": 32},
              "la3dm.sync.fetch_small": {"s": 0.04, "self_s": 0.04, "calls": 8},
              "la3dm.sync.synchronize": {"s": 0.06, "self_s": 0.06, "calls": 2},
              "la3dm.heavy.launch": {"s": 0.2, "self_s": 0.08, "calls": 8},
              "la3dm.light.launch": {"s": 0.12, "self_s": 0.12, "calls": 120}},
    "counts": {"scans": 120, "dispatches": 8, "host_syncs": 42}}
READINGS = {
    "map_host_ms_per_scan.offline": 1e3 * (0.02 + 0.01 + 0.05) / 120,
    "sync_wait_ms_per_scan.offline": 1e3 * (0.1 + 0.04 + 0.06) / 120,
    "host_syncs_per_dispatch.offline": 42 / 8,
    "ingest_launch_host_ms_per_scan.offline": 1e3 * 0.18 / 120,
    "heavy_launch_host_ms_per_scan.offline": 1e3 * 0.08 / 120,
    "light_launch_host_ms_per_scan.offline": 1e3 * 0.12 / 120,
}


def _reader(name):
    return run._module(os.path.join(METRICS, name + ".py"), "test_metric_").read


@pytest.mark.parametrize("name", sorted(READINGS))
def test_span_readers_on_a_snapshot(monkeypatch, name):
    read = _reader(name)
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT)
    assert read({"scans": 1}) == pytest.approx(READINGS[name], rel=1e-12)
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {}, "counts": {}})
    assert read({"scans": 1}) is None
    # a program without the recorder (the benchmark's readers run on older
    # checkouts too) reads nothing and raises nothing
    monkeypatch.delattr(profiling, "snapshot")
    assert read({"scans": 1}) is None
