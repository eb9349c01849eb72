"""GPOctoMap at the server launch's large-map settings on the CPU: the
benchmark cell ``gp_large_vlp16.online`` (``gpoctomap_large_map.yaml``
through ``OnlineIntegrator`` on the city block) at a tiny size against the
plain reference, its check against the TF32 control, the server
pre-downsample's span and GP's dispatch counters.

The map runs ``device_ingest: on`` through the kernels' plain versions; the
tiny scene is 2 rings (±15°) × 600 azimuth steps, 2 scans, dense enough near
the sensor that the 0.5 m pre-downsample merges points.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from benchmark import compare, run
from la3dm_tpu_torch.kernels import gp_heavy
from la3dm_tpu_torch.pipeline import build_map
from la3dm_tpu_torch.utils import profiling
from la3dm_tpu_torch.utils.config import MapConfig

from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "gp_large_vlp16.online"
SENSOR, SCANS = {"rings": 2, "azimuth_steps": 600}, 2


def _reader(name):
    return run._module(os.path.join(ROOT, "benchmark", "metrics", name + ".py"),
                       "test_metric_").read


@pytest.fixture(scope="module")
def tiny():
    """The cell's parts, its tiny load (seed 7) and the reference's map of it."""
    parts = run.load_cell(CELL)
    conf = parts["config"]
    conf = {**conf, "sensor": {**conf["sensor"], **SENSOR},
            "method": {**conf["method"], "device_ingest": "on"}}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        load = parts["generator"].build(conf, parts["traffic"], 7, "cpu", scans=SCANS)
        ref_mod, _ = run.family("gp")
        ref = run.reference(ref_mod, load, conf["method"],
                            max_range=float(conf["dataset"]["max_range"]), device="cpu")
    finally:
        torch.set_num_threads(n)
    return {"parts": parts, "conf": conf, "load": load, "ref_mod": ref_mod, "ref": ref}


def test_the_cell_at_a_tiny_size_is_correct():
    parts = run.load_cell(CELL)
    out = run.run_cell(parts, seed=3, seconds=0.0, trace=False, device="cpu",
                       t_start=0.0, sensor=SENSOR, method={"device_ingest": "on"},
                       scans=SCANS)
    assert out["correct"], out["checks"]
    assert out["checks"]["blocks_apart"]["value"] == 0
    assert out["work"]["models"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"blocks_apart", "gap_q9999", "voxels_apart",
                                  "gap_max_agreeing"}


def test_the_tf32_control_fails_the_cells_limits(tiny):
    """The reference with its heavy pass's coordinates rounded to TF32, in
    the program's place, comes out not correct; solved in float32 (the
    program's own precision) it passes."""
    meth, ref_mod = tiny["conf"]["method"], tiny["ref_mod"]
    limits = tiny["parts"]["check"]["limits"]

    def numbers(**kw):
        other = run.reference(ref_mod, tiny["load"], meth, max_range=30.0, device="cpu", **kw)
        return compare.compare(other, tiny["ref"], lambda v: ref_mod.state(v, meth))
    control = numbers(tf32=True)
    assert not compare.judge(control, limits), control
    witness = numbers(solve=torch.float32)
    assert compare.judge(witness, limits), witness


def test_a_profiled_online_pass_records_the_downsample_span_and_gp_counters(tiny):
    """One pass of the cell's own step under a CPU profiler: a
    ``la3dm.server.downsample`` span a scan, no span around it, and GP's
    counters equal to the map's size tiers and to the models the reference
    fits (the same blocks, the same points)."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        m = tiny["load"]["step"]()
    snap = profiling.snapshot()
    down = snap["spans"]["la3dm.server.downsample"]
    assert down["calls"] == SCANS and down["self_s"] == down["s"] > 0
    counts = snap["counts"]
    assert counts["scans"] == counts["dispatches"] == SCANS
    assert counts["gp_tier_launches"] == m.stats["heavy_tiers"] >= SCANS
    models = np.asarray(tiny["ref"]["work"]["models"])
    assert counts["gp_models"] == models.size > 0
    assert counts["gp_model_points"] == int(models.sum())
    assert counts["gp_overflow_models"] == int((models > gp_heavy.BASE_MAX_C).sum())
    assert m.stats["ingest_host_chunks"] == 0 and int(m.failed_models) == 0
    # the benchmark's readers of the span and the counter
    ms = _reader("server_downsample_host_ms_per_scan.online")({})
    assert ms == pytest.approx(1e3 * down["s"] / SCANS, rel=1e-12)
    tiers = _reader("heavy_tiers_per_dispatch.online")({})
    assert tiers == counts["gp_tier_launches"] / SCANS


def _wall_and_far(seed: int, n: int = 400, far: int = 20):
    """A 0.6 × 0.6 m wall of ``n`` hits 2 m in front of the origin (at a
    0.1 m leaf over 128 points in the blocks it crosses) and ``far`` hits
    10 m out in random directions (models of a few points)."""
    rng = np.random.default_rng(seed)
    y, z = rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n)
    wall = np.stack([2.0 + 0.01 * rng.standard_normal(n), y, z], -1)
    d = rng.normal(size=(far, 3))
    d = 10.0 * d / np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([wall, d]).astype(np.float32), np.zeros(3, np.float32)


@pytest.mark.parametrize("path", ["device ingest", "host tables"])
def test_gp_counters_count_what_k4_is_given(monkeypatch, path):
    """On each of GP's dispatch paths, with models over BASE_MAX_C points (a
    wall downsampled at 0.1 m in 1.6 m blocks) and models under it, the
    counters equal the models, points and size tiers that K4's launches
    receive."""
    given = []
    orig = gp_heavy.gp_heavy
    monkeypatch.setattr(gp_heavy, "gp_heavy", lambda *a, **k: (
        given.append(np.asarray(k["host_counts"])), orig(*a, **k))[1])
    cfg = MapConfig(**{**yaml.safe_load(open(os.path.join(
        ROOT, "la3dm_tpu_torch", "configs", "methods", "gpoctomap_large_map.yaml"))),
        "device_ingest": "on" if path == "device ingest" else "off"})
    m = build_map(cfg, device="cpu")
    cloud, origin = _wall_and_far(11)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        m.insert_pointcloud(cloud, origin, ds_resolution=0.1)
    counts = profiling.snapshot()["counts"]
    c = np.concatenate(given)
    assert (c > gp_heavy.BASE_MAX_C).any() and (c <= gp_heavy.BASE_MAX_C).any()
    assert counts["gp_tier_launches"] == len(given) == m.stats["heavy_tiers"] == 2
    assert counts["gp_models"] == c.size
    assert counts["gp_model_points"] == int(c.sum())
    assert counts["gp_overflow_models"] == int((c > gp_heavy.BASE_MAX_C).sum())
    # the path taken: device ingest resolves its slots through K7w's dispatch
    assert counts.get("slot_dispatches_card", 0) == (path == "device ingest")


def test_the_configs_method_is_the_upstream_yaml_key_for_key():
    """The cell's method block is ``gpoctomap_large_map.yaml`` key for key,
    with ``device_ingest: auto`` added; the dataset's range is the map's."""
    conf = json.load(open(os.path.join(ROOT, "benchmark", "configs", "gp_large_vlp16.json")))
    upstream = yaml.safe_load(open(os.path.join(
        ROOT, "la3dm_tpu_torch", "configs", "methods", "gpoctomap_large_map.yaml")))
    meth = dict(conf["method"])
    assert meth.pop("device_ingest") == "auto"
    assert set(meth) == set(upstream)
    for k, v in upstream.items():
        assert meth[k] == v and type(meth[k]) in (type(v), float), k
    assert conf["dataset"]["max_range"] == upstream["max_range"]
    assert conf["reduced"] == ["sequence_scans"] and conf["sequence_scans"] == 120
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    entry = next(c for c in bench["configs"] if c["name"] == conf["name"])
    assert entry["source"] == conf["source"] and entry["reduced"] == conf["reduced"]
    others = json.load(open(os.path.join(ROOT, "benchmark", "configs", "bgkl_large_vlp16.json")))
    for k in ("scene", "sensor", "trajectory"):
        assert conf[k] == others[k], k
