"""CPU tests of the benchmark harness: the scene, discovery by name, the
reference against the program's plain path, the lower-precision control,
planted faults, and the import rules.  Run from the repository root:

    python -m pytest benchmark/tests -q

The card's test (marked ``cuda``) runs a cell through the command line and
skips where there is no card.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import compare, run, scene  # noqa: E402

#: a scene the CPU runs in seconds: 4 rings × 60 azimuth steps, 4 scans
TINY = {"sensor": {"rings": 4, "azimuth_steps": 60}, "scans": 4}
CELLS = ("bgkl_room_vlp16.offline", "gp_room_vlp16.offline")
ONLINE = "bgkl_large_vlp16.online"
#: the online cell's CPU scene: 2 rings (±15°) × 600 azimuth steps, 2 scans;
#: dense enough near the sensor (7 cm between beams on the ground) that the
#: server's 0.5 m pre-downsample merges points, as it does at full size
SIZES = {ONLINE: {"sensor": {"rings": 2, "azimuth_steps": 600}, "scans": 2}}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_run(cell: str, seed: int = 3, root: str = ROOT) -> dict:
    parts = run.load_cell(cell, root=root)
    size = SIZES.get(cell, TINY)
    return run.run_cell(parts, seed=seed, seconds=0.0, trace=False, device="cpu",
                        t_start=time.perf_counter(), sensor=size["sensor"],
                        method={"device_ingest": "on"}, scans=size["scans"])


def _tiny_load(cell: str, seed: int) -> tuple[dict, dict]:
    """(parts, load) of a cell at its CPU size."""
    parts = run.load_cell(cell)
    size = SIZES.get(cell, TINY)
    conf = parts["config"]
    conf = {**conf, "sensor": {**conf["sensor"], **size["sensor"]}}
    return parts, parts["generator"].build(conf, parts["traffic"], seed, "cpu",
                                           scans=size["scans"])


def test_scene_is_deterministic_by_seed():
    conf = run.load_cell(CELLS[0])["config"]
    conf = {**conf, "sensor": {**conf["sensor"], **TINY["sensor"]}}
    a = scene.scans(conf, 3, 2 ** 31 + 11)
    b = scene.scans(conf, 3, 2 ** 31 + 11)
    c = scene.scans(conf, 3, 2 ** 31 + 12)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0][0], c[0][0])
    assert a[0][0].shape == (4 * 60, 3) and a[0][0].dtype == np.float32
    full = run.load_cell(CELLS[0])["config"]["sensor"]
    assert full["rings"] * full["azimuth_steps"] == 28800


#: sha256 of the first 3 full-size scans and origins of seed 2**31 + 11, as the
#: scene's numpy version of the offline cells' PR made them (both room
#: configurations share their room, sensor and trajectory)
SCENE_SHA256 = {
    "bgkl_room_vlp16": "067c9b7d143a5190119a956d71385fb602dab6f54c6d34a7d08972bf2b14600c",
    "bgkl_large_vlp16": "ba7f4222d5721c205a6cdd9f2853b03f3193e95bd111e155928d9417dcc73aa9"}


def _scene_sha256(name: str, device: str) -> str:
    import hashlib

    conf = json.load(open(os.path.join(ROOT, "benchmark", "configs", name + ".json")))
    clouds, origins = scene.scans(conf, 3, 2 ** 31 + 11, device)
    h = hashlib.sha256()
    for x in clouds + origins:
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(SCENE_SHA256))
def test_the_scene_keeps_its_bits(name):
    """Tracing the rays in PyTorch left every scan as numpy's tracing made it."""
    assert _scene_sha256(name, "cpu") == SCENE_SHA256[name]


def test_discovery_by_name_needs_no_edit(tmp_path):
    """A configuration, a traffic mix with a generator of its own kind and a
    per-layer metric added as new files (and entries) are found by name and
    run."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    conf = json.load(open(os.path.join(ROOT, "benchmark/configs/bgkl_room_vlp16.json")))
    conf["name"] = "bgkl_throwaway"
    conf["sensor"]["rings"] = 3
    (tmp_path / "benchmark/configs/bgkl_throwaway.json").write_text(json.dumps(conf))
    shutil.copy(tmp_path / "benchmark/checks/bgkl_room_vlp16.json",
                tmp_path / "benchmark/checks/bgkl_throwaway.json")
    shutil.copy(tmp_path / "benchmark/traffic/offline_passes.py",
                tmp_path / "benchmark/traffic/offline_passes_copy.py")
    (tmp_path / "benchmark/traffic/offline_seq3.json").write_text(json.dumps(
        {"name": "offline_seq3", "kind": "offline_passes_copy", "sequence_scans": 3,
         "trace_layer": "heavy pass"}))
    (tmp_path / "benchmark/metrics/passes_traced.py").write_text(
        "def read(ctx):\n    return ctx.get('passes')\n")
    bench["configs"].append({"name": "bgkl_throwaway", "source": "test",
                             "file": "benchmark/configs/bgkl_throwaway.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "bgkl_throwaway.offline", "config": "bgkl_throwaway",
                               "traffic": "offline_seq3", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "passes_traced", "unit": "passes", "better": "higher",
                               "source": "program_counter", "layer": "map entry",
                               "moves": "scans_per_s", "workloads": ["bgkl_throwaway.offline"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    parts = run.load_cell("bgkl_throwaway.offline", root=str(tmp_path))
    assert parts["config"]["sensor"]["rings"] == 3
    assert parts["traffic"]["sequence_scans"] == 3
    assert parts["generator"].__file__.endswith("offline_passes_copy.py")
    assert parts["readers"]["passes_traced"]({"passes": 5}) == 5
    assert "passes_traced" not in run.load_cell(CELLS[0], root=str(tmp_path))["readers"]
    out = run.run_cell(parts, seed=5, seconds=0.0, trace=False, device="cpu",
                       t_start=time.perf_counter(), sensor={"azimuth_steps": 60},
                       method={"device_ingest": "on"})
    assert out["attempted"] == 3 and out["correct"]


@pytest.mark.parametrize("extra", [{"fresh_map_per_pass": False}, {"loop": "open"},
                                   {"streams": 2}, {"streams": True}, {"rate_hz": 10}])
def test_a_mix_its_generator_does_not_run_is_refused(tmp_path, extra):
    """A traffic mix that asks for what its kind's generator does not run, or
    names a key the generator does not read, is refused before any run."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    path = tmp_path / "benchmark/traffic/offline_seq60.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **extra}))
    with pytest.raises(ValueError, match=next(iter(extra))):
        run.load_cell(CELLS[0], root=str(tmp_path))


@pytest.mark.parametrize("extra", [{"fresh_map_per_pass": False}, {"loop": "open"},
                                   {"streams": 2}, {"republish": True}, {"rate_hz": 10}])
def test_online_scans_refuses_a_mix_it_does_not_run(tmp_path, extra):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    path = tmp_path / "benchmark/traffic/online_seq120.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **extra}))
    with pytest.raises(ValueError, match=next(iter(extra))):
        run.load_cell(ONLINE, root=str(tmp_path))


@pytest.mark.parametrize("cell", CELLS + (ONLINE,))
def test_reference_agrees_with_the_programs_plain_path(cell):
    out = _tiny_run(cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["blocks_apart"]["value"] == 0
    assert out["work"]["test_blocks" if "bgkl" in cell else "models"] > 0


@pytest.mark.parametrize("cell", CELLS + (ONLINE,))
def test_the_lower_precision_control_fails(cell):
    """The reference with the coordinates its heavy pass reads rounded to
    TF32, in the program's place, comes out not correct."""
    parts, load = _tiny_load(cell, 7)
    meth = parts["config"]["method"]
    ref_mod, _ = run.family(meth["method"])
    mr = float(parts["config"]["dataset"]["max_range"])
    ref = run.reference(ref_mod, load, meth, max_range=mr, device="cpu")
    ctl = run.reference(ref_mod, load, meth, max_range=mr, device="cpu", tf32=True)
    nums = compare.compare(ctl, ref, lambda v: ref_mod.state(v, meth))
    assert not compare.judge(nums, parts["check"]["limits"]), nums


@pytest.mark.parametrize("cell", CELLS)
def test_reference_batches_and_leaf_leave_the_map_bit_identical(cell):
    """The reference's new defaults (``ds`` at ``resolution``, the whole
    sequence in one batch), as the harness feeds them to today's cells, give
    the map the reference gave before, bit for bit; so does a batch of one
    scan, or of three."""
    parts, load = _tiny_load(cell, 5)
    meth = parts["config"]["method"]
    ref_mod, _ = run.family(meth["method"])
    mr = float(parts["config"]["dataset"]["max_range"])
    clouds, origins = load["clouds"], load["origins"]
    with torch.no_grad():
        base = ref_mod.run(clouds, origins, meth, max_range=mr, device="cpu")
        others = [ref_mod.run(clouds, origins, meth, max_range=mr, device="cpu", **kw)
                  for kw in ({"batch": 1}, {"batch": 3}, {"ds": meth["resolution"]})]
    others.append(run.reference(ref_mod, load, meth, max_range=mr, device="cpu"))
    for other in others:
        assert np.array_equal(base["coords"], other["coords"])
        assert torch.equal(base["touched"], other["touched"])
        assert torch.equal(base["eff"], other["eff"])
        for k in base["fields"]:
            assert torch.equal(base["fields"][k], other["fields"][k]), k


def test_the_server_downsample_matches_the_programs():
    """The reference's pre-downsample gives the program's host
    ``voxel_downsample`` bit for bit, on full-size scans of the large scene."""
    from benchmark.reference import server
    from la3dm_tpu_torch.geometry.preprocess import voxel_downsample

    conf = run.load_cell(ONLINE)["config"]
    clouds, _ = scene.scans(conf, 3, 2 ** 31 + 5)
    for cloud in clouds:
        for leaf in (0.5, 0.2):
            want = voxel_downsample(cloud, leaf)
            got = server.voxel_grid(cloud, leaf, "cpu")
            assert got.dtype == np.float32 and np.array_equal(got, want), leaf
    assert len(server.voxel_grid(clouds[0], 0.5, "cpu")) < len(clouds[0]) // 2


def test_the_large_scene_needs_30_m():
    """Over a pass, at least 15 % of the beams end between 17.5 m (the
    room's farthest) and 30 m, and at least 10 % past 30 m."""
    conf = run.load_cell(ONLINE)["config"]
    clouds, origins = scene.scans(conf, 120, 2 ** 31 + 9)
    r = np.concatenate([np.linalg.norm(c - o, axis=1) for c, o in zip(clouds, origins)])
    assert np.mean((r > 17.5) & (r <= 30.0)) >= 0.15
    assert np.mean(r > 30.0) >= 0.10


def test_scan_p95_ms_from_given_latencies():
    """The reader of ``scan_p95_ms``, which ``BENCHMARK.json`` does not list
    yet (PERF.md, section 2), from latencies given to it."""
    read = run._readers([{"name": "scan_p95_ms"}], ONLINE,
                        os.path.join(ROOT, "benchmark", "end_to_end"))["scan_p95_ms"]
    lat = [i / 1000.0 for i in range(100, 0, -1)]          # 1 … 100 ms, any order
    assert read({"latencies_s": lat}) == pytest.approx(95.05)
    assert read({"latencies_s": [0.004] * 7}) == pytest.approx(4.0)
    assert read({"latencies_s": []}) is None and read({}) is None


@pytest.mark.parametrize("cell", CELLS + (ONLINE,))
def test_a_cell_reports_its_end_to_end_metrics_from_their_readers(cell):
    """Each end-to-end metric that ``BENCHMARK.json`` gives a cell is read by
    its own file in ``benchmark/end_to_end/``."""
    parts = run.load_cell(cell)
    assert set(parts["end_to_end_readers"]) == {m["name"] for m in parts["end_to_end"]} \
        == {"scans_per_s", "setup_s"}
    ctx = {"scans": 240, "window_s": 2.0, "setup_s": 11.5, "latencies_s": [0.01] * 240}
    got = {k: read(ctx) for k, read in parts["end_to_end_readers"].items()}
    assert got == {"scans_per_s": 120.0, "setup_s": 11.5}


def _faults(family: str):
    """(name, patcher) of each planted fault of the program's timed path."""
    from la3dm_tpu_torch.kernels import bgk_light, gp_light
    from la3dm_tpu_torch.models.bgkl import BGKLOctoMap
    from la3dm_tpu_torch.models.gp import GPOctoMap

    cls = BGKLOctoMap if family == "bgkl" else GPOctoMap
    orig, orig_one = cls.insert_pointclouds, cls.insert_pointcloud

    def unchanged(mp):
        mp.setattr(cls, "insert_pointclouds", lambda self, *a, **k: None)
        mp.setattr(cls, "insert_pointcloud", lambda self, *a, **k: None)

    def half(mp):
        def first_half(self, clouds, origins, **kw):
            orig(self, clouds[:len(clouds) // 2], origins[:len(origins) // 2], **kw)

        def every_other(self, *a, **kw):       # one scan at a time: the odd ones dropped
            self.bench_offered = getattr(self, "bench_offered", 0) + 1
            if self.bench_offered % 2:
                orig_one(self, *a, **kw)
        mp.setattr(cls, "insert_pointclouds", first_half)
        mp.setattr(cls, "insert_pointcloud", every_other)

    def altered(mp):
        mod, name = (bgk_light, "bgk_light") if family == "bgkl" else (gp_light, "gp_light")
        light = getattr(mod, name)

        def wrong(acc, *a, **kw):
            acc = acc.clone()
            acc[..., : acc.shape[-1] // 2] *= 0.5      # ȳ (BGK-L) or the means (GP) halved
            return light(acc, *a, **kw)
        mp.setattr(mod, name, wrong)

    def one_block(mp):
        mod, name = (bgk_light, "bgk_light") if family == "bgkl" else (gp_light, "gp_light")
        light = getattr(mod, name)
        # positions of the pool's fields, (A, B) or (m_ivar, ivar), and of ``slots``
        fields, at = ((1, 2), 6) if family == "bgkl" else ((3, 4), 8)

        def doubled(*a, **kw):
            light(*a, **kw)
            x, y = a[fields[0]], a[fields[1]]
            sl = a[at][a[at + 1]:a[at + 1] + a[at + 2]].long()
            sl = sl[sl < x.shape[0]]
            if sl.numel():
                # the scan's block with the most evidence has its answers doubled
                s = sl[torch.argmax((x[sl].abs() + y[sl].abs()).sum(1))]
                x[s] *= 2.0
                y[s] *= 2.0
        mp.setattr(mod, name, doubled)

    return [("state unchanged", unchanged), ("half the scans left out", half),
            ("answers altered where produced", altered),
            ("one block's answers doubled where produced", one_block)]


@pytest.mark.parametrize("fault", range(4))
@pytest.mark.parametrize("cell", CELLS + (ONLINE,))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    name, plant = _faults("bgkl" if "bgkl" in cell else "gp")[fault]
    plant(monkeypatch)
    out = _tiny_run(cell)
    assert not out["correct"], (name, out["checks"])


def test_a_server_path_at_the_static_nodes_leaf_is_not_correct(monkeypatch):
    """The online cell's timed path downsampling at ``resolution`` (the
    static node's leaf), both on the host and in the map, where the server
    takes ``ds_resolution``."""
    import la3dm_tpu_torch.pipeline as pipeline

    def offer(self, cloud, origin, quat=None):
        res = self.map.cfg.resolution
        self.map.insert_pointcloud(pipeline.voxel_downsample(cloud, res),
                                   np.asarray(origin, np.float32), ds_resolution=res)
        self.n_integrated += 1
        return True
    monkeypatch.setattr(pipeline.OnlineIntegrator, "offer", offer)
    out = _tiny_run(ONLINE)
    assert not out["correct"], out["checks"]


def test_skipping_the_pre_downsample_changes_the_map_by_rounding_only(monkeypatch):
    """Without the server's pre-downsample the map still downsamples at the
    same leaf, so the hits differ only by the rounding of their centroids:
    the check cannot see this fault, and ``scan_p95_ms`` prices the step
    instead."""
    import la3dm_tpu_torch.pipeline as pipeline

    monkeypatch.setattr(pipeline, "voxel_downsample", lambda c, leaf: np.asarray(c, np.float32))
    out = _tiny_run(ONLINE)
    r = out["readings"]
    assert 0 < r["gap_max"] < 1e-6 and r["voxels_apart"] == 0 and r["blocks_apart"] == 0, r


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module)
    return out


def _sources(sub: str = ""):
    top = os.path.join(ROOT, "benchmark", sub)
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(run.FORBIDDEN), (path, tops & set(run.FORBIDDEN))
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run as r, benchmark.reference.bgkl, benchmark.reference.gp\n"
            "import la3dm_tpu_torch.pipeline\n"
            "print(','.join(r.forbidden_modules()))" % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_the_reference_imports_nothing_of_the_program():
    for sub in ("reference", "counts"):
        for path in _sources(sub):
            tops = {name.split(".")[0] for name in _imports(path)}
            assert "la3dm_tpu_torch" not in tops, path


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU mode")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "2147483700", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["scans_per_s"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENE_SHA256))
def test_the_card_traces_the_scene_as_the_cpu_does(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert _scene_sha256(name, "cuda") == SCENE_SHA256[name]


@pytest.mark.cuda
def test_the_online_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU mode")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", ONLINE,
                          "--seed", "2147483701", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["attempted"] == 120 * res["passes"] and res["failed"] == 0
    assert set(res["metrics"]) == {"scans_per_s", "setup_s"}
    assert 0 < res["scan_ms"]["median"] <= res["scan_ms"]["max"]
