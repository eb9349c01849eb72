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


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_run(cell: str, seed: int = 3, root: str = ROOT) -> dict:
    parts = run.load_cell(cell, root=root)
    return run.run_cell(parts, seed=seed, seconds=0.0, trace=False, device="cpu",
                        t_start=time.perf_counter(), sensor=TINY["sensor"],
                        method={"device_ingest": "on"}, scans=TINY["scans"])


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


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_programs_plain_path(cell):
    out = _tiny_run(cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["blocks_apart"]["value"] == 0
    assert out["work"]["test_blocks" if "bgkl" in cell else "models"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_control_fails(cell):
    """The reference with the coordinates its heavy pass reads rounded to
    TF32, in the program's place, comes out not correct."""
    parts = run.load_cell(cell)
    conf = parts["config"]
    conf = {**conf, "sensor": {**conf["sensor"], **TINY["sensor"]}}
    clouds, origins = scene.scans(conf, TINY["scans"], 7)
    ref_mod, _ = run.family(conf["method"]["method"])
    mr = float(conf["dataset"]["max_range"])
    ref = ref_mod.run(clouds, origins, conf["method"], max_range=mr, device="cpu")
    ctl = ref_mod.run(clouds, origins, conf["method"], max_range=mr, device="cpu", tf32=True)
    nums = compare.compare(ctl, ref, lambda v: ref_mod.state(v, conf["method"]))
    assert not compare.judge(nums, parts["check"]["limits"]), nums


def _faults(family: str):
    """(name, patcher) of each planted fault of the program's timed path."""
    from la3dm_tpu_torch.kernels import bgk_light, gp_light
    from la3dm_tpu_torch.models.bgkl import BGKLOctoMap
    from la3dm_tpu_torch.models.gp import GPOctoMap

    cls = BGKLOctoMap if family == "bgkl" else GPOctoMap
    orig = cls.insert_pointclouds

    def unchanged(mp):
        mp.setattr(cls, "insert_pointclouds", lambda self, *a, **k: None)

    def half(mp):
        def first_half(self, clouds, origins, **kw):
            orig(self, clouds[:len(clouds) // 2], origins[:len(origins) // 2], **kw)
        mp.setattr(cls, "insert_pointclouds", first_half)

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
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    name, plant = _faults("bgkl" if "bgkl" in cell else "gp")[fault]
    plant(monkeypatch)
    out = _tiny_run(cell)
    assert not out["correct"], (name, out["checks"])


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
