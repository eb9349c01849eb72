"""Guards of the PyTorch port: it imports no JAX and nothing of la3dm_tpu,
and its entry points do not fall back to the CPU."""

import ast
import ctypes
import os
import re
import subprocess
import sys

import pytest
import torch

from la3dm_tpu_torch import (BGKLOctoMap, BGKLVOctoMap, BGKOctoMap, GPOctoMap,
                             load_method_config)
from la3dm_tpu_torch.kernels import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "la3dm_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "la3dm_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_import_pulls_in_no_jax():
    # a subprocess: this test process has JAX loaded by tests/conftest.py
    code = (
        "import sys\n"
        "import la3dm_tpu_torch, la3dm_tpu_torch.models.bgk, la3dm_tpu_torch.pipeline\n"
        "import la3dm_tpu_torch.models.bgklv, la3dm_tpu_torch.kernels.lv_rows\n"
        "import la3dm_tpu_torch.kernels.lv_prune, la3dm_tpu_torch.models.gp\n"
        "import la3dm_tpu_torch.kernels.gp_heavy, la3dm_tpu_torch.kernels.gp_light\n"
        "import la3dm_tpu_torch.geometry.device_ingest, la3dm_tpu_torch.models.ingest\n"
        "import la3dm_tpu_torch.kernels.bgk_aligned_heavy, la3dm_tpu_torch.models.bgkl\n"
        "import la3dm_tpu_torch.models.raycast, la3dm_tpu_torch.kernels.ingest_rays\n"
        "import la3dm_tpu_torch.cli, la3dm_tpu_torch.entry, la3dm_tpu_torch.io.octomap_bt\n"
        "import la3dm_tpu_torch.io.rosbag, la3dm_tpu_torch.viz.markers\n"
        "import la3dm_tpu_torch.viz.html, la3dm_tpu_torch.utils.profiling\n"
        "import la3dm_tpu_torch.parallel.mesh, la3dm_tpu_torch.parallel.sharded_map\n"
        "import la3dm_tpu_torch.parallel.distributed\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_sources_import_no_jax():
    n = 0
    seen = set()
    for path in _port_sources():
        seen.add(os.path.relpath(path, ROOT))
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(nm) for nm in names), (path, names)
        n += 1
    assert n > 10
    for mod in ("mesh", "sharded_map", "distributed"):
        assert os.path.join("la3dm_tpu_torch", "parallel", f"{mod}.py") in seen


def test_sharded_map_without_device_does_not_fall_back_to_cpu(monkeypatch):
    from la3dm_tpu_torch.parallel import mesh, sharded_map

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_method_config("bgk", max_range=8.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded_map.ShardedBGKOctoMap(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.block_mesh(4)
    m = sharded_map.ShardedGPOctoMap(load_method_config("gp", max_range=8.0),
                                     mesh=mesh.block_mesh(4, "cpu"), capacity=64)
    assert m.device.type == "cpu" and m.pool.fields["ivar"].device.type == "cpu"


def test_map_without_device_does_not_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_method_config("bgk", max_range=8.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        BGKOctoMap(cfg)
    assert BGKOctoMap(cfg, device="cpu").device.type == "cpu"


def test_lv_map_without_device_does_not_fall_back_to_cpu(monkeypatch):
    from la3dm_tpu_torch import pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_method_config("bgklv", max_range=8.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        BGKLVOctoMap(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.build_map(cfg)
    assert BGKLVOctoMap(cfg, device="cpu").device.type == "cpu"


def test_kernel_library_binds_every_entry_point():
    class Lib:  # records what _bind declares
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    lib = _build._bind(Lib())
    n_args = {"la3dm_bgk_heavy": 20, "la3dm_sparse_kernel_scan": 5, "la3dm_bgk_light": 23,
              "la3dm_lv_rows": 31, "la3dm_lv_prune": 18, "la3dm_gp_heavy": 35,
              "la3dm_gp_light": 27,
              "la3dm_ingest_points": 9, "la3dm_ingest_beams": 18,
              "la3dm_ingest_downsample": 10, "la3dm_ingest_members": 15,
              "la3dm_bgk_aligned_heavy": 18, "la3dm_ingest_rays_count": 18,
              "la3dm_ingest_rays_write": 17,
              "la3dm_raycast": 22, "la3dm_ingest_sort": 14, "la3dm_ingest_bucket": 23,
              "la3dm_ingest_slots_world": 10, "la3dm_ingest_slots_gather": 12}
    for name, n in n_args.items():
        fn = getattr(lib, name)
        assert fn.restype is ctypes.c_int and len(fn.argtypes) == n, name
        assert fn.argtypes[-1] is ctypes.c_void_p  # the stream
    # every C entry point in the sources is bound
    srcs = "".join(open(os.path.join(_build.CSRC_DIR, f)).read()
                   for f in sorted(os.listdir(_build.CSRC_DIR)) if f.endswith(".cu"))
    assert sorted(re.findall(r'extern "C" int (\w+)\(', srcs)) == sorted(n_args)


def test_bgkl_map_without_device_does_not_fall_back_to_cpu(monkeypatch):
    from la3dm_tpu_torch import pipeline
    from la3dm_tpu_torch.models import raycast

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_method_config("bgkl", max_range=8.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        BGKLOctoMap(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.build_map(cfg)
    m = BGKLOctoMap(cfg, device="cpu")
    assert m.device.type == "cpu" and not m._ingest_enabled()
    assert BGKLOctoMap(load_method_config("bgkl", device_ingest="on"),
                       device="cpu")._ingest_enabled()
    # the raycast snapshot lives on the map's device
    snap = raycast.raycast_snapshot(m)
    assert snap.state_tab.device.type == snap.tab_hi.device.type == "cpu"


def test_gp_map_without_device_does_not_fall_back_to_cpu(monkeypatch):
    from la3dm_tpu_torch import pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_method_config("gp", max_range=8.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPOctoMap(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.build_map(cfg)
    assert GPOctoMap(cfg, device="cpu").device.type == "cpu"
    assert GPOctoMap(load_method_config("gp", device_ingest="on"), device="cpu")._ingest_enabled()


def test_device_ingest_on_is_not_ported():
    """Every family takes ``device_ingest: on`` (BGK and GP ingest on the
    map's device, BGKLV reads no flag), and ``auto`` leaves a CPU map on
    the host path."""
    for method in ("bgk", "bgkl", "gp", "bgklv"):
        for mode, on in (("on", True), ("auto", False), ("off", False)):
            m = {"bgk": BGKOctoMap, "bgkl": BGKLOctoMap, "gp": GPOctoMap,
                 "bgklv": BGKLVOctoMap}[method](
                load_method_config(method, max_range=8.0, device_ingest=mode), device="cpu")
            assert getattr(m, "_ingest_enabled", lambda: False)() == (on and method != "bgklv")


def test_kernel_build_flags_keep_parity():
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f for f in _build.NVCC_FLAGS)


def test_kernel_build_raises_without_nvcc(monkeypatch):
    # no silent plain fall-back: without a CUDA compiler the build raises
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "_NVCC_DEFAULT", "/nonexistent/nvcc")
    monkeypatch.setattr(_build, "_SO", "/nonexistent/libla3dm_kernels.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
