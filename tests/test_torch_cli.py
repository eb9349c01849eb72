"""The port's command line (``python -m la3dm_tpu_torch.cli``) against the JAX
package's, on the CPU: ``static`` for every family on the tiny two-scan
scene of ``tests/test_aux.py`` (both CLIs in-process, the port with
``--device cpu``; the maps held to each other voxel by voxel at the family
limits of ``tests/torch_cli_cases.py``, the exports of the two runs byte
for byte), the module entry in a subprocess, ``--profile-dir``, ``--help``
of every command, and no fall-back to the CPU without ``--device cpu``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from la3dm_tpu.pipeline import build_map as jbuild_map
from la3dm_tpu.utils.config import load_method_config as jload_method_config

from la3dm_tpu_torch import cli
from la3dm_tpu_torch.pipeline import build_map
from la3dm_tpu_torch.utils.config import load_method_config

from tests.test_bgk_vs_oracle import compare_maps
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_cli_cases import LIMITS, METHODS, JaxMapAsOracle, run_both, tiny_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMANDS = ("static", "server", "bag", "eval", "query", "raycast", "frontier")
EXPORTS = ("_occupied.ply", "_free.ply", "_occupied.csv", "_map.bt", "_map.html")


def _maps(method, jax_npz, port_npz):
    """(the port's map of ``port_npz``, the JAX map of ``jax_npz``)."""
    ours = build_map(load_method_config(method), "cpu")
    ours.load(port_npz)
    ref = jbuild_map(jload_method_config(method))
    ref.load(jax_npz)
    return ours, ref


@pytest.mark.parametrize("method", METHODS)
def test_static_matches_jax_cli(tmp_path, method):
    ds = tiny_scene(str(tmp_path))
    (jrc, jout, jpre), (rc, out, pre) = run_both(
        ["static", "--method", method, "--dataset", ds, "--out", "map"], tmp_path)
    assert jrc == rc == 0
    # the same prints, scan by scan, but for the times
    lines = [ln for ln in out.splitlines() if not ln.startswith(("Scan ", "Mapping"))]
    jlines = [ln for ln in jout.splitlines() if not ln.startswith(("Scan ", "Mapping"))]
    assert [ln.replace("torch", "jax") for ln in lines] == jlines
    assert sum(ln.startswith("Scan ") for ln in out.splitlines()) == 2   # per-scan path
    assert "scans/s)" in out.splitlines()[2]
    ours, ref = _maps(method, jpre + "_map.npz", pre + "_map.npz")
    n, _ = compare_maps(ours, JaxMapAsOracle(ref), **LIMITS[method])
    assert n > 500
    for suffix in EXPORTS:
        with open(pre + suffix, "rb") as f, open(jpre + suffix, "rb") as g:
            assert f.read() == g.read(), suffix


def test_module_entry_runs_static_on_the_cpu(tmp_path):
    ds = tiny_scene(str(tmp_path))
    out = str(tmp_path / "out" / "map")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "la3dm_tpu_torch.cli", "static", "--method", "bgk",
         "--dataset", ds, "--out", out, "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Mapping finished" in r.stdout and "Exported" in r.stdout
    for suffix in EXPORTS + ("_map.npz",):
        assert os.path.getsize(out + suffix) > 0, suffix


def test_profile_dir_writes_a_trace(tmp_path):
    ds = tiny_scene(str(tmp_path))
    prof = tmp_path / "prof"
    assert cli.main(["static", "--method", "bgk", "--dataset", ds, "--device", "cpu",
                     "--profile-dir", str(prof)]) == 0
    traces = list(prof.glob("trace_*"))
    assert len(traces) == 1 and traces[0].suffix == ".json"
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert len(events) > 100
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_profile_dir_writes_the_spans_beside_the_trace(tmp_path):
    """``--profile-dir`` also writes the run's span and counter totals
    (``utils/profiling.py``), named as its trace is, and the trace holds the
    spans as events."""
    ds = tiny_scene(str(tmp_path))
    prof = tmp_path / "prof"
    assert cli.main(["static", "--method", "bgk", "--dataset", ds, "--device", "cpu",
                     "--profile-dir", str(prof)]) == 0
    (trace,), (spans,) = list(prof.glob("trace_*.json")), list(prof.glob("spans_*.json"))
    assert spans.name[len("spans_"):] == trace.name[len("trace_"):]
    with open(spans) as f:
        totals = json.load(f)
    insert = totals["spans"]["la3dm.map.insert"]
    assert insert["calls"] == 2 and 0 < insert["self_s"] <= insert["s"]
    assert totals["counts"]["scans"] == 2
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"la3dm.map.build", "la3dm.map.insert", "la3dm.heavy.launch"} <= names


@pytest.mark.parametrize("command", COMMANDS)
def test_help_of_every_command(capsys, command):
    with pytest.raises(SystemExit) as e:
        cli.main([command, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith(f"usage: la3dm_tpu_torch {command}") and "--device" in out


_ARGS = {"static": ["--dataset", "x.yaml"], "server": ["--watch", "."],
         "bag": ["--bag", "x.bag"], "eval": ["--dataset", "x.yaml"],
         "query": ["--checkpoint", "x.npz", "0,0,0"],
         "raycast": ["--checkpoint", "x.npz", "0,0,0,1,0,0"],
         "frontier": ["--checkpoint", "x.npz"]}


@pytest.mark.parametrize("command", COMMANDS)
def test_no_fallback_without_a_card(monkeypatch, capsys, command):
    """Without ``--device cpu`` every command exits non-zero at once and names
    the missing card (this machine has none; the monkeypatch makes sure)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([command, *_ARGS[command]]) == 2
    err = capsys.readouterr().err
    assert "CUDA card" in err and "--device cpu" in err


def test_module_entry_exits_non_zero_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run on it")
    ds = tiny_scene(str(tmp_path))
    r = subprocess.run([sys.executable, "-m", "la3dm_tpu_torch.cli", "static", "--method",
                        "bgk", "--dataset", ds], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert r.returncode != 0 and "CUDA card" in r.stderr
    assert "Mapping finished" not in r.stdout
    assert not any(n.endswith(".npz") for n in os.listdir(tmp_path))


def test_overrides_parse_as_json_or_strings():
    assert cli._parse_overrides(["max_range=8.0", "device_ingest=\"off\"", "method=bgk",
                                 "predict=true"]) == \
        {"max_range": 8.0, "device_ingest": "off", "method": "bgk", "predict": True}


def test_static_takes_overrides_and_scan_num(tmp_path, capsys):
    ds = tiny_scene(str(tmp_path), n_scans=3)
    assert cli.main(["static", "--method", "bgk", "--dataset", ds, "--scan-num", "1",
                     "--set", "block_depth=2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("Scan ") == 1 and "occupied," in out
    assert np.isfinite(float(out.split("(")[1].split()[0]))
