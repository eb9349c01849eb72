"""The port's ``server``, ``query``, ``raycast``, ``frontier`` and ``eval``
commands and its single-card entry (``la3dm_tpu_torch/entry.py``) against the
JAX package's, on the CPU.

``server --once`` mirrors ``tests/test_aux.py::test_server_cli_gates_
duplicate_scans`` (a scan re-saved at a pose 0.05 m away is gated out).
``query``, ``raycast`` and ``frontier`` read one JAX checkpoint a family in
both CLIs: query's printed numbers (4 decimals) within the family's limit,
frontier's count and CSV equal, raycast's lines equal except on rays where
the two DDAs read a voxel at a tie (``tests/test_torch_raycast.py``: every
DDA voxel centre lies on a voxel face; each such ray shows the tie, and the
JAX host stepper arbitrates).  ``eval`` scores both CLIs' maps against a
ground truth that the test writes with the port's ``write_bt``: every report
field equal but ``scans_per_s``, floats within 1e-3.
"""

import json
import os

import numpy as np
import pytest
import torch

import __graft_entry__
from la3dm_tpu.io import pcd as jpcd
from la3dm_tpu.models import bgk as jbgk
from la3dm_tpu.pipeline import build_map as jbuild_map
from la3dm_tpu.utils.config import load_method_config as jload_method_config

from la3dm_tpu_torch import pipeline
from la3dm_tpu_torch.entry import entry, tiny_scan
from la3dm_tpu_torch.io.octomap_bt import write_bt
from la3dm_tpu_torch.io.pcd import load_pcd_full, save_pcd
from la3dm_tpu_torch.models import bgk, raycast as port_raycast
from la3dm_tpu_torch.utils.config import load_method_config

from tests.test_bgk_vs_oracle import compare_maps
from tests.test_torch_raycast import assert_ties_on_path
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_cli_cases import (LIMITS, METHODS, JaxMapAsOracle, jax_checkpoints, run_both,
                             tiny_scene)


@pytest.fixture(scope="module")
def jax_npz(tmp_path_factory):
    return jax_checkpoints(tmp_path_factory.mktemp("scene"))


def _maps(method, path):
    ours = pipeline.build_map(load_method_config(method), "cpu")
    ours.load(path)
    ref = jbuild_map(jload_method_config(method))
    ref.load(path)
    return ours, ref


# ------------------------------------------------------------ server

def test_server_once_gates_the_duplicate_pose_as_jax(tmp_path):
    rng = np.random.default_rng(4)
    cloud = (rng.random((200, 3)) * 4 + 1).astype(np.float32)
    watch = tmp_path / "scans"
    watch.mkdir()
    save_pcd(str(watch / "a_1.pcd"), cloud, origin=(0.0, 0.0, 0.0))
    save_pcd(str(watch / "a_2.pcd"), cloud, origin=(0.0, 0.0, 0.05))  # dup pose
    save_pcd(str(watch / "a_3.pcd"), cloud, origin=(0.5, 0.0, 0.0))
    (jrc, jout, jpre), (rc, out, pre) = run_both(
        ["server", "--method", "bgk", "--watch", str(watch), "--once", "--out", "srv",
         "--set", "max_range=8.0"], tmp_path)
    assert jrc == rc == 0
    for text in (out, jout):
        assert "Skipped a_2.pcd (motion gate)" in text
        assert text.count("One cloud finished") == 2
    cfg = load_method_config("bgk", max_range=8.0)
    ours = pipeline.build_map(cfg, "cpu")
    ours.load(pre + "_map.npz")
    ref = jbuild_map(jload_method_config("bgk", max_range=8.0))
    ref.load(jpre + "_map.npz")
    n, _ = compare_maps(ours, JaxMapAsOracle(ref), **LIMITS["bgk"])
    assert n > 500
    # the CLI's map is an in-process OnlineIntegrator's over the same files
    online = pipeline.OnlineIntegrator(pipeline.build_map(cfg, "cpu"))
    for name in ("a_1.pcd", "a_2.pcd", "a_3.pcd"):
        online.offer(*load_pcd_full(str(watch / name)))
    assert (online.n_integrated, online.n_skipped) == (2, 1)
    for k, v in online.map.pool.fields.items():
        assert torch.equal(v[:ours.pool.n_blocks], ours.pool.fields[k][:ours.pool.n_blocks])
    for suffix in ("_occupied.ply", "_map.bt"):
        assert os.path.getsize(pre + suffix) > 0


# ------------------------------------------------------------ query, raycast, frontier

def _query_numbers(text):
    """[(prob, var, state)] of query's printed lines."""
    out = []
    for line in text.splitlines():
        _, _, rest = line.partition(": prob=")
        prob, _, rest = rest.partition(" var=")
        var, _, state = rest.partition(" state=")
        out.append((float(prob), float(var), int(state)))
    return out


@pytest.mark.parametrize("method", METHODS)
def test_query_matches_jax(jax_npz, method, tmp_path):
    pts = np.random.default_rng(8).uniform(-0.2, 1.8, (24, 3))
    pts[:, 1:] -= 0.8
    pts[:4] = [[1.55, 0.05, 0.05], [0.75, 0.0, 0.0], [3.0, 3.0, 3.0], [1.45, -0.15, 0.25]]
    args = ["query", "--method", method, "--checkpoint", jax_npz[method], "--",
            *(",".join(f"{v:.3f}" for v in p) for p in pts)]
    (jrc, jout, _), (rc, out, _) = run_both(args, tmp_path)
    assert jrc == rc == 0
    ours, ref = _query_numbers(out), _query_numbers(jout)
    assert len(ours) == len(ref) == len(pts)
    lim = LIMITS[method]
    for (p, v, s), (jp, jv, js) in zip(ours, ref):
        assert abs(p - jp) <= lim["atol"] + lim["rtol"] * abs(jp) + 1e-4
        assert abs(v - jv) <= lim["atol"] + lim["rtol"] * abs(jv) + 1e-4
        assert s == js
    assert len({s for _, _, s in ours}) > 1        # more than one state queried
    # the lines are the port's search() at the parsed points
    from la3dm_tpu_torch.cli import query_lines

    m = pipeline.build_map(load_method_config(method), "cpu")
    m.load(jax_npz[method])
    parsed = np.array([[float(x) for x in a.split(",")] for a in args[6:]])
    assert out.splitlines() == query_lines(m, parsed)


@pytest.mark.parametrize("method", METHODS)
def test_raycast_matches_jax_but_at_ties(jax_npz, method, tmp_path):
    rng = np.random.default_rng(12)
    o = rng.uniform(-0.3, 0.3, (48, 3))
    t = np.column_stack([np.full(48, 3.0), rng.uniform(-1.0, 1.0, (48, 2))])
    t[::6] = o[::6] + [2.5, 0.0, 0.0]            # straight along x into the wall
    args = ["raycast", "--method", method, "--checkpoint", jax_npz[method],
            "--max-range", "4.0", "--",
            *(",".join(f"{v:.4f}" for v in np.concatenate([a, b])) for a, b in zip(o, t))]
    (jrc, jout, _), (rc, out, _) = run_both(args, tmp_path)
    assert jrc == rc == 0
    lines, jlines = out.splitlines(), jout.splitlines()
    assert len(lines) == len(jlines) == 48
    rays = np.array([[float(x) for x in a.split(",")] for a in args[8:]])
    ro, rd = rays[:, :3], rays[:, 3:6] - rays[:, :3]
    ours, ref = _maps(method, jax_npz[method])
    res = port_raycast.raycast_device(ours, ro, rd, 4.0)
    from la3dm_tpu_torch.cli import raycast_lines

    assert lines == raycast_lines(res)
    apart = np.array([i for i in range(48) if lines[i] != jlines[i]], np.int64)
    assert_ties_on_path(ours, ro.astype(np.float32), rd, res, apart)
    assert sum("hit=True" in ln for ln in lines) >= 8


@pytest.mark.parametrize("method", METHODS)
def test_frontier_matches_jax(jax_npz, method, tmp_path):
    args = ["frontier", "--method", method, "--checkpoint", jax_npz[method],
            "--z-min", "-1.0", "--z-max", "1.0", "--var-min", "1e-4", "--prob-max", "0.5",
            "--out", "frontier.csv"]
    (jrc, jout, jpath), (rc, out, path) = run_both(args, tmp_path)
    assert jrc == rc == 0
    count = json.loads(out.splitlines()[0])["frontier_voxels"]
    assert count == json.loads(jout.splitlines()[0])["frontier_voxels"] > 0
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    m, _ = _maps(method, jax_npz[method])
    f = pipeline.frontier_leaves(m, var_min=1e-4, prob_max=0.5, z_min=-1.0, z_max=1.0)
    assert len(f["x"]) == count


# ------------------------------------------------------------ eval

def _ground_truth(path):
    """The tiny scene's truth as a .bt at 0.1 m: the wall's voxels at x =
    1.55 occupied, the space before it free, a block behind it (never seen)
    occupied."""
    g = np.arange(-0.25, 0.3, 0.1)
    yz = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    cols = []
    for x, occ in [(0.05 + 0.1 * i, False) for i in range(15)] + \
            [(1.55, True), (2.05, True), (2.15, True)]:
        cols.append((np.column_stack([np.full(len(yz), x), yz]), np.full(len(yz), occ)))
    centers = np.concatenate([c for c, _ in cols])
    occupied = np.concatenate([o for _, o in cols])
    write_bt(path, np.round(centers, 2), np.full(len(centers), 0.1), occupied, 0.1)
    return len(centers)


@pytest.mark.parametrize("method", ["bgk", "bgklv"])
def test_eval_matches_jax(tmp_path, method):
    ds = tiny_scene(str(tmp_path))
    gt = str(tmp_path / "gt.bt")
    n_gt = _ground_truth(gt)
    (jrc, jout, _), (rc, out, _) = run_both(
        ["eval", "--method", method, "--dataset", ds, "--ground-truth", gt], tmp_path)
    assert jrc == rc == 0
    rep, jrep = json.loads(out.splitlines()[-1]), json.loads(jout.splitlines()[-1])
    assert list(rep) == list(jrep)
    assert rep["gt_voxels"] == n_gt and 0 < rep["coverage"] < 1
    for k in rep:
        if k == "scans_per_s":
            continue
        if isinstance(rep[k], float):
            assert abs(rep[k] - jrep[k]) <= 1e-3, k
        else:
            assert rep[k] == jrep[k], k
    assert rep["auc"] > 0.6


def test_eval_reads_map_bt_beside_the_dataset(tmp_path, capsys):
    from la3dm_tpu_torch import cli

    ds = tiny_scene(str(tmp_path))
    _ground_truth(str(tmp_path / "map.bt"))
    assert cli.main(["eval", "--method", "bgk", "--dataset", ds, "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["known"] > 0


# ------------------------------------------------------------ the single-card entry

def test_entry_step_reproduces_its_insert_and_matches_jax(monkeypatch):
    step, args = entry(device="cpu")
    out = step(*args)
    again = step(*args)                       # the step does not move its inputs
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    cfg = load_method_config("bgk", max_range=8.0, device_ingest="off")
    m = bgk.BGKOctoMap(cfg, device="cpu")
    m.insert_pointcloud(*tiny_scan(400))
    pool = (m.pool.fields["A"], m.pool.fields["B"], m.pool.touched, m.pool.eff_level)
    for a, b in zip(out, pool):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert m.pool.n_blocks > 10

    # the JAX entry on the same tiny scan (never a bundled PCD)
    def no_pcd(path):
        raise OSError(path)

    monkeypatch.setattr(jpcd, "load_pcd", no_pcd)
    np.testing.assert_array_equal(tiny_scan(400)[0], __graft_entry__._tiny_scan(400)[0])
    jstep, jargs = __graft_entry__.entry()
    jout = jstep(*jargs)
    jm = jbgk.BGKOctoMap(jload_method_config("bgk", max_range=8.0, device_ingest="off"))
    jm.insert_pointcloud(*__graft_entry__._tiny_scan(400))
    nb = jm.pool.n_blocks
    for a, b in zip(jout, (jm.pool.fields["A"], jm.pool.fields["B"], jm.pool.touched,
                           jm.pool.eff_level)):
        np.testing.assert_array_equal(np.asarray(a)[:nb], np.asarray(b)[:nb])
    n, _ = compare_maps(m, JaxMapAsOracle(jm), atol=2e-3, touched_mass_tol=1e-5)
    assert n > 500
