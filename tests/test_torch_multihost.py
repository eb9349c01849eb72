"""The port's sharded maps over two processes (``torch.distributed`` on
``gloo``), in the pattern of tests/test_multihost.py.

Two workers (tests/torch_multihost_worker.py) of two shards each run every
family on replicated ingest, the host path for all four and device ingest
for BGK, BGKL and GP, with growth, ``rebalance``, ``save`` from process 0,
``search``, ``leaves`` and a ``load`` into a fresh sharded map.  The test
holds each saved map to the port's unsharded map of the same stream bit for
bit (GP in posterior space: its CPU heavy pass rounds apart by the models a
call holds, tests/test_torch_sharded.py), the reads and the reloaded map
likewise, and the host-path maps to the JAX package's unsharded maps at the
tolerances of tests/test_torch_sharded.py.  A worker that hangs fails the
test at the ``communicate`` timeout.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from la3dm_tpu.models import bgk as jbgk, bgkl as jbgkl, bgklv as jlv, gp as jgp
from la3dm_tpu.utils.config import MapConfig as JMapConfig

from la3dm_tpu_torch.models import bgk, bgkl, bgklv, gp

import torch_multihost_worker as w
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
MASS_TOL = 1e-5
#: case → (the port's unsharded class, JAX's unsharded class or None)
REFS = {"bgk": (bgk.BGKOctoMap, jbgk.BGKOctoMap), "bgkl": (bgkl.BGKLOctoMap, jbgkl.BGKLOctoMap),
        "bgklv": (bgklv.BGKLVOctoMap, jlv.BGKLVOctoMap), "gp": (gp.GPOctoMap, jgp.GPOctoMap),
        "bgk_ingest": (bgk.BGKOctoMap, None), "bgkl_ingest": (bgkl.BGKLOctoMap, None),
        "gp_ingest": (gp.GPOctoMap, None)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gp_posterior(cfg, f):
    p = 1.0 / (1.0 + np.exp(-cfg.l * f["m_ivar"] / (1.0 / cfg.min_var)))
    return p, 1.0 / f["ivar"]


def _state(path) -> dict:
    """A checkpoint's arrays, its blocks in coordinate order."""
    with np.load(path) as data:
        coords = data["coords"]
        order = np.lexsort((coords[:, 2], coords[:, 1], coords[:, 0]))
        return {k: np.asarray(data[k])[order] for k in data.files if k != "config"}


def _assert_states(got, want, case, cfg, exact):
    np.testing.assert_array_equal(got["coords"], want["coords"], err_msg=case)
    np.testing.assert_array_equal(got["touched"], want["touched"], err_msg=case)
    np.testing.assert_array_equal(got["eff_level"], want["eff_level"], err_msg=case)
    if exact:
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{case} {k}")
        return
    p1, v1 = gp_posterior(cfg, {k[6:]: v for k, v in got.items() if k.startswith("field_")})
    p2, v2 = gp_posterior(cfg, {k[6:]: v for k, v in want.items() if k.startswith("field_")})
    np.testing.assert_allclose(p1, p2, atol=1e-3, rtol=0, err_msg=f"{case} prob")
    np.testing.assert_allclose(v1, v2, atol=1e-3, rtol=1e-3, err_msg=f"{case} var")


def _assert_near_jax(got, want, case, cfg):
    """The JAX package's tolerances of tests/test_torch_sharded.py."""
    np.testing.assert_array_equal(got["coords"], want["coords"], err_msg=case)
    if case == "gp":
        _assert_states(got, want, case, cfg, exact=False)
        return
    atol, rtol = (1e-5, 1e-5) if case == "bgklv" else (5e-3, 0.0)
    mass = np.zeros(got["touched"].shape, np.float32)
    for k, p in (("A", cfg.prior_A), ("B", cfg.prior_B)):
        a, b = got[f"field_{k}"], want[f"field_{k}"]
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=f"{case} {k}")
        mass = np.maximum(mass, np.maximum(np.abs(a - p), np.abs(b - p)))
    away = mass > MASS_TOL
    assert away.sum() > 100
    np.testing.assert_array_equal(got["touched"][away], want["touched"][away])
    np.testing.assert_array_equal(got["eff_level"][away], want["eff_level"][away])


@pytest.fixture(scope="module")
def worker_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_multihost")
    init = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, init, "2", str(rank), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (stdout, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    assert any("SAVED" in stdout for stdout, _ in outs)
    return out


@pytest.mark.parametrize("case", list(w.CASES))
def test_two_ranks_match_unsharded(case, worker_out, tmp_path):
    ucls, jcls = REFS[case]
    cfg = w.CASES[case][1]
    exact = not case.startswith("gp")
    ref = ucls(cfg, device="cpu")
    w.insert(ref)
    ref.save(str(tmp_path / "ref.npz"))
    want = _state(tmp_path / "ref.npz")
    got = _state(worker_out / f"{case}_map.npz")
    _assert_states(got, want, case, cfg, exact)
    _assert_states(_state(worker_out / f"{case}_reload.npz"), got, case, cfg, exact=True)

    with np.load(worker_out / f"{case}_reads.npz") as reads:
        found = ref.search(w.search_points())
        for k, v in found.items():
            if exact or k in ("state", "touched"):
                np.testing.assert_array_equal(reads[f"search_{k}"], v, err_msg=k)
        leaves = ref.leaves()
        oa = np.lexsort((reads["leaves_z"], reads["leaves_y"], reads["leaves_x"]))
        ob = np.lexsort((leaves["z"], leaves["y"], leaves["x"]))
        for k, v in leaves.items():
            if exact or k in ("x", "y", "z", "size"):
                np.testing.assert_array_equal(reads[f"leaves_{k}"][oa], v[ob], err_msg=k)

    if jcls is not None:
        jm = jcls(JMapConfig(**dataclasses.asdict(cfg)))
        w.insert(jm)
        jm.save(str(tmp_path / "jax.npz"))
        _assert_near_jax(got, _state(tmp_path / "jax.npz"), case, cfg)
