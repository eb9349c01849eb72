"""Shared inputs of the command-line tests (``tests/test_torch_cli*.py``):
the tiny scene of ``tests/test_aux.py::test_cli_static_end_to_end`` (two
120-point walls at x = 1.5 seen from the origin, a dataset YAML beside the
PCDs), both packages' CLIs run in-process on it, and a JAX map presented
as an oracle so that ``tests/test_bgk_vs_oracle.py::compare_maps`` holds
the port's map to it.

Family limits (those of the port's CPU tests against JAX): BGK and BGKL on
the host path A/B within 5e-3, touched equal where the added mass exceeds
1e-5 (``tests/test_torch_bgk.py``, ``tests/test_torch_bgkl.py``); BGKLV
within 1e-5 + 1e-5·|JAX| (``tests/test_torch_bgklv.py``); GP m_ivar/ivar
within 2e-2 + 2e-3·|JAX| (``tests/test_torch_gp.py``).
"""

import contextlib
import io
import os
import types

import numpy as np

from la3dm_tpu import cli as jcli, pipeline as jpipe
from la3dm_tpu.models import bgklv as jlv, gp as jgp
from la3dm_tpu.utils.config import DatasetConfig as JDatasetConfig
from la3dm_tpu.utils.config import load_method_config as jload_method_config

from la3dm_tpu_torch import cli
from la3dm_tpu_torch.io.pcd import save_pcd

METHODS = ("bgk", "bgkl", "bgklv", "gp")
#: compare_maps keywords a family (atol, rtol, touched_mass_tol)
LIMITS = {"bgk": dict(atol=5e-3, rtol=0.0, touched_mass_tol=1e-5),
          "bgkl": dict(atol=5e-3, rtol=0.0, touched_mass_tol=1e-5),
          "bgklv": dict(atol=1e-5, rtol=1e-5, touched_mass_tol=1e-5),
          "gp": dict(atol=2e-2, rtol=2e-3, touched_mass_tol=1e-5)}


def seed_jax_pads():
    """One padded shape per JAX engine for the YAML configs the CLI loads
    (as tests/test_torch_bgklv.py and tests/test_torch_gp.py seed theirs)."""
    lv = {"E": 8192, "F": 65536, "R": 2048, "T": 2048}
    for single in (True, False):
        jlv._GLOBAL_PADS.setdefault(("BGKLVOctoMap", jload_method_config("bgklv"), single),
                                    dict(lv))
    jgp._GLOBAL_PADS.setdefault(
        ("GPOctoMap", jload_method_config("gp")),
        {"N": 8192, "T": 2048, "B": 1024, "tiers": {128: {"M": 512}, 256: {"M": 64},
                                                    512: {"M": 64}}})


seed_jax_pads()


def tiny_scene(directory, n_scans=2, seed=7) -> str:
    """Write the scans and their dataset YAML; returns the YAML's path."""
    rng = np.random.default_rng(seed)
    for i in range(1, n_scans + 1):
        yz = rng.uniform(-0.3, 0.3, size=(120, 2)).astype(np.float32)
        wall = np.column_stack([np.full(len(yz), 1.5, np.float32), yz])
        save_pcd(os.path.join(directory, f"scan_{i}.pcd"), wall, origin=(0, 0, 0))
    path = os.path.join(directory, "tiny.yaml")
    with open(path, "w") as f:
        f.write(f"name: tiny\ndir: {directory}\nprefix: scan\nscan_num: {n_scans}\n"
                "max_range: 5.0\nmin_z: -0.5\nmax_z: 0.5\n")
    return path


def run_both(argv, tmp_path, tag=""):
    """Run ``argv`` through the JAX CLI and the port's (``--device cpu``),
    each ``--out`` given a directory of its own under ``tmp_path``; returns
    ((rc, stdout, out prefix) of JAX, of the port)."""
    res = []
    for name, main, extra in (("jax", jcli.main, []), ("torch", cli.main, ["--device", "cpu"])):
        args = list(argv)
        out = str(tmp_path / f"{name}{tag}" / "map")
        if "--out" in args:
            i = args.index("--out") + 1
            out = str(tmp_path / f"{name}{tag}" / args[i])
            os.makedirs(os.path.dirname(out), exist_ok=True)
            args[i] = out
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(args[:1] + extra + args[1:])
        res.append((rc, buf.getvalue(), out))
    return res


class JaxMapAsOracle:
    """A map of either package as the oracle side of ``compare_maps``:
    every base voxel of every block, its two fields as ``value`` and its
    touched flag as ``classified``."""

    def __init__(self, m):
        self.m = m

    def base_voxel_dict(self):
        m = self.m
        nb = m.pool.n_blocks
        rows = np.arange(nb)
        f0, f1 = (np.asarray(m._gather_rows(v, rows)) for v in m.pool.fields.values())
        touched = np.asarray(m._gather_rows(m.pool.touched, rows))
        out = {}
        for s, c in enumerate(m.pool.coords[:nb]):
            bc = tuple(int(x) for x in c)
            for v in range(f0.shape[1]):
                out[(bc, v)] = types.SimpleNamespace(
                    value=np.array([f0[s, v], f1[s, v]], np.float32),
                    classified=bool(touched[s, v]))
        return out


def jax_checkpoints(directory, methods=METHODS, n_scans=3) -> dict:
    """One JAX checkpoint a family under ``directory``: the JAX
    ``run_static`` of the tiny scene (``n_scans`` scans)."""
    tiny_scene(str(directory), n_scans=n_scans)
    out = {}
    for method in methods:
        ds = JDatasetConfig(name="tiny", dir=str(directory), prefix="scan",
                            scan_num=n_scans, max_range=5.0)
        res = jpipe.run_static(jload_method_config(method), ds)
        out[method] = os.path.join(str(directory), f"{method}.npz")
        res.map.save(out[method])
    return out
