"""The port with ``predict: true`` — the 27-block neighbourhood, G = 27 —
against the JAX package on the CPU, in the pattern of
tests/test_predict_mode.py: BGK on host ingest and on device ingest, BGKL,
and GP, on 2–3 seeded scans of tests/test_bgk_vs_oracle.py's walls.

Tolerances are those of each family's own port tests: A/B within 5e-3 for
BGK and BGKL on host ingest (several scans with pruning,
tests/test_torch_bgk.py and tests/test_torch_bgkl.py), within 1e-5 +
1e-5·|JAX| for BGK on device ingest (tests/test_torch_ingest.py), with
touched and eff equal wherever a voxel's added mass exceeds 1e-5; GP's
m_ivar/ivar within 2e-2 + 2e-3·|JAX|, touched equal everywhere and state and
eff equal away from the thresholds (tests/test_torch_gp.py).  JAX gets
copies of every array.
"""

import dataclasses

import jax
import numpy as np
import pytest

from la3dm_tpu.models import bgk as jbgk, bgkl as jbgkl, gp as jgp

from la3dm_tpu_torch.models import bgk, bgkl, gp
from la3dm_tpu_torch.utils.config import MapConfig

from tests.test_bgk_vs_oracle import CFG, synthetic_scan
from tests.test_families_vs_oracle import BGKL_CFG, GP_CFG
from tests.test_torch_bgk import assert_same_map
from tests.test_torch_bgkl import assert_same_map as assert_same_bgkl_map
from tests.test_torch_gp import _seed_jax_pads, assert_matches_jax
from tests.test_torch_ingest import assert_bgk_matches
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

MAX_RANGE = 6.0


def _scans(seed, k, n):
    rng = np.random.default_rng(seed)
    return [synthetic_scan(rng, n=n, origin=(0.1 + 0.3 * i, -0.2, 0.3)) for i in range(k)]


def _both(jcls, cls, cfg, scans):
    """A JAX map and a port map (CPU) of ``cfg`` with ``predict: true``, the
    scans inserted into each as one sequence."""
    cfg = dataclasses.replace(cfg, predict=True)
    jm, ours = jcls(cfg), cls(MapConfig(**dataclasses.asdict(cfg)), device="cpu")
    assert jm.num_slots == ours.num_slots == 27
    jm.insert_pointclouds([c.copy() for c, _ in scans], [o.copy() for _, o in scans],
                          max_range=MAX_RANGE)
    jax.block_until_ready(list(jm.pool.fields.values()))
    ours.insert_pointclouds([c for c, _ in scans], [o for _, o in scans], max_range=MAX_RANGE)
    return jm, ours


@pytest.mark.parametrize("ingest", ["off", "on"])
def test_bgk_predict27_matches_jax(ingest):
    jm, ours = _both(jbgk.BGKOctoMap, bgk.BGKOctoMap,
                     dataclasses.replace(CFG, device_ingest=ingest), _scans(3, 3, 80))
    assert ours.stats["ingest_host_chunks"] == 0
    assert ours._ingest_enabled() == (ingest == "on")
    if ingest == "on":
        assert_bgk_matches(ours, jm)
    else:
        assert_same_map(ours, jm, atol=5e-3)


def test_bgkl_predict27_matches_jax():
    jm, ours = _both(jbgkl.BGKLOctoMap, bgkl.BGKLOctoMap, BGKL_CFG, _scans(4, 2, 60))
    assert_same_bgkl_map(ours, jm, atol=5e-3)


def test_gp_predict27_matches_jax():
    _seed_jax_pads(dataclasses.replace(GP_CFG, predict=True))
    jm, ours = _both(jgp.GPOctoMap, gp.GPOctoMap, GP_CFG, _scans(5, 2, 60))
    assert int(ours.failed_models) == 0
    assert_matches_jax(ours, jm)
