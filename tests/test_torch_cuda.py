"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false: a hand-written kernel has no CPU
mode.  The file imports no JAX, so on a machine with a card and without JAX
it runs apart from tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from la3dm_tpu_torch.kernels import bgk_heavy, bgk_light, lv_prune, lv_rows
from la3dm_tpu_torch.models import posterior as po

from torch_cases import (LV_ROWS_STATICS, LV_STATE, heavy_inputs,  # tests/ on sys.path
                         light_inputs, lv_prune_inputs, lv_rows_inputs)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("G", [7, 27])
def test_bgk_heavy_kernel_matches_plain(cuda_dev, G):
    a = heavy_inputs(9, G=G, n_blocks=40, dev=cuda_dev)
    before = bgk_heavy.launches
    acc = bgk_heavy.bgk_heavy(**a, G=G, sf2=1.0, ell=0.2)
    assert bgk_heavy.launches == before + 1
    ref = bgk_heavy.bgk_heavy_plain(**a, G=G, sf2=1.0, ell=0.2)
    torch.cuda.synchronize()
    assert ((acc - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all()


@pytest.mark.cuda
def test_bgk_light_kernel_matches_plain(cuda_dev):
    acc, A, B, touched, eff, node_idx, slots = light_inputs(10, dev=cuda_dev)
    kw = dict(G=7, gate=0.0, n=4, max_level=2,
              state_fn=po.BetaStateFn(100.0, 0.3, 0.7), do_prune=True)
    k = [x.clone() for x in (A, B, touched, eff)]
    p = [x.clone() for x in (A, B, touched, eff)]
    for s, c in ((0, 6), (6, 6)):
        bgk_light.bgk_light(acc, *k, node_idx, slots, s, c, **kw)
        bgk_light.bgk_light_plain(acc, *p, node_idx, slots, s, c, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
    assert (k[0] - p[0]).abs().max() <= 1e-6 and (k[1] - p[1]).abs().max() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [3, 5, 6])
def test_lv_rows_kernel_matches_plain(cuda_dev, depth):
    a = lv_rows_inputs(12, depth=depth, dev=cuda_dev)
    k = [x.clone() for x in a[:4]]
    p = [x.clone() for x in a[:4]]
    before = lv_rows.launches
    lv_rows.lv_rows(*k, *a[4:], **LV_ROWS_STATICS)
    assert lv_rows.launches == before + 1
    lv_rows.lv_rows_plain(*p, *a[4:], **LV_ROWS_STATICS)
    torch.cuda.synchronize()
    # the same sums in the same order; sinf/cosf and the plain version's
    # separate ops round alike, so 1e-5 relative covers the rest
    for x, y in zip(k[:2], p[:2]):
        assert ((x - y).abs() <= 1e-5 + 1e-5 * y.abs()).all()
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], a[3])
    assert (k[0] != a[0]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 16, 32])
def test_lv_prune_kernel_matches_plain(cuda_dev, n):
    pool = lv_prune_inputs(13, n=n, dev=cuda_dev)
    kw = dict(n=n, max_level=n.bit_length() - 1, state_fn=po.LVStateFn(**LV_STATE))
    k = [x.clone() for x in pool[:4]]
    p = [x.clone() for x in pool[:4]]
    before = lv_prune.launches
    lv_prune.lv_prune(*k, pool[4], **kw)
    assert lv_prune.launches == before + 1
    lv_prune.lv_prune_plain(*p, pool[4], **kw)
    torch.cuda.synchronize()
    # copies and f32 state rules only: bit-identical
    for x, y in zip(k, p):
        assert torch.equal(x, y)
    assert int(k[3].max()) == kw["max_level"]
