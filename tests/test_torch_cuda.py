"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false: a hand-written kernel has no CPU
mode.  The file imports no JAX, so on a machine with a card and without JAX
it runs apart from tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from la3dm_tpu_torch.kernels import bgk_heavy, bgk_light
from la3dm_tpu_torch.models import posterior as po

from torch_cases import heavy_inputs, light_inputs  # tests/ is on sys.path


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
