"""Sparse covariance kernel and distances, as plain torch.

The port of ``pairwise_dist``, ``sparse_kernel`` and ``cov_sparse`` from
``la3dm_tpu/kernels/math.py``, with the same parity rules — the k̄ > 0
update gate sits on the kernel's clamp boundary, where the last ulp decides:

* distances by per-axis direct subtraction, summed x, y, z in that order
  (no Gram expansion, no matmul);
* each operand divided by ℓ (no reciprocal multiply);
* ``TWO_PI = float32(2·3.1415926)`` as the reference's 3.1415926f.

Reference formula (``bgkinference.h:113-126``):
``sf2·[(2+cos 2πr)(1−r)/3 + sin(2πr)/2π]`` with r = d/ℓ, negatives clamped
to 0.  The CUDA heavy-pass kernel (csrc/bgk_heavy.cu) evaluates the same
expression in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = float(np.float32(2.0 * 3.1415926))  # reference uses 3.1415926f


def pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [..., M, N] between a [..., M, 3] and b [..., N, 3]
    by direct per-axis subtraction (``bgkinference.h:88-93``)."""
    d2 = None
    for ax in range(a.shape[-1]):
        diff = a[..., :, None, ax] - b[..., None, :, ax]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return torch.sqrt(d2)


def sparse_kernel(r: torch.Tensor, sf2: float) -> torch.Tensor:
    """Sparse kernel on normalised distance r = d/ℓ, negatives clamped to 0."""
    k = ((2.0 + torch.cos(TWO_PI * r)) * (1.0 - r) / 3.0
         + torch.sin(TWO_PI * r) / TWO_PI) * float(np.float32(sf2))
    return torch.clamp_min(k, 0.0)


def cov_sparse(x: torch.Tensor, z: torch.Tensor, sf2: float, ell: float) -> torch.Tensor:
    """covSparse (bgkinference.h:113-126): sparse kernel of dist(x/ℓ, z/ℓ).

    Division (not reciprocal multiply): the k̄ > 0 update gate is sensitive
    to the last ulp at the kernel's support boundary.
    """
    e = float(np.float32(ell))
    return sparse_kernel(pairwise_dist(x / e, z / e), sf2)
