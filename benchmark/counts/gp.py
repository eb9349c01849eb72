"""Work of GP's heavy pass (K4) that a pass's data needs, from each model's
size.

A model of c points serving q query nodes: the Gram ≈ 12c², the Cholesky
factor c³/3 multiply-adds (2c³/3 operations), the two triangular solves of
the weights 2c², and per query node its kernel row 12c, v = L⁻¹k* c², the
mean and Σv² 4c (``chip_smoke.py``'s count for K4).  Every model serves one
(block, slot) row of every node at each of its G slots.  Bytes: each
model's points read once (xyz and label, float32) and each served row's
mean and variance written once.
"""

from __future__ import annotations

import numpy as np

POINT_BYTES = 4 * 4


def heavy(work: dict, nodes: int, slots: int) -> tuple[float, float]:
    """(operations, bytes) of one pass."""
    c = np.asarray(work["models"], np.float64)
    q = float(work["served"]) * nodes
    flops = float((12 * c ** 2 + 2 * c ** 3 / 3 + 2 * c ** 2 + q * (12 * c + c ** 2 + 4 * c)).sum())
    nbytes = POINT_BYTES * float(c.sum()) + 8.0 * q * c.size
    return flops, nbytes
