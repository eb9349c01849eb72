"""Work of BGK-L's heavy pass (K1′ on segments) that a pass's data needs.

Operations: every (segment, node) pair inside the sparse kernel's support —
point-to-segment distance under ℓ, where the kernel is not zero — at 85
operations an evaluation (the point distance's 9 replaced by the
point-to-segment distance's 43, the division by ℓ, cos, sin, the clamp and
two accumulations; ``bgk_heavy.FLOP_PER_EVAL_SEGMENT`` of the program).
Pairs outside the support add exact zeros, which no implementation needs
to compute.  Bytes: each (block, entry) row read once (a segment's 6 floats
and its label) and the accumulator written once (ȳ and k̄ of every node and
slot of every test block, float32).
"""

from __future__ import annotations

FLOP_PER_EVAL_SEGMENT = 85
ENTRY_BYTES = 7 * 4


def heavy(work: dict, nodes: int, slots: int) -> tuple[float, float]:
    """(operations, bytes) of one pass."""
    flops = FLOP_PER_EVAL_SEGMENT * float(work["support_pairs"])
    nbytes = ENTRY_BYTES * float(work["entries"]) + 2 * 4.0 * slots * nodes * work["test_blocks"]
    return flops, nbytes
