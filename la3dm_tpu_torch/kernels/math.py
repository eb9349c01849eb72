"""Covariance kernels and distances, as plain torch.

The port of ``pairwise_dist``, ``sparse_kernel``, ``cov_sparse``,
``matern32``, ``cov_matern32``, ``sparse_kernel_lv``,
``point_to_segment_dist`` and ``cov_sparse_segment`` from
``la3dm_tpu/kernels/math.py``, with the same parity rules — the k̄
update gates sit on the kernel's support boundary, where the last ulp
decides:

* distances by per-axis direct subtraction, summed x, y, z in that order
  (no Gram expansion, no matmul);
* each operand divided by ℓ (no reciprocal multiply);
* ``TWO_PI = float32(2·3.1415926)`` as the reference's 3.1415926f;
* a division by a constant divides by a 0-dim tensor on the operand's
  device (:func:`div`): PyTorch's CUDA division by a Python number
  multiplies by its reciprocal, which the kernels do not.

Reference formula (``bgkinference.h:113-126``):
``sf2·[(2+cos 2πr)(1−r)/3 + sin(2πr)/2π]`` with r = d/ℓ, negatives clamped
to 0.  The CUDA heavy-pass kernel (csrc/bgk_heavy.cu) evaluates the same
expression in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI = float(np.float32(2.0 * 3.1415926))  # reference uses 3.1415926f
SQRT3 = float(np.float32(1.73205))           # reference uses 1.73205f
#: degenerate-segment threshold of point_to_segment_dist (bgklinference.h)
SEG_EPSILON = float(np.float32(1e-4))


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division in x's dtype on every device (a Python
    divisor would become a reciprocal multiply on CUDA)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


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
    k = (div((2.0 + torch.cos(TWO_PI * r)) * (1.0 - r), 3.0)
         + div(torch.sin(TWO_PI * r), TWO_PI)) * float(np.float32(sf2))
    return torch.clamp_min(k, 0.0)


def cov_sparse(x: torch.Tensor, z: torch.Tensor, sf2: float, ell: float) -> torch.Tensor:
    """covSparse (bgkinference.h:113-126): sparse kernel of dist(x/ℓ, z/ℓ).

    Division (not reciprocal multiply): the k̄ > 0 update gate is sensitive
    to the last ulp at the kernel's support boundary.
    """
    e = float(np.float32(ell))
    return sparse_kernel(pairwise_dist(div(x, e), div(z, e)), sf2)


def matern32(d: torch.Tensor, sf2: float, ell: float) -> torch.Tensor:
    """Matérn-3/2 on raw distance d, the √3/ℓ scale applied inside
    (``gpregressor.h:114-117``)."""
    s = float(np.float32(SQRT3) / np.float32(ell)) * d
    return (1.0 + s) * torch.exp(-s) * float(np.float32(sf2))


def cov_matern32(x: torch.Tensor, z: torch.Tensor, sf2: float, ell: float) -> torch.Tensor:
    """covMaterniso3 (gpregressor.h:114-117): ``(1 + d)·exp(−d)·sf2`` with
    d the distance between x·s and z·s.  The scale s = 1.73205/ℓ is taken in
    double and rounded to float32 (the reference's ``1.73205 / ell``
    promotes to double), and both operands are scaled before the per-axis
    subtraction — not (x − z)·s."""
    s = float(np.float32(1.73205 / float(ell)))
    d = pairwise_dist(x * s, z * s)
    return (1.0 + d) * torch.exp(-d) * float(np.float32(sf2))


def sparse_kernel_lv(r: torch.Tensor, sf2: float) -> torch.Tensor:
    """LV sparse kernel (bgklvinference.h:143-157): r clamped to ≤ 1 before
    the kernel, no output clamp."""
    r = torch.clamp_max(r, 1.0)
    return (div((2.0 + torch.cos(TWO_PI * r)) * (1.0 - r), 3.0)
            + div(torch.sin(TWO_PI * r), TWO_PI)) * float(np.float32(sf2))


def _sq3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x² + y² + z², summed in that order."""
    return x * x + y * y + z * z


def point_to_segment_dist(p: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Distances [..., M, N] from points p [..., M, 3] to segments
    seg [..., N, 6] (start, end), branch structure of bgklinference.h:106-141:

      |p1 − p0| < ε        → |p − p0|
      c1 = (p−p0)·u ≤ 0    → |p − p0|
      c2 = u·u ≤ c1        → |p − p1|
      else                 → |p − (p0 + u·c1/c2)|

    All in float32 with per-axis sums in x, y, z order and c2 floored at
    1e-30, as the JAX package computes it (its docstring's float64 is not
    what its code does).
    """
    p0, p1 = seg[..., None, :, 0:3], seg[..., None, :, 3:6]   # [..., 1, N, 3]
    u = p1 - p0
    line_len = torch.sqrt(_sq3(u[..., 0], u[..., 1], u[..., 2]))
    pp = p[..., :, None, :]                                   # [..., M, 1, 3]
    diff0 = pp - p0
    diff1 = pp - p1
    d0 = torch.sqrt(_sq3(diff0[..., 0], diff0[..., 1], diff0[..., 2]))
    d1 = torch.sqrt(_sq3(diff1[..., 0], diff1[..., 1], diff1[..., 2]))
    c1 = diff0[..., 0] * u[..., 0] + diff0[..., 1] * u[..., 1] + diff0[..., 2] * u[..., 2]
    c2 = _sq3(u[..., 0], u[..., 1], u[..., 2])
    b = c1 / torch.clamp_min(c2, 1e-30)
    dm = pp - (p0 + u * b[..., None])
    dmid = torch.sqrt(_sq3(dm[..., 0], dm[..., 1], dm[..., 2]))
    d = torch.where(c1 <= 0.0, d0, torch.where(c2 <= c1, d1, dmid))
    return torch.where(line_len < SEG_EPSILON, d0, d)


def cov_sparse_segment(p: torch.Tensor, seg: torch.Tensor, sf2: float, ell: float,
                       lv: bool = False) -> torch.Tensor:
    """covSparseLine: the sparse kernel of point-to-segment distance / ℓ.

    ``lv=False``: BGKL semantics (negative outputs clamped,
    bgklinference.h:183-197); ``lv=True``: LV semantics (r clamped ≤ 1
    first, bgklvinference.h:143-157).
    """
    r = div(point_to_segment_dist(p, seg), float(np.float32(ell)))
    return sparse_kernel_lv(r, sf2) if lv else sparse_kernel(r, sf2)


# ---------------------------------------------------------- warp culling

#: relative margin of the culling box (csrc/cull.cuh::kCullMargin)
CULL_MARGIN = float(np.float32(1e-4))
#: operations of the cull test of one (warp, entry) pair: u = b − a (3);
#: per axis two differences, two divisions, min, max and the clip of
#: t_in / t_out (8); the final comparison (1)
FLOP_CULL_TEST = 28
#: ... and of a point entry: two comparisons per axis
FLOP_CULL_TEST_POINT = 6


def pad_box(lo: torch.Tensor, hi: torch.Tensor, reach: float):
    """The box [lo, hi] ([..., 3] f32) padded by ``reach`` and the margin
    1e-4·(1 + |x|) per axis, as ``csrc/cull.cuh::pad_box``."""
    pad = float(np.float32(reach)) + CULL_MARGIN * (1.0 + torch.maximum(lo.abs(), hi.abs()))
    return lo - pad, hi + pad


def warp_box(points: torch.Tensor, live: torch.Tensor, reach: float):
    """Each warp's padded box, as ``csrc/cull.cuh::warp_box``: points
    [..., 32, 3] of one warp's lanes, live [..., 32] bool; returns (plo, phi)
    [..., 3] over the live lanes."""
    inf = float("inf")
    lo = torch.where(live[..., None], points, inf).amin(-2)
    hi = torch.where(live[..., None], points, -inf).amax(-2)
    return pad_box(lo, hi, reach)


def segment_misses_box(a: torch.Tensor, u: torch.Tensor, plo: torch.Tensor,
                       phi: torch.Tensor) -> torch.Tensor:
    """[...] bool: does the segment a → a + u (t ∈ [0, 1]) miss the box
    [plo, phi]?  Liang–Barsky clipping in f32, an axis with u == 0 testing a
    alone, as ``csrc/cull.cuh::segment_misses_box``; every argument [..., 3],
    broadcast."""
    shape = torch.broadcast_shapes(a.shape, u.shape, plo.shape, phi.shape)[:-1]
    t_in = torch.zeros(shape, dtype=a.dtype, device=a.device)
    t_out = torch.ones(shape, dtype=a.dtype, device=a.device)
    miss = torch.zeros(shape, dtype=torch.bool, device=a.device)
    for ax in range(3):
        a_, u_, lo, hi = a[..., ax], u[..., ax], plo[..., ax], phi[..., ax]
        zero = u_ == 0.0
        safe = torch.where(zero, 1.0, u_)
        t0 = (lo - a_) / safe
        t1 = (hi - a_) / safe
        t_in = torch.where(zero, t_in, torch.maximum(t_in, torch.minimum(t0, t1)))
        t_out = torch.where(zero, t_out, torch.minimum(t_out, torch.maximum(t0, t1)))
        miss = miss | (zero & ~((a_ >= lo) & (a_ <= hi)))
    return miss | (t_in > t_out)


def warp_cull(warp_points, live: torch.Tensor, reach: float, entries: torch.Tensor,
              ids: torch.Tensor, row_start: torch.Tensor, row_count: torch.Tensor, *,
              row_w: int, chunk: int) -> torch.Tensor:
    """A warp-culling kernel's predicate over entry rows: [R, warps, row_w]
    bool over (row, warp, entry), True where the segment entries[ids[row_start
    + j]] ([E, 6], start and end; or a point, [E, 3]: a segment with u = 0)
    misses the warp's box padded by ``reach`` (:func:`warp_box`,
    :func:`segment_misses_box`), False for padding entries (j ≥ row_count).
    ``warp_points(c0, c1)`` gives rows c0 .. c1's points [c1 − c0, warps, 32,
    3]; ``live`` [warps, 32] marks the real lanes.  Rows go ``chunk`` at a
    time."""
    R, F = row_start.shape[0], ids.shape[0]
    out = torch.zeros((R, live.shape[0], row_w), dtype=torch.bool, device=entries.device)
    if F == 0 or R == 0:
        return out
    wcol = torch.arange(row_w, device=entries.device)
    for c0 in range(0, R, chunk):
        c1 = min(R, c0 + chunk)
        plo, phi = warp_box(warp_points(c0, c1), live, reach)             # [c,warps,3]
        fidx = torch.clamp_max(row_start[c0:c1].long()[:, None] + wcol, F - 1)
        valid = wcol < row_count[c0:c1].long()[:, None]                   # [c,W]
        seg = entries[ids[fidx].long()]                                   # [c,W,D]
        a = seg[..., 0:3]
        u = seg[..., 3:6] - a if seg.shape[-1] == 6 else torch.zeros_like(a)
        miss = segment_misses_box(a[:, None], u[:, None], plo[:, :, None],
                                  phi[:, :, None])                        # [c,warps,W]
        out[c0:c1] = miss & valid[:, None, :]
    return out
