"""Batched Gaussian-process regression for GPOctoMap, as plain torch.

The port of ``la3dm_tpu/kernels/gp.py``.  The reference runs one exact GP
per block: a Matérn-3/2 Gram matrix and its LLᵀ Cholesky factor at train
time (``gpregressor.h:42-51``), a triangular solve and the variance at
predict time (``gpregressor.h:80-92``).  Here the blocks are padded to a
common point count S and solved as one batch, with the padding points at a
far coordinate, so that their kernel rows vanish and the padded system is
block-diagonal.

These are the plain versions the CPU runs and the card's K4/K5 kernels are
held against (``kernels/gp_heavy.py``, ``kernels/gp_light.py``).  The factor
and the solves use ``torch.linalg``; as in JAX, only the lower triangle of
the Gram is read, and a Gram that is not positive definite gives a factor
that is NaN over its whole lower triangle (JAX's Cholesky does so, while
``cholesky_ex`` returns a partial factor and ``info > 0``).
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import math as km

PAD_COORD = 1.0e6  # far enough that Matérn(d) underflows to exactly 0


def _f32(x: float) -> float:
    return float(np.float32(x))


def pad_points(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Move padded rows to a far coordinate staggered per row.

    Staggering (PAD_COORD · (1 + row/S)) keeps padded points apart from each
    other, so the padded diagonal block of the Gram matrix is (sf2+noise)·I —
    strictly PD, with zero coupling to real points.
    """
    S = points.shape[-2]
    stagger = PAD_COORD * (1.0 + torch.arange(S, dtype=torch.float32,
                                              device=points.device) / S)
    far = torch.stack([stagger, stagger, stagger], dim=-1)
    return torch.where(valid[..., None], points, far)


def gp_train_core(points: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                  sf2: float, ell: float, noise: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched GP training (gpregressor.h:42-51).

    Args:
      points: [B,S,3] training points (padded).
      labels: [B,S] targets (+1 occupied / −1 free), zero on padding.
      valid:  [B,S] padding mask.
    Returns:
      L:     [B,S,S] Cholesky factors of K + noise·I (NaN lower triangle
             where K + noise·I is not positive definite).
      alpha: [B,S]   K⁻¹y (zero on padded rows).
    """
    pts = pad_points(points, valid)
    y = torch.where(valid, labels, 0.0)
    S = pts.shape[-2]
    eye = torch.eye(S, dtype=torch.float32, device=pts.device)
    K = km.cov_matern32(pts, pts, sf2, ell) + _f32(noise) * eye
    L, info = torch.linalg.cholesky_ex(K)
    nan_lower = torch.full_like(eye, float("nan")).tril()
    L = torch.where((info > 0)[..., None, None], nan_lower, L)
    z = torch.linalg.solve_triangular(L, y[..., None], upper=False)
    a = torch.linalg.solve_triangular(L.mT, z, upper=True)
    return L, a[..., 0]


def gp_predict_core(L: torch.Tensor, alpha: torch.Tensor, points: torch.Tensor,
                    valid: torch.Tensor, xs: torch.Tensor, sf2: float,
                    ell: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched GP prediction (gpregressor.h:80-92).

    Args:
      L, alpha: training results for B models.
      points:   [B,S,3] the models' training points (padded).
      valid:    [B,S].
      xs:       [B,M,3] test points per model.
    Returns:
      mean [B,M], var [B,M] with var = sf2 − Σ v², v = L⁻¹ Ks.
    """
    pts = pad_points(points, valid)
    Ks = km.cov_matern32(pts, xs, sf2, ell)                     # [B,S,M]
    mean = torch.matmul(Ks.mT, alpha[..., None])[..., 0]
    v = torch.linalg.solve_triangular(L, Ks, upper=False)
    var = _f32(sf2) - torch.sum(v * v, dim=-2)
    return mean, var


def bcm_update_sequential(m_ivar: torch.Tensor, ivar: torch.Tensor,
                          means: torch.Tensor, variances: torch.Tensor,
                          present: torch.Tensor, sf2: float, min_known_ivar: float,
                          max_ivar: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential BCM fusion over neighbour slots with the reference's ivar
    chop.

    ``Occupancy::update`` (gpoctree_node.cpp:36-49) does ``ivar += 1/var −
    sf2; m_ivar += m/var`` and then *persistently* clamps ivar to max_ivar
    whenever ivar ≥ min_known_ivar — order-dependent, so the G neighbour
    models are applied one by one in ExtendedBlock (slot) order.

    Args:
      m_ivar, ivar: [...] current state.
      means, variances: [..., G] per-slot predictions.
      present: [..., G] bool, the slot has a trained model.
    """
    sf2, mk, mx = _f32(sf2), _f32(min_known_ivar), _f32(max_ivar)
    mi, iv = m_ivar, ivar
    for g in range(means.shape[-1]):
        m, var, ok = means[..., g], variances[..., g], present[..., g]
        iv_new = iv + 1.0 / var - sf2
        mi_new = mi + m / var
        iv_new = torch.where(iv_new >= mk, torch.clamp_max(iv_new, mx), iv_new)
        mi = torch.where(ok, mi_new, mi)
        iv = torch.where(ok, iv_new, iv)
    return mi, iv
