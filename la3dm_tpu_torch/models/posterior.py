"""Posterior accessors on torch tensors (BGK, BGKLV and GP families).

The port of ``la3dm_tpu/models/posterior.py``:

* BGK (``bgkoctree_node.cpp:27-44``): p = A/(A+B); var = AB/((A+B)²(A+B+1));
  state by var_thresh then the p-thresholds.
* BGKLV (``bgklvoctree_node.cpp:29-77``): evidence-mass probability with an
  explicit unknown mass W, Brier-style variance, and UNCERTAIN in place of
  UNKNOWN in the var_thresh branch.
* GP (``gpoctree_node.cpp:31-49``): logistic squashing of the BCM mean
  p = 1/(1 + exp(−l·m_ivar/max_ivar)), UNKNOWN below min_known_ivar.

UNKNOWN where untouched.  States are int8 in the reference enum order
(FREE=0, OCCUPIED=1, UNKNOWN=2, UNCERTAIN=3).  Thresholds are compared in
float32, as the JAX package and the CUDA kernels (csrc/bgk_light.cu,
csrc/lv_prune.cu, csrc/gp_light.cu) compare them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FREE = 0
OCCUPIED = 1
UNKNOWN = 2
UNCERTAIN = 3


def _f32(x: float) -> float:
    """A threshold rounded to float32 (exactly representable as a float)."""
    return float(np.float32(x))


def _classify(prob, var, var_thresh, free_thresh, occupied_thresh,
              unknown_code=UNKNOWN):
    """Shared threshold logic (bgkoctree_node.cpp:36-43); ``unknown_code``
    is the state of the var-threshold branch (UNCERTAIN for LV)."""
    by_p = torch.where(prob > _f32(occupied_thresh), OCCUPIED,
                       torch.where(prob < _f32(free_thresh), FREE, UNKNOWN))
    return torch.where(var > _f32(var_thresh), unknown_code, by_p).to(torch.int8)


def beta_prob(A, B):
    return A / (A + B)


def beta_var(A, B):
    s = A + B
    return (A * B) / (s * s * (s + 1.0))


def beta_state(A, B, touched, var_thresh, free_thresh, occupied_thresh):
    st = _classify(beta_prob(A, B), beta_var(A, B), var_thresh, free_thresh,
                   occupied_thresh)
    return torch.where(touched, st, UNKNOWN)


@dataclasses.dataclass(frozen=True)
class BetaStateFn:
    """values-dict → int8 state; the thresholds are also handed to the CUDA
    light-pass kernel, which evaluates the same rules."""

    var_thresh: float
    free_thresh: float
    occupied_thresh: float

    def __call__(self, v):
        return beta_state(v["A"], v["B"], v["touched"] > 0,
                          self.var_thresh, self.free_thresh, self.occupied_thresh)


def lv_prob(A, B, min_W):
    W = torch.clamp_min(A + B, _f32(min_W))
    occ = A / (W - B) + (W - A - B) * 0.5 / (W - B)
    free = 0.5 * (W - B - A) / (W - A)
    return torch.where(A > B, occ, free)


def lv_var(A, B, min_W):
    p = lv_prob(A, B, min_W)
    W = torch.clamp_min(A + B, _f32(min_W))
    q = 1.0 - p
    h = 0.5 - p
    return (A / W) * (q * q) + ((W - A - B) / W) * (h * h) + (B / W) * (p * p)


def lv_state(A, B, touched, min_W, var_thresh, free_thresh, occupied_thresh):
    st = _classify(lv_prob(A, B, min_W), lv_var(A, B, min_W), var_thresh,
                   free_thresh, occupied_thresh, unknown_code=UNCERTAIN)
    return torch.where(touched, st, UNKNOWN)


@dataclasses.dataclass(frozen=True)
class LVStateFn:
    """values-dict → int8 LV state; the parameters are also handed to the
    CUDA prune kernel (csrc/lv_prune.cu), which evaluates the same rules."""

    min_W: float
    var_thresh: float
    free_thresh: float
    occupied_thresh: float

    def __call__(self, v):
        return lv_state(v["A"], v["B"], v["touched"] > 0, self.min_W,
                        self.var_thresh, self.free_thresh, self.occupied_thresh)


def gp_prob(m_ivar, l, max_ivar):
    return 1.0 / (1.0 + torch.exp(-_f32(l) * m_ivar / _f32(max_ivar)))


def gp_state(m_ivar, ivar, touched, l, max_ivar, min_known_ivar, free_thresh,
             occupied_thresh):
    p = gp_prob(m_ivar, l, max_ivar)
    by_p = torch.where(p > _f32(occupied_thresh), OCCUPIED,
                       torch.where(p < _f32(free_thresh), FREE, UNKNOWN))
    st = torch.where(ivar < _f32(min_known_ivar), UNKNOWN, by_p).to(torch.int8)
    return torch.where(touched, st, UNKNOWN)


@dataclasses.dataclass(frozen=True)
class GPStateFn:
    """values-dict → int8 GP state; the parameters are also handed to the
    CUDA light-pass kernel (csrc/gp_light.cu), which evaluates the same
    rules."""

    l: float
    max_ivar: float
    min_known_ivar: float
    free_thresh: float
    occupied_thresh: float

    def __call__(self, v):
        return gp_state(v["m_ivar"], v["ivar"], v["touched"] > 0, self.l,
                        self.max_ivar, self.min_known_ivar, self.free_thresh,
                        self.occupied_thresh)
