"""BGK predict building blocks as plain torch: slot-grouped RHS + gated
Beta update (the port of ``la3dm_tpu/kernels/predict.py``).

The reference evaluates, per (test block, neighbor block) pair, a dense
kernel matrix followed by ``ȳ = K·y`` and ``k̄ = rowsum(K)``
(``bgkinference.h:73-79``).  The heavy pass folds the (ȳ, k̄) matvec into
one contraction with the [W, 2G] right-hand side built here (G = neighbor
slots, for per-neighbor k̄ gating); the light pass applies
:func:`beta_update` per scan.
"""

from __future__ import annotations

import torch


def _slot_rhs(labels: torch.Tensor, slots: torch.Tensor, valid: torch.Tensor,
              num_slots: int) -> torch.Tensor:
    """Build the [..., S, 2·G] RHS: columns (y·1[slot=g], 1[slot=g]) per g."""
    g = torch.arange(num_slots, device=slots.device)
    onehot = (slots[..., None].long() == g) & valid[..., None]
    onehot = onehot.to(torch.float32)
    return torch.cat([labels[..., None] * onehot, onehot], dim=-1)


def beta_update(ybar: torch.Tensor, kbar: torch.Tensor, gate: float):
    """Gated conjugate Beta update deltas from per-slot densities.

    The reference applies ``m_A += ȳ; m_B += k̄ − ȳ`` per neighbor model
    only when that model's k̄ exceeds the gate (``> 0`` for BGK,
    bgkoctomap.cpp:332).  Slots are summed one by one in slot order — the
    order the CUDA light-pass kernel sums them, so the two agree bit for
    bit on identical inputs.

    Args: ybar, kbar [..., G].  Returns dA, dB, touched with the slot axis
    reduced.
    """
    dA = torch.zeros(ybar.shape[:-1], dtype=ybar.dtype, device=ybar.device)
    dB = torch.zeros_like(dA)
    tch = torch.zeros(ybar.shape[:-1], dtype=torch.bool, device=ybar.device)
    for g in range(ybar.shape[-1]):
        on = kbar[..., g] > gate
        yb = ybar[..., g]
        dA = dA + torch.where(on, yb, 0.0)
        dB = dB + torch.where(on, kbar[..., g] - yb, 0.0)
        tch = tch | on
    return dA, dB, tch
