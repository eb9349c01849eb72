"""K5 — the GP light pass (BCM fusion) with the prune: wrapper, plain
version and launch counter.

Replaces ``la3dm_tpu/models/gp.py::_gp_light`` (lines 128-187, with
``kernels/gp.py::bcm_update_sequential``, ``models/pruning.py::prune_blocks``
and ``posterior.GPStateFn``) for one scan: each voxel reads the G slots'
(mean, var) at its eff-level node, applies the sequential BCM with the
persistent ivar chop over the slots that hold a model, ORs ``touched``, and
the scan's blocks are pruned bottom-up.  The pool tensors are updated in
place.

On a CUDA tensor :func:`gp_light` launches the hand-written kernel
(``csrc/gp_light.cu``: up to 8³ voxels a block, a thread a voxel and one
block a CTA, or eight blocks of 2³ a CTA; above, one CTA per 8³ tile, two
voxels a thread at G = 7, with the scratch of ``group_prune.tile_scratch``; the
present slots' (mean, var) loads issued before the BCM fold; the prune of
``csrc/group_prune.cuh``, votes over a Morton order); on a CPU tensor it
runs :func:`gp_light_plain`.  The kernel is bound by memory: it moves each
selected prediction and pool byte once.
"""

from __future__ import annotations

import torch

from la3dm_tpu_torch.kernels import _build, bgk_light, gp as kgp, group_prune
from la3dm_tpu_torch.models import pruning

#: kernel launches since the counter was last reset (one per scan)
launches = 0
#: slots a block the kernel takes (G: the face neighbours, or all 27 with
#: ``predict``)
SLOT_COUNTS = (7, 27)


def gp_light(acc_mean, acc_var, present, m_ivar, ivar, touched, eff, node_idx_tab,
             slots, start: int, count: int, *, G: int, sf2: float,
             min_known_ivar: float, max_ivar: float, n: int, max_level: int,
             state_fn, do_prune: bool) -> None:
    """Apply one scan's blocks ``[start, start + count)`` of the prediction
    tables to the pool (in place).  ``slots`` [Tp] int32; a slot equal to the
    pool capacity is padding.  ``start`` and ``count`` are host integers."""
    kw = dict(G=G, sf2=sf2, min_known_ivar=min_known_ivar, max_ivar=max_ivar, n=n,
              max_level=max_level, state_fn=state_fn, do_prune=do_prune)
    if acc_mean.device.type == "cpu":
        gp_light_plain(acc_mean, acc_var, present, m_ivar, ivar, touched, eff,
                       node_idx_tab, slots, start, count, **kw)
        return
    if acc_mean.device.type != "cuda":
        raise ValueError(f"gp_light: unsupported device {acc_mean.device}")
    global launches
    want = {"acc_mean": (acc_mean, torch.float32), "acc_var": (acc_var, torch.float32),
            "present": (present, torch.bool), "m_ivar": (m_ivar, torch.float32),
            "ivar": (ivar, torch.float32), "touched": (touched, torch.bool),
            "eff": (eff, torch.int8), "node_idx_tab": (node_idx_tab, torch.int32),
            "slots": (slots, torch.int32)}
    for k, (x, dt) in want.items():
        if x.device != acc_mean.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"gp_light: {k} must be a contiguous {dt} tensor "
                             f"on {acc_mean.device}")
    if not m_ivar.shape == ivar.shape == touched.shape == eff.shape:
        raise ValueError("gp_light: pool tensors differ in shape")
    if G not in SLOT_COUNTS:
        raise ValueError(f"gp_light: G must be one of {SLOT_COUNTS}, got {G}")
    bgk_light.check_block_edge("gp_light", n, m_ivar.shape[1])
    Tp = slots.shape[0]
    if (acc_mean.shape != acc_var.shape or acc_mean.shape[0] != Tp * G
            or present.shape != (Tp * G,) or node_idx_tab.shape[1] != m_ivar.shape[1]
            or start < 0 or start + count > Tp):
        raise ValueError("gp_light: prediction tables, node table or scan range "
                         "out of shape")
    if count <= 0:
        return
    stream = torch.cuda.current_stream(acc_mean.device).cuda_stream
    scratch = [0, 0, 0, 0]
    if n > bgk_light.TILE_EDGE:
        scratch = [x.data_ptr() for x in group_prune.tile_scratch(
            acc_mean.device, stream, count * (n // bgk_light.TILE_EDGE) ** 3, count)]
    code = _build.lib().la3dm_gp_light(
        acc_mean.data_ptr(), acc_var.data_ptr(), present.data_ptr(), slots.data_ptr(),
        node_idx_tab.data_ptr(), m_ivar.data_ptr(), ivar.data_ptr(),
        touched.data_ptr(), eff.data_ptr(), int(start), int(count), m_ivar.shape[0],
        n, acc_mean.shape[1], G, max_level if do_prune else 0, float(sf2),
        float(min_known_ivar), float(max_ivar), float(state_fn.l),
        float(state_fn.free_thresh), float(state_fn.occupied_thresh), *scratch, stream)
    _build.check(code, "gp_light")
    launches += 1


def gp_light_plain(acc_mean, acc_var, present, m_ivar, ivar, touched, eff,
                   node_idx_tab, slots, start: int, count: int, *, G: int, sf2: float,
                   min_known_ivar: float, max_ivar: float, n: int, max_level: int,
                   state_fn, do_prune: bool) -> None:
    """The plain PyTorch light pass for one scan (in place)."""
    cap, V = m_ivar.shape
    dev = m_ivar.device
    sl = slots[start:start + count].long()
    keep = sl < cap                                 # drop padding slots
    sl = sl[keep]
    t = torch.arange(start, start + count, device=dev)[keep]
    rows = t[:, None] * G + torch.arange(G, device=dev)            # [B,G]
    nidx = node_idx_tab.long()[eff[sl].long(), torch.arange(V, device=dev)]
    sel = nidx[:, None, :].expand(-1, G, -1)                       # [B,G,V]
    means = torch.gather(acc_mean[rows], 2, sel).transpose(1, 2)   # [B,V,G]
    vars_ = torch.gather(acc_var[rows], 2, sel).transpose(1, 2)
    vars_ = torch.where(vars_ == 0.0, 1.0, vars_)                 # padded-row guard
    pb = present[rows]                                              # [B,G]
    cur_mi, cur_iv = m_ivar[sl], ivar[sl]
    new_mi, new_iv = kgp.bcm_update_sequential(
        cur_mi, cur_iv, means, vars_, pb[:, None, :].expand_as(means), sf2,
        min_known_ivar, max_ivar)
    any_p = pb.any(dim=-1)[:, None]
    vals = {"m_ivar": torch.where(any_p, new_mi, cur_mi),
            "ivar": torch.where(any_p, new_iv, cur_iv),
            "touched": (touched[sl] | any_p).to(torch.float32)}
    new_eff = eff[sl]
    if do_prune:
        vals, new_eff = pruning.prune_blocks(vals, new_eff, n=n, max_level=max_level,
                                             state_fn=state_fn)
    m_ivar[sl] = vals["m_ivar"]
    ivar[sl] = vals["ivar"]
    touched[sl] = vals["touched"] > 0
    eff[sl] = new_eff
