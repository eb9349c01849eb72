"""K2 — the BGK light pass with the prune: wrapper, plain version and launch
counter.

Replaces the light half of ``la3dm_tpu/models/bgk.py::_bgk_seq_step``
(lines 140-177, with ``kernels/predict.py::beta_update``,
``models/pruning.py::prune_blocks`` and ``posterior.BetaStateFn``) for one
scan: the per-slot gate k̄_g > gate, ΔA = Σ gated ȳ and ΔB = Σ gated
(k̄ − ȳ) read at each voxel's eff-level node, the add into A/B, the OR into
``touched``, then the bottom-up prune of the scan's blocks.  The pool
tensors are updated in place.

On a CUDA tensor :func:`bgk_light` launches the hand-written kernel
(``csrc/bgk_light.cu``, K5's shape with the Beta fold: up to 8³ voxels a
block, a thread a voxel and one block a CTA, or eight blocks of 2³ a CTA;
above, one CTA per 8³ tile, two voxels a thread at G = 7, with the scratch
of ``group_prune.tile_scratch``; the pool row's loads, then each warp's
accumulator rows laid end to end through shared memory, before the fold;
the prune of ``csrc/group_prune.cuh``, votes over a Morton order); on a
CPU tensor it runs :func:`bgk_light_plain`.
The kernel is bound by memory: it moves each accumulator and pool byte
once.
"""

from __future__ import annotations

import torch

from la3dm_tpu_torch.kernels import _build, group_prune, predict as kp
from la3dm_tpu_torch.models import pruning

#: kernel launches since the counter was last reset (one per scan)
launches = 0
#: slots a block the kernel takes (G: the face neighbours, or all 27 with
#: ``predict``)
SLOT_COUNTS = (7, 27)

#: the largest block edge the kernels take (block_depth 7), as K8's
MAX_N = 64
#: voxels per tile edge of the tiled kernels (blocks of n > TILE_EDGE)
TILE_EDGE = 8


def check_block_edge(name: str, n: int, V: int) -> None:
    """Raise unless the pool rows hold blocks of n³ voxels with n a power of
    two no larger than :data:`MAX_N`."""
    if n <= 0 or n & (n - 1) or n > MAX_N or V != n ** 3:
        raise ValueError(f"{name}: blocks of n³ voxels with n a power of two "
                         f"≤ {MAX_N} (block_depth ≤ 7); got n={n}, {V} voxels a row")


def bgk_light(acc, A, Bv, touched, eff, node_idx_tab, slots, start: int,
              count: int, *, G: int, gate: float, n: int, max_level: int,
              state_fn, do_prune: bool) -> None:
    """Apply one scan's blocks ``[start, start + count)`` of ``acc`` to the
    pool (in place).  ``slots`` [Tp] int32; a slot equal to the pool
    capacity is padding.  ``start`` and ``count`` are host integers."""
    if acc.device.type == "cpu":
        bgk_light_plain(acc, A, Bv, touched, eff, node_idx_tab, slots, start,
                        count, G=G, gate=gate, n=n, max_level=max_level,
                        state_fn=state_fn, do_prune=do_prune)
        return
    if acc.device.type != "cuda":
        raise ValueError(f"bgk_light: unsupported device {acc.device}")
    global launches
    want = {"acc": (acc, torch.float32), "A": (A, torch.float32),
            "Bv": (Bv, torch.float32), "touched": (touched, torch.bool),
            "eff": (eff, torch.int8), "node_idx_tab": (node_idx_tab, torch.int32),
            "slots": (slots, torch.int32)}
    for k, (x, dt) in want.items():
        if x.device != acc.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"bgk_light: {k} must be a contiguous {dt} tensor "
                             f"on {acc.device}")
    if not A.shape == Bv.shape == touched.shape == eff.shape:
        raise ValueError("bgk_light: pool tensors differ in shape")
    if G not in SLOT_COUNTS:
        raise ValueError(f"bgk_light: G must be one of {SLOT_COUNTS}, got {G}")
    check_block_edge("bgk_light", n, A.shape[1])
    if (acc.shape[0] != slots.shape[0] or acc.shape[2] != 2 * G
            or node_idx_tab.shape[1] != A.shape[1] or start < 0
            or start + count > slots.shape[0]):
        raise ValueError("bgk_light: accumulator, node table or scan range "
                         "out of shape")
    if count <= 0:
        return
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    scratch = [0, 0, 0, 0]
    if n > TILE_EDGE:
        scratch = [x.data_ptr() for x in group_prune.tile_scratch(
            acc.device, stream, count * (n // TILE_EDGE) ** 3, count)]
    code = _build.lib().la3dm_bgk_light(
        acc.data_ptr(), slots.data_ptr(), node_idx_tab.data_ptr(),
        A.data_ptr(), Bv.data_ptr(), touched.data_ptr(), eff.data_ptr(),
        int(start), int(count), A.shape[0], n, acc.shape[1], G, float(gate),
        max_level if do_prune else 0, float(state_fn.var_thresh),
        float(state_fn.free_thresh), float(state_fn.occupied_thresh),
        *scratch, stream)
    _build.check(code, "bgk_light")
    launches += 1


def bgk_light_plain(acc, A, Bv, touched, eff, node_idx_tab, slots, start: int,
                    count: int, *, G: int, gate: float, n: int, max_level: int,
                    state_fn, do_prune: bool) -> None:
    """The plain PyTorch light pass for one scan (in place)."""
    cap, V = A.shape
    sl = slots[start:start + count].long()
    keep = sl < cap                         # drop padding slots
    sl = sl[keep]
    accb = acc[start:start + count][keep]   # [B,Vall,2G]
    nidx = node_idx_tab.long()[eff[sl].long(), torch.arange(V, device=A.device)]
    sel = torch.gather(accb, 1, nidx[..., None].expand(-1, -1, 2 * G))  # [B,V,2G]
    dA, dB, tch = kp.beta_update(sel[..., :G], sel[..., G:], gate)
    vals = {"A": A[sl] + dA, "B": Bv[sl] + dB,
            "touched": (touched[sl] | tch).to(torch.float32)}
    new_eff = eff[sl]
    if do_prune:
        vals, new_eff = pruning.prune_blocks(vals, new_eff, n=n,
                                             max_level=max_level, state_fn=state_fn)
    A[sl] = vals["A"]
    Bv[sl] = vals["B"]
    touched[sl] = vals["touched"] > 0
    eff[sl] = new_eff
