"""K8 — the BGKLV tile-major prune: wrapper, plain version and launch counter.

Replaces ``la3dm_tpu/models/bgklv.py::_prune_step_tilemajor`` (lines
216-239: ``models/pruning.py::prune_blocks`` with ``posterior.LVStateFn``
between the stored → raster and raster → stored column permutations).  The
bottom-up sibling collapse of the given blocks, on the tile-major pool
(stored column pos·Vt + vt, ``geometry/blocks.py::tile_vox_map``), in
place.

On a CUDA tensor :func:`lv_prune` launches the hand-written kernel
(``csrc/lv_prune.cu``: one CTA per (block, tile), four voxels a thread,
for the levels inside a tile, the last CTA of each block for the levels
across tiles, each level a vote over a Morton order,
``csrc/group_prune.cuh``); on a CPU tensor it runs :func:`lv_prune_plain`.
The kernel is bound by memory: it reads each voxel's touched byte and the
rest of the tiles that hold a touched voxel, and writes the voxels that
collapse.
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.geometry import blocks as geo
from la3dm_tpu_torch.kernels import _build, group_prune
from la3dm_tpu_torch.models import pruning

#: kernel launches since the counter was last reset (one per pruned scan)
launches = 0


def lv_prune(A, Bv, touched, eff, slots, *, n: int, max_level: int, state_fn) -> None:
    """Prune the blocks ``slots`` [S] i32 (distinct) of the tile-major pool
    (A, Bv [cap, n³] f32, touched bool, eff int8; in place).  A slot equal to
    the capacity is padding.  ``state_fn`` is a ``posterior.LVStateFn``."""
    if A.device.type == "cpu":
        lv_prune_plain(A, Bv, touched, eff, slots, n=n, max_level=max_level,
                       state_fn=state_fn)
        return
    if A.device.type != "cuda":
        raise ValueError(f"lv_prune: unsupported device {A.device}")
    global launches
    want = {"A": (A, torch.float32), "Bv": (Bv, torch.float32),
            "touched": (touched, torch.bool), "eff": (eff, torch.int8),
            "slots": (slots, torch.int32)}
    for k, (x, dt) in want.items():
        if x.device != A.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"lv_prune: {k} must be a contiguous {dt} tensor "
                             f"on {A.device}")
    if (n & (n - 1)) or not A.shape == Bv.shape == touched.shape == eff.shape \
            or A.dim() != 2 or A.shape[1] != n ** 3 or n > 64:
        raise ValueError(f"lv_prune: pool must be [cap, n³] with n a power of "
                         f"two ≤ 64 (n={n})")
    if A.data_ptr() % 16 or Bv.data_ptr() % 16 or touched.data_ptr() % 4 \
            or eff.data_ptr() % 4:
        raise ValueError("lv_prune: A and Bv must be 16-byte aligned, touched and eff "
                         "4-byte aligned (the kernel loads four voxels at once)")
    S = slots.shape[0]
    if S == 0 or max_level <= 0:
        return
    te = min(8, n)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    scratch = [0, 0, 0, 0]
    if max_level > te.bit_length() - 1:   # levels across tiles
        scratch = [x.data_ptr() for x in group_prune.tile_scratch(
            A.device, stream, S * (n // te) ** 3, S)]
    code = _build.lib().la3dm_lv_prune(
        A.data_ptr(), Bv.data_ptr(), touched.data_ptr(), eff.data_ptr(),
        slots.data_ptr(), *scratch, S, A.shape[0], n, max_level, float(state_fn.min_W),
        float(state_fn.var_thresh), float(state_fn.free_thresh),
        float(state_fn.occupied_thresh), stream)
    _build.check(code, "lv_prune")
    launches += 1


def lv_prune_plain(A, Bv, touched, eff, slots, *, n: int, max_level: int,
                   state_fn) -> None:
    """The plain PyTorch prune: ``pruning.prune_blocks`` on the blocks'
    raster-order columns, as the JAX step computes it (in place)."""
    if max_level <= 0:
        return
    perm = geo.tile_vox_map(n).reshape(-1)             # stored → raster
    dev = A.device
    to_stored = torch.as_tensor(perm, dtype=torch.int64, device=dev)
    to_raster = torch.as_tensor(np.argsort(perm), dtype=torch.int64, device=dev)
    sl = slots.long()
    sl = sl[sl < A.shape[0]]                            # drop padding slots
    vals = {"A": A[sl][:, to_raster], "B": Bv[sl][:, to_raster],
            "touched": touched[sl][:, to_raster].to(torch.float32)}
    new_vals, new_eff = pruning.prune_blocks(vals, eff[sl][:, to_raster], n=n,
                                             max_level=max_level, state_fn=state_fn)
    A[sl] = new_vals["A"][:, to_stored]
    Bv[sl] = new_vals["B"][:, to_stored]
    touched[sl] = (new_vals["touched"] > 0)[:, to_stored]
    eff[sl] = new_eff[:, to_stored]
