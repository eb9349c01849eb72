"""Dense octree pruning over a batch of blocks, as plain torch.

The port of ``la3dm_tpu/models/pruning.py``.  The reference prunes
bottom-up per block: 8 sibling leaves with identical non-UNKNOWN states
collapse into their parent, which receives *child 0's* posterior values
(``bgkoctree.cpp:101-148``).

Dense encoding: ``eff_level[v] ∈ [0, depth-1]`` is the octree level of the
leaf owning base voxel v (0 = base resolution).  Collapse rule per level L,
from L=1 upward: all voxels of the 2^L group sit at level L−1, share one
state, and that state is not UNKNOWN → the whole group takes the
minimum-corner voxel's values and eff level L.  The CUDA light-pass kernel
(csrc/bgk_light.cu) applies the same rule in shared memory.
"""

from __future__ import annotations

from typing import Callable

import torch

from la3dm_tpu_torch.models import posterior


def _group_view(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """[..., n³] (raster x-fastest) → [..., G³, m³] group-major view.

    Flat raster index = x + y·n + z·n² splits as (zg zm yg ym xg xm); groups
    are the 2^L-aligned cubes, their inner index ordered (zm, ym, xm) so
    element 0 is the minimum corner (the reference's child-0 chain,
    bgkblock.cpp:23-27).
    """
    lead = x.shape[:-1]
    nl = len(lead)
    g = n // m
    x = x.reshape(*lead, g, m, g, m, g, m)  # zg zm yg ym xg xm
    perm = tuple(range(nl)) + tuple(nl + a for a in (0, 2, 4, 1, 3, 5))
    return x.permute(perm).reshape(*lead, g * g * g, m * m * m)


def _ungroup(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    lead = x.shape[:-2]
    nl = len(lead)
    g = n // m
    x = x.reshape(*lead, g, g, g, m, m, m)  # zg yg xg zm ym xm
    perm = tuple(range(nl)) + tuple(nl + a for a in (0, 3, 1, 4, 2, 5))
    return x.permute(perm).reshape(*lead, n * n * n)


def prune_blocks(values: dict, eff_level: torch.Tensor, n: int, max_level: int,
                 state_fn: Callable[[dict], torch.Tensor]) -> tuple[dict, torch.Tensor]:
    """Collapse homogeneous sibling groups across a batch of blocks.

    Args:
      values: dict of [B, n³] posterior tensors (family-specific fields).
      eff_level: [B, n³] int8 current leaf levels.
      n: voxels per block edge.
      max_level: deepest collapse level (= block_depth − 1).
      state_fn: values-dict → [B, n³] int8 state (already includes touched).
    Returns:
      (new values, new eff_level).
    """
    state = state_fn(values)
    for L in range(1, max_level + 1):
        m = 1 << L
        st_g = _group_view(state, n, m)        # [B, G³, m³]
        eff_g = _group_view(eff_level, n, m)
        children_are_leaves = torch.all(eff_g == L - 1, dim=-1)
        uniform = torch.all(st_g == st_g[..., :1], dim=-1)
        collapsible = (children_are_leaves & uniform
                       & (st_g[..., 0] != posterior.UNKNOWN))[..., None]

        def collapse(arr):
            g = _group_view(arr, n, m)
            return _ungroup(torch.where(collapsible, g[..., :1], g), n, m)

        values = {k: collapse(v) for k, v in values.items()}
        state = collapse(state)
        eff_g = torch.where(collapsible, L, eff_g)
        eff_level = _ungroup(eff_g, n, m)
    return values, eff_level
