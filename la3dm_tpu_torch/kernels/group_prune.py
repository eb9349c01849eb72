"""The Morton order of the vote-based prune of K2, K5 and K8
(``csrc/group_prune.cuh``): its Python twin, which the tests hold.

In the kernels, thread t of a CTA holds the item at Morton index t of a
cube of edge e ≤ 8 — the voxels of a block of n ≤ 8 or of an 8³ tile, or,
in a block's last CTA, the block's (n/8)³ tiles.  The bits of t interleave
the coordinates: bit 3i of t is bit i of x, bit 3i + 1 bit i of y, bit
3i + 2 bit i of z.  So a level-k group (edge 2^k) is the 8^k consecutive
indices from a multiple of 8^k, and its first index is its minimum corner:
the collapse test of a group is an AND over a run of threads.
:func:`morton_xyz` is the header's ``morton_x``, ``morton_y`` and
``morton_z``, bit for bit.

:func:`near_collapsible_rows` makes the pools that hold the prune at every
level: blocks whose groups are each one change away from collapsing (the
CPU tests, ``chip_smoke.py`` and ``tools/seg_kernels_ab.py`` use them).
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.models import posterior as po

#: (device, stream) → the tile summaries and block counters of the kernels'
#: tiled launches, grown as needed and kept for the process (a few bytes a
#: tile).  The counters are zeroed once; every launch leaves them zero (each
#: block's last CTA sets its own back), so a launch needs no memset: scratch
#: zeroed per launch made K8's large-map prune 17 % and K5 at 16³ 12 % slower
#: on an H100 80GB HBM3 (PERF.md §6).
_SCRATCH: dict = {}


def morton_xyz(t):
    """(x, y, z) of Morton index (or indices) ``t`` < 512 in its cube."""
    t = np.asarray(t)
    x = (t & 1) | ((t >> 2) & 2) | ((t >> 4) & 4)
    y = ((t >> 1) & 1) | ((t >> 3) & 2) | ((t >> 5) & 4)
    z = ((t >> 2) & 1) | ((t >> 4) & 2) | ((t >> 6) & 4)
    return x, y, z


def morton_order(e: int) -> np.ndarray:
    """The raster index (x fastest) of each Morton index of a cube of edge
    ``e`` (1, 2, 4 or 8): the voxel order of a block of n = e, or of an 8³
    tile (e = 8), and the tile order of a block of n = 8·e."""
    if e not in (1, 2, 4, 8):
        raise ValueError(f"morton_order: a cube edge of 1, 2, 4 or 8, got {e}")
    x, y, z = morton_xyz(np.arange(e ** 3))
    return x + e * (y + e * z)


def tile_scratch(device, stream: int, tiles: int, blocks: int) -> tuple:
    """Scratch of a tiled K2, K5 or K8 launch on ``stream`` (its handle) over
    ``blocks`` blocks of ``tiles`` tiles in all: tile summaries (eff, state)
    int8 [≥ tiles, 2], (f0, f1) f32 [≥ tiles, 2], touched u8 [≥ tiles], and
    the block counters int32 [≥ blocks], zero.  Kept per device and stream
    (launches on one stream run in order), so a launch allocates nothing."""
    key = (str(device), stream)
    have = _SCRATCH.get(key)
    if have is None or have[0].shape[0] < tiles or have[3].shape[0] < blocks:
        t = 1 << max(tiles - 1, 0).bit_length()
        b = 1 << max(blocks - 1, 0).bit_length()
        if have is not None:
            t, b = max(t, have[0].shape[0]), max(b, have[3].shape[0])
        have = (torch.empty((t, 2), dtype=torch.int8, device=device),
                torch.empty((t, 2), dtype=torch.float32, device=device),
                torch.empty((t,), dtype=torch.uint8, device=device),
                torch.zeros((b,), dtype=torch.int32, device=device))
        _SCRATCH[key] = have
    return have


#: how each group of :func:`near_collapsible_rows` is kept from collapsing
#: (or let): it collapses; its last Morton member (the maximum corner) or
#: its corner takes another state; one member's eff differs; the whole
#: group is UNKNOWN; the whole group is UNCERTAIN (LV only; it collapses)
NEAR_KINDS = ("collapse", "last", "corner", "eff", "unknown", "uncertain")


def near_collapsible_rows(n, S, states, seed=0):
    """State codes and eff levels, int8 [S, n³] (raster, x fastest), of
    blocks whose groups are each one change away from collapsing.  Row i
    sits at eff L − 1 everywhere, L = 1 + i mod log2(n), so that L is the
    level that can collapse next; its level-L groups take the kinds of
    :data:`NEAR_KINDS` in turn (``uncertain`` only where ``states`` holds
    UNCERTAIN), starting at kind i // log2(n), each group one of
    ``states`` (the collapsible states) drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    levels = n.bit_length() - 1
    kinds = [k for k in NEAR_KINDS if k != "uncertain" or po.UNCERTAIN in states]
    states = np.asarray(states, np.int8)
    plain = states[states != po.UNCERTAIN]
    st = np.empty((S, n, n, n), np.int8)
    eff = np.empty((S, n, n, n), np.int8)
    for i in range(S):
        L = 1 + i % levels
        m, g = 1 << L, n >> L
        kind = np.array(kinds)[(i // levels + np.arange(g ** 3)) % len(kinds)]
        s0 = plain[rng.integers(0, len(plain), g ** 3)]
        # another state than s0: the next one of ``states`` after a random step
        at = np.argmax(states[None, :] == s0[:, None], axis=1)
        other = states[(at + rng.integers(1, len(states), g ** 3)) % len(states)]
        grp = np.where(kind == "unknown", po.UNKNOWN,
                       np.where(kind == "uncertain", po.UNCERTAIN, s0)).astype(np.int8)
        st[i] = grp.reshape(g, g, g).repeat(m, 0).repeat(m, 1).repeat(m, 2)
        eff[i] = L - 1
        gz, gy, gx = (np.arange(g ** 3)[:, None] // g ** np.array([2, 1, 0]) % g * m).T
        last, corner, one = kind == "last", kind == "corner", kind == "eff"
        st[i, gz[last] + m - 1, gy[last] + m - 1, gx[last] + m - 1] = other[last]
        st[i, gz[corner], gy[corner], gx[corner]] = other[corner]
        d = rng.integers(0, m, (3, int(one.sum())))
        up = (rng.uniform(size=d.shape[1]) < 0.5) | (L == 1)
        eff[i, gz[one] + d[0], gy[one] + d[1], gx[one] + d[2]] = np.where(up, L, L - 2)
    return st.reshape(S, -1), eff.reshape(S, -1)


def near_pool_values(state, values, seed=0):
    """(f0, f1) f32 and touched [S, V] for the state codes of
    :func:`near_collapsible_rows`: ``values`` maps each state to an (f0, f1,
    touched) template, f0 and f1 with ±5 % noise so that collapse copies
    show."""
    rng = np.random.default_rng(seed)
    f = np.zeros(state.shape + (2,), np.float32)
    touched = np.zeros(state.shape, bool)
    for code, (f0, f1, t) in values.items():
        at = state == code
        f[at] = (f0, f1)
        touched[at] = t
    f *= rng.uniform(0.95, 1.05, f.shape).astype(np.float32)
    return np.ascontiguousarray(f[..., 0]), np.ascontiguousarray(f[..., 1]), touched


#: GP templates of the near-collapsible pools, far from the state thresholds
#: of the GP configs (l 100, max_ivar 1000, min_known_ivar 50): state →
#: (m_ivar, ivar, touched); UNKNOWN voxels are known-less (ivar below
#: min_known_ivar), since the light pass touches every voxel of a block
#: with a model
GP_NEAR_VALUES = {po.OCCUPIED: (1e4, 500.0, True), po.FREE: (-1e4, 500.0, True),
                  po.UNKNOWN: (1e4, 5.0, True)}
#: Beta templates of the near-collapsible pools of K2, far from the state
#: thresholds of the BGK configs (free 0.3, occupied 0.7, var_thresh 100):
#: state → (A, B, touched); UNKNOWN voxels sit at probability 0.5, touched,
#: since the light pass touches every voxel that an update reaches
BGK_NEAR_VALUES = {po.OCCUPIED: (1000.0, 1.0, True), po.FREE: (1.0, 1000.0, True),
                   po.UNKNOWN: (1000.0, 1000.0, True)}
