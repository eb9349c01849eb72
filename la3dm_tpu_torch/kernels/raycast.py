"""K6 — the device DDA of raycast: wrapper, plain version and launch counter.

Replaces ``la3dm_tpu/models/raycast.py::_raycast_loop`` (lines 145-215):
Amanatides–Woo stepping of N rays over the base-resolution voxel grid,
each voxel's state read through an open-addressing block-coord → pool-slot
hash (linear probes) and the int8 state table [cap+1, V]; each ray reports
whether it met a voxel in the target state, the distance t at that voxel
and the steps it took, up to ``max_steps`` steps or past ``max_range``.

The JAX step runs every ray in lockstep for ``max_steps`` iterations; a ray
that has stopped changes nothing after, so the kernel's thread leaves at
its first hit or once past the range, with the same results.  The order of
one iteration is kept: the state of the current voxel is checked, then the
ray steps (so the voxel reached by the last step is never checked).

On CUDA tensors :func:`raycast` launches ``csrc/raycast.cu`` (per axis the
block coordinate and local index recomputed only on the stepped axis; a
block cache a ray, so the hash is probed only where the ray enters another
block, and then by the whole warp at once; about one wave of warps whose
lanes take the next ray from a global counter when four of them have
stopped); on CPU tensors it runs :func:`raycast_plain`, a
``max_steps`` loop of vector operations as the JAX step is.  What bounds
the kernel is the operations of the lookups, steps and probes the rays
take (see the source note; :func:`raycast_plain` counts the probes of
every lookup and those under the kernel's block cache).
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import _build

#: kernel launches since the counter was last reset (one per query)
launches = 0
#: the block hash's multiplicative constants (int32) and key-field bias,
#: the JAX package's (``la3dm_tpu/models/raycast.py:92-97``)
HC1, HC2, KB = -1640531527, -862048943, 524288
#: the operations the bound counts.  Per axis of a voxel: its centre (a
#: product), block coordinate (division, add, floor) and local index
#: (product, difference, division, add, truncation, clip); per lookup and
#: step, axes apart: the voxel's flat index (2 products, 2 adds), the
#: state's compare, the argmin (2 compares), t, the index, t_max, the range
#: test and the step count; the key split and hash of a block (3 biases, 6
#: shifts, ands and ors, 2 products, the xor and the mask); a probe (its
#: position, the hi, lo and empty compares)
OPS_PER_AXIS, OPS_PER_STEP, OPS_PER_HASH, OPS_PER_PROBE = 10, 12, 13, 5
#: a lookup's operations, probes apart, where every lookup computes all
#: three axes and hashes its block (the JAX step's walk)
OPS_PER_LOOKUP = 3 * OPS_PER_AXIS + OPS_PER_STEP + OPS_PER_HASH


def _check(want: dict) -> torch.device:
    dev = next(iter(want.values()))[0].device
    for k, (x, dt) in want.items():
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"raycast: {k} must be a contiguous {dt} tensor on {dev}")
    return dev


def raycast(state_tab, tab_hi, tab_lo, tab_slot, origins, d, *, res: float, bs: float,
            n: int, max_steps: int, target: int, max_range: float, max_probes: int,
            counts=None):
    """(hit [N] bool, dist [N] f32, steps [N] int32) of the rays ``origins``
    [N,3] f32 along unit directions ``d`` [N,3] f32 over the state table
    ``state_tab`` [cap+1, V] int8 (raster order; row cap is UNKNOWN) and the
    hash ``tab_hi`` / ``tab_lo`` / ``tab_slot`` [H] int32 (H a power of two,
    hi == −1 empty, slot == cap absent).  ``counts`` (an int64 [2] tensor on
    the card, or None) gets the kernel's lookups that probed and their
    probes added (the block-cache counts of ``raycast_plain(count_probes=True)``)."""
    if origins.device.type == "cpu":
        return raycast_plain(state_tab, tab_hi, tab_lo, tab_slot, origins, d, res=res, bs=bs,
                             n=n, max_steps=max_steps, target=target, max_range=max_range,
                             max_probes=max_probes)
    if origins.device.type != "cuda":
        raise ValueError(f"raycast: unsupported device {origins.device}")
    global launches
    want = {"origins": (origins, torch.float32), "d": (d, torch.float32),
            "state_tab": (state_tab, torch.int8), "tab_hi": (tab_hi, torch.int32),
            "tab_lo": (tab_lo, torch.int32), "tab_slot": (tab_slot, torch.int32)}
    if counts is not None:
        want["counts"] = (counts, torch.int64)
    dev = _check(want)
    N, H = origins.shape[0], tab_hi.shape[0]
    if (origins.shape[1:] != (3,) or d.shape != origins.shape or state_tab.dim() != 2
            or state_tab.shape[1] != n ** 3 or tab_lo.shape != (H,)
            or tab_slot.shape != (H,) or H & (H - 1)
            or (counts is not None and counts.shape != (2,))):
        raise ValueError("raycast: inconsistent shapes")
    hit = torch.empty(N, dtype=torch.bool, device=dev)
    dist = torch.empty(N, dtype=torch.float32, device=dev)
    steps = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return hit, dist, steps
    nxt = torch.zeros(1, dtype=torch.int64, device=dev)
    code = _build.lib().la3dm_raycast(
        state_tab.data_ptr(), tab_hi.data_ptr(), tab_lo.data_ptr(), tab_slot.data_ptr(),
        origins.data_ptr(), d.data_ptr(), N, state_tab.shape[0] - 1, H, n, int(max_steps),
        int(target), int(max_probes), _f32(res), _f32(bs), _f32(max_range), nxt.data_ptr(),
        counts.data_ptr() if counts is not None else None,
        hit.data_ptr(), dist.data_ptr(), steps.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "raycast")
    launches += 1
    return hit, dist, steps


def _f32(x: float) -> float:
    return float(np.float32(x))


def lookup_plain(state_tab, tab_hi, tab_lo, tab_slot, idx, *, res, bs, n: int,
                 max_probes: int):
    """(state [M] int8, probes [M] int64, blk [M,3] int32, slot [M] int32)
    of the voxels ``idx`` [M,3] int32 (global base-resolution indices) as K6
    looks them up: the block coordinate floor(idx·res/bs + 1/2), its pool
    slot (cap where absent) after the hash probes it takes (to a match or an
    empty entry, at most ``max_probes``), and the voxel's state.  ``res``
    and ``bs`` are 0-d tensors of the computing dtype (f32, or f64 for a
    control)."""
    M, dev, ft = idx.shape[0], idx.device, res.dtype
    cap, H = state_tab.shape[0] - 1, tab_hi.shape[0]
    p = idx.to(ft) * res                                            # voxel centre
    blk = torch.floor(p / bs + 0.5).to(torch.int32)
    c32 = blk + KB
    hi = (c32[:, 0] << 10) | (c32[:, 1] >> 10)
    lo = ((c32[:, 1] & 1023) << 20) | c32[:, 2]
    # the hash wraps in 32 bits: products in int64, cut to 32 bits
    h = ((hi.long() * HC1) ^ (lo.long() * HC2)) & (H - 1)
    slot = torch.full((M,), cap, dtype=torch.int32, device=dev)
    done = torch.zeros(M, dtype=torch.bool, device=dev)
    probes = torch.zeros(M, dtype=torch.int64, device=dev)
    for j in range(max_probes):
        pos = (h + j) & (H - 1)
        probes += ~done
        match = (tab_hi[pos] == hi) & (tab_lo[pos] == lo)
        slot = torch.where(~done & match, tab_slot[pos], slot)
        done = done | match | (tab_hi[pos] == -1)
        if j % 8 == 7 and bool(done.all()):
            break
    ctr = blk.to(ft) * bs
    v = torch.clamp(((p - ctr) / res + torch.full((), n, dtype=ft, device=dev) / 2.0)
                    .to(torch.int32), 0, n - 1)
    vi = v[:, 0] + v[:, 1] * n + v[:, 2] * n * n
    return state_tab[torch.clamp_max(slot, cap).long(), vi.long()], probes, blk, slot


def raycast_plain(state_tab, tab_hi, tab_lo, tab_slot, origins, d, *, res: float, bs: float,
                  n: int, max_steps: int, target: int, max_range: float, max_probes: int,
                  count_probes: bool = False):
    """The plain PyTorch :func:`raycast`: the JAX step's vector loop over all
    rays, ``max_steps`` iterations of ``max_probes`` probes, except that it
    looks every 8 iterations (and probes) whether every ray has stopped (has
    found its slot) and then leaves: stopped rays change nothing.  Divisions
    by a constant divide by a tensor (``math.div``'s rule).  It computes in
    the rays' dtype: f32, or f64 (with the constants unrounded) for a
    control.  With ``count_probes=True`` it also returns, per ray ([N]
    int64 each), the hash probes of all its lookups, and the probes and the
    number of the lookups that probe under K6's block cache: a ray's first
    lookup and each lookup whose block differs from the ray's previous
    lookup's (the counts of K6's bound and of its ``counts``)."""
    N, dev = origins.shape[0], origins.device
    ft = origins.dtype

    def c(x):
        return torch.full((), _f32(x) if ft == torch.float32 else x, dtype=ft, device=dev)

    resf, bsf = c(res), c(bs)
    rows = torch.arange(N, device=dev)

    idx = torch.floor(origins / resf + 0.5).to(torch.int32)
    step = torch.where(d > 0, 1, -1).to(torch.int32)
    tiny = d.abs() < 1e-12
    safe_d = torch.where(tiny, c(1e-12), d)
    bound = (idx + (step > 0).to(torch.int32)).to(ft) * resf - resf / 2.0
    t_max = torch.where(tiny, torch.full((), float("inf"), dtype=ft, device=dev),
                        (bound - origins) / safe_d)
    t_delta = (resf / safe_d).abs()

    t = torch.zeros(N, dtype=ft, device=dev)
    hit = torch.zeros(N, dtype=torch.bool, device=dev)
    dist = torch.full((N,), float("inf"), dtype=ft, device=dev)
    steps = torch.zeros(N, dtype=torch.int32, device=dev)
    probes = torch.zeros(N, dtype=torch.int64, device=dev)
    probes_b = torch.zeros(N, dtype=torch.int64, device=dev)
    probed_b = torch.zeros(N, dtype=torch.int64, device=dev)
    cache = torch.zeros((N, 3), dtype=torch.int32, device=dev)     # the last lookup's block
    cached = torch.zeros(N, dtype=torch.bool, device=dev)
    active = torch.ones(N, dtype=torch.bool, device=dev)
    mr = c(max_range)
    for it in range(max_steps):
        if it % 8 == 7 and not bool(active.any()):
            break
        state, taken, blk, _ = lookup_plain(state_tab, tab_hi, tab_lo, tab_slot, idx,
                                            res=resf, bs=bsf, n=n, max_probes=max_probes)
        if count_probes:
            probes += torch.where(active, taken, 0)
            new = active & (~cached | (blk != cache).any(1))
            probes_b += torch.where(new, taken, 0)
            probed_b += new
            cache = torch.where(new[:, None], blk, cache)
            cached = cached | new
        found = active & (state == target)
        hit = hit | found
        dist = torch.where(found, t, dist)
        active = active & ~found
        ax = torch.argmin(t_max, dim=1)                 # ties: the lowest axis
        t = torch.where(active, t_max[rows, ax], t)
        bump = torch.nn.functional.one_hot(ax, 3).to(torch.int32) * step
        idx = torch.where(active[:, None], idx + bump, idx)
        adv = torch.zeros_like(t_max)
        adv[rows, ax] = t_delta[rows, ax]
        t_max = torch.where(active[:, None], t_max + adv, t_max)
        steps = torch.where(active, steps + 1, steps)
        active = active & (t <= mr)
    if count_probes:
        return hit, dist, steps, probes, probes_b, probed_b
    return hit, dist, steps
