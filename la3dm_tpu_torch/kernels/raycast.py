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

On CUDA tensors :func:`raycast` launches ``csrc/raycast.cu`` (one thread per
ray); on CPU tensors it runs :func:`raycast_plain`, a ``max_steps`` loop of
vector operations as the JAX step is.  What bounds the kernel is the
operations of the lookups, steps and probes the rays take (see the source
note; :func:`raycast_plain` counts the probes).
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
#: operations per state lookup and step, probes apart (voxel centre, block
#: coordinate, key split, hash, local index, the state's compare; the step:
#: argmin, t, index, t_max, the range test), and per probe (its position,
#: the hi, lo and empty compares): the counts the bound uses
OPS_PER_LOOKUP, OPS_PER_PROBE = 55, 5


def _check(want: dict) -> torch.device:
    dev = next(iter(want.values()))[0].device
    for k, (x, dt) in want.items():
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"raycast: {k} must be a contiguous {dt} tensor on {dev}")
    return dev


def raycast(state_tab, tab_hi, tab_lo, tab_slot, origins, d, *, res: float, bs: float,
            n: int, max_steps: int, target: int, max_range: float, max_probes: int):
    """(hit [N] bool, dist [N] f32, steps [N] int32) of the rays ``origins``
    [N,3] f32 along unit directions ``d`` [N,3] f32 over the state table
    ``state_tab`` [cap+1, V] int8 (raster order; row cap is UNKNOWN) and the
    hash ``tab_hi`` / ``tab_lo`` / ``tab_slot`` [H] int32 (H a power of two,
    hi == −1 empty, slot == cap absent)."""
    if origins.device.type == "cpu":
        return raycast_plain(state_tab, tab_hi, tab_lo, tab_slot, origins, d, res=res, bs=bs,
                             n=n, max_steps=max_steps, target=target, max_range=max_range,
                             max_probes=max_probes)
    if origins.device.type != "cuda":
        raise ValueError(f"raycast: unsupported device {origins.device}")
    global launches
    dev = _check({"origins": (origins, torch.float32), "d": (d, torch.float32),
                  "state_tab": (state_tab, torch.int8), "tab_hi": (tab_hi, torch.int32),
                  "tab_lo": (tab_lo, torch.int32), "tab_slot": (tab_slot, torch.int32)})
    N, H = origins.shape[0], tab_hi.shape[0]
    if (origins.shape[1:] != (3,) or d.shape != origins.shape or state_tab.dim() != 2
            or state_tab.shape[1] != n ** 3 or tab_lo.shape != (H,)
            or tab_slot.shape != (H,) or H & (H - 1)):
        raise ValueError("raycast: inconsistent shapes")
    hit = torch.empty(N, dtype=torch.bool, device=dev)
    dist = torch.empty(N, dtype=torch.float32, device=dev)
    steps = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return hit, dist, steps
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.lib().la3dm_raycast(
        state_tab.data_ptr(), tab_hi.data_ptr(), tab_lo.data_ptr(), tab_slot.data_ptr(),
        origins.data_ptr(), d.data_ptr(), N, state_tab.shape[0] - 1, H, n, int(max_steps),
        int(target), int(max_probes), _f32(res), _f32(bs), _f32(max_range),
        hit.data_ptr(), dist.data_ptr(), steps.data_ptr(), stream)
    _build.check(code, "raycast")
    launches += 1
    return hit, dist, steps


def _f32(x: float) -> float:
    return float(np.float32(x))


def state_plain(state_tab, tab_hi, tab_lo, tab_slot, idx, *, res, bs, n: int,
                max_probes: int):
    """(state [M] int8, probes [M] int64) of the voxels ``idx`` [M,3] int32
    (global base-resolution indices) as K6 reads them: the state, and the
    hash probes the lookup takes (to a match or an empty entry, at most
    ``max_probes``).  ``res`` and ``bs`` are 0-d tensors of the computing
    dtype (f32, or f64 for a control)."""
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
    return state_tab[torch.clamp_max(slot, cap).long(), vi.long()], probes


def raycast_plain(state_tab, tab_hi, tab_lo, tab_slot, origins, d, *, res: float, bs: float,
                  n: int, max_steps: int, target: int, max_range: float, max_probes: int,
                  count_probes: bool = False):
    """The plain PyTorch :func:`raycast`: the JAX step's vector loop over all
    rays, ``max_steps`` iterations of ``max_probes`` probes, except that it
    looks every 8 iterations (and probes) whether every ray has stopped (has
    found its slot) and then leaves: stopped rays change nothing.  Divisions
    by a constant divide by a tensor (``math.div``'s rule).  It computes in
    the rays' dtype: f32, or f64 (with the constants unrounded) for a
    control.  With ``count_probes`` it also returns the hash probes each ray
    took over its lookups ([N] int64), the count of K6's bound."""
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
    active = torch.ones(N, dtype=torch.bool, device=dev)
    mr = c(max_range)
    for it in range(max_steps):
        if it % 8 == 7 and not bool(active.any()):
            break
        state, taken = state_plain(state_tab, tab_hi, tab_lo, tab_slot, idx, res=resf,
                                   bs=bsf, n=n, max_probes=max_probes)
        probes += torch.where(active, taken, 0)
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
    return (hit, dist, steps, probes) if count_probes else (hit, dist, steps)
