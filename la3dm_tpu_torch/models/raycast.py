"""Raycast — cross-block DDA traversal over the voxel map.

The port of ``la3dm_tpu/models/raycast.py``.  The reference ships a
RayCaster (``bgkoctomap.h:91-214``, 3-D Amanatides–Woo stepping across
block boundaries) that no executable uses.  Two batch implementations, N
rays each reporting the first voxel whose state matches a target (default
OCCUPIED):

* :func:`raycast` — the host numpy stepper (f64), stepping against the
  map's ``search``;
* :func:`raycast_device` — on the map's device: a snapshot of the map's
  int8 state table and a hashed block-coord → pool-slot table
  (:class:`RaycastSnapshot`), and the whole traversal in one kernel launch
  (K6, ``kernels/raycast.py``: one thread per ray, leaving at its first hit
  or once past ``max_range``).

The hash (:func:`_build_block_hash`, the constants ``_HC1``, ``_HC2`` and
``_KB``) is the JAX package's, bit for bit, so both packages build the same
table from the same map.
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import raycast as k6
from la3dm_tpu_torch.models import posterior


def raycast(m, origins: np.ndarray, directions: np.ndarray, max_range: float,
            target_state: int = posterior.OCCUPIED) -> dict:
    """Batched DDA over the map's base-resolution grid, on the host.

    Args:
      m: a map of any family.
      origins: [N,3] ray origins.
      directions: [N,3] (normalised here).
      max_range: traversal limit in metres.
      target_state: stop at the first voxel of this state.
    Returns a dict with hit [N] bool, point [N,3], distance [N], steps [N].
    """
    res = m.cfg.resolution
    origins = np.atleast_2d(origins).astype(np.float64)
    d = np.atleast_2d(directions).astype(np.float64)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    N = len(origins)

    # current voxel index (global integer grid at base resolution, centred
    # frame: voxel i spans [i·res − res/2, i·res + res/2))
    idx = np.floor(origins / res + 0.5).astype(np.int64)
    step = np.where(d > 0, 1, -1).astype(np.int64)
    safe_d = np.where(np.abs(d) < 1e-12, 1e-12, d)
    # distance to the next voxel boundary per axis
    bound = (idx + (step > 0)) * res - res / 2.0
    t_max = (bound - origins) / safe_d
    t_max = np.where(np.abs(d) < 1e-12, np.inf, t_max)
    t_delta = np.abs(res / safe_d)

    hit = np.zeros(N, bool)
    dist = np.full(N, np.inf)
    steps = np.zeros(N, np.int64)
    active = np.ones(N, bool)
    t = np.zeros(N)

    max_steps = int(np.ceil(max_range / res) * 3 + 8)
    for _ in range(max_steps):
        if not active.any():
            break
        centers = idx[active] * res
        out = m.search(centers.astype(np.float32))
        found = out["state"] == target_state
        sel = np.nonzero(active)[0]
        newly = sel[found]
        hit[newly] = True
        dist[newly] = t[newly]
        active[newly] = False

        sel = np.nonzero(active)[0]
        if len(sel) == 0:
            break
        ax = np.argmin(t_max[sel], axis=1)
        rows = (sel, ax)
        t[sel] = t_max[rows]
        idx[rows] += step[rows]
        t_max[rows] += t_delta[rows]
        steps[sel] += 1
        active[sel] &= t[sel] <= max_range
    point = origins + d * np.minimum(dist, max_range)[:, None]
    return {"hit": hit, "point": point.astype(np.float32),
            "distance": dist.astype(np.float32), "steps": steps}


#: multiplicative hash constants (odd; int32 wrap on the host and the
#: device): 2654435769 = 2^32/φ and 3432918353, as int32
_HC1, _HC2 = np.int32(k6.HC1), np.int32(k6.HC2)

#: bias of the block-key fields (geometry/blocks.py::pack_key, the
#: reference BlockHashKey, bgkblock.cpp:73-77)
_KB = k6.KB


def _split_keys(coords):
    """Block coords → two int32 keys (30 bits each; hi ≥ 0, −1 = empty)."""
    c = np.asarray(coords, np.int64) + _KB
    hi = ((c[..., 0] << 10) | (c[..., 1] >> 10)).astype(np.int32)
    lo = (((c[..., 1] & 1023) << 20) | c[..., 2]).astype(np.int32)
    return hi, lo


def _build_block_hash(coords: np.ndarray, slots: np.ndarray, cap: int):
    """Open-addressing (linear probe) block-coord → slot table, built on the
    host at ≤ 50 % load; returns (tab_hi, tab_lo, tab_slot, H, max_probes).
    Memory is O(active blocks) whatever the map's extent."""
    nb = len(coords)
    H = max(64, 1 << int(np.ceil(np.log2(max(2 * nb, 2)))))
    tab_hi = np.full(H, -1, np.int32)
    tab_lo = np.zeros(H, np.int32)
    tab_slot = np.full(H, cap, np.int32)
    hi, lo = _split_keys(coords)
    with np.errstate(over="ignore"):
        probe = ((hi * _HC1) ^ (lo * _HC2)) & np.int32(H - 1)
    remaining = np.arange(nb)
    max_probes = 0
    while len(remaining):
        max_probes += 1
        p = probe[remaining]
        order = np.argsort(p, kind="stable")
        first = np.concatenate([[True], p[order][1:] != p[order][:-1]])
        cand_rows = order[first]
        free = tab_hi[p[cand_rows]] == -1
        w = remaining[cand_rows[free]]
        tab_hi[probe[w]] = hi[w]
        tab_lo[probe[w]] = lo[w]
        tab_slot[probe[w]] = slots[w]
        placed = np.zeros(len(remaining), bool)
        placed[cand_rows[free]] = True
        remaining = remaining[~placed]
        probe[remaining] = (probe[remaining] + 1) & np.int32(H - 1)
    return tab_hi, tab_lo, tab_slot, H, max(max_probes, 1)


class RaycastSnapshot:
    """Device-resident map snapshot for repeated raycast queries: the int8
    state table [cap+1, V] (raster voxel order, the last row the UNKNOWN
    guard of absent blocks) and the hashed block-coord → slot table, on the
    map's device.  Build once (:func:`raycast_snapshot`), query many times."""

    def __init__(self, m):
        nb = m.pool.n_blocks
        cap = m.pool.capacity
        if nb:
            slots = m.pool.active_slots()
            coords = m.pool.coords[slots]
        else:
            slots = np.zeros(1, np.int32)
            coords = np.full((1, 3), 1 << 19, np.int64)  # out-of-map sentinel
        hi, lo, sl, H, maxp = _build_block_hash(coords, slots, cap)
        dev = m.device
        self.tab_hi = torch.as_tensor(hi, device=dev)
        self.tab_lo = torch.as_tensor(lo, device=dev)
        self.tab_slot = torch.as_tensor(sl, device=dev)
        # the JAX package rounds the probe bound so its rebuilds reuse an
        # executable; kept, so both packages probe alike
        self.max_probes = max(4, 1 << int(np.ceil(np.log2(maxp))))
        vals = {k: m.pool.whole_rows(v) for k, v in m.pool.fields.items()}
        vals["touched"] = m.pool.whole_rows(m.pool.touched)
        st = m._stored_to_raster_dev(m._state_fn(vals)).to(torch.int8)  # [cap, V]
        guard = torch.full((1, st.shape[1]), posterior.UNKNOWN, dtype=torch.int8,
                           device=dev)
        self.state_tab = torch.cat([st, guard]).contiguous()
        self.res = float(m.cfg.resolution)
        self.bs = float(m.block_size)
        self.n = int(m.n)
        self.device = dev


def raycast_snapshot(m) -> RaycastSnapshot:
    return RaycastSnapshot(m)


def raycast_device(m, origins: np.ndarray, directions: np.ndarray, max_range: float,
                   target_state: int = posterior.OCCUPIED,
                   snapshot: RaycastSnapshot | None = None) -> dict:
    """Batched DDA on the map's device (the contract of :func:`raycast`).

    The snapshot is built per call unless the caller passes one; the
    traversal is one K6 launch.  Directions are normalised in f64, then
    rounded to f32.
    """
    origins = np.atleast_2d(origins).astype(np.float32)
    d = np.atleast_2d(directions).astype(np.float64)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)

    s = snapshot if snapshot is not None else RaycastSnapshot(m)
    max_steps = int(np.ceil(max_range / s.res) * 3 + 8)
    hit, dist, steps = k6.raycast(
        s.state_tab, s.tab_hi, s.tab_lo, s.tab_slot,
        torch.as_tensor(origins, device=s.device), torch.as_tensor(d, device=s.device),
        res=s.res, bs=s.bs, n=s.n, max_steps=max_steps, target=int(target_state),
        max_range=float(max_range), max_probes=s.max_probes)
    hit, dist, steps = hit.cpu().numpy(), dist.cpu().numpy(), steps.cpu().numpy()
    point = origins + d * np.minimum(dist, max_range)[:, None]
    return {"hit": hit, "point": point.astype(np.float32), "distance": dist,
            "steps": steps}
