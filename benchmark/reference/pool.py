"""The reference's map: a growable pool of blocks, each n³ voxels in raster
order, with the per-scan update and the upstream bottom-up prune
(``bgkoctree.cpp:101-148``), in plain PyTorch.

A voxel's leaf level ``eff`` (0 = the voxel itself) says which octree node
holds it; a scan reads and updates each voxel at that node.  After a scan's
update, every group of 8 sibling leaves at level L − 1 whose states agree
and are not UNKNOWN collapses into its parent: the group takes its first
(minimum-corner) voxel's values and level L.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ingest import f32, pack

FREE, OCCUPIED, UNKNOWN = 0, 1, 2


class Pool:
    """Blocks by coordinate; ``fields`` name → [B, V] f32, ``touched`` [B, V]
    bool, ``eff`` [B, V] int64."""

    def __init__(self, fills: dict, V: int, device):
        self.fills, self.V, self.device = dict(fills), V, device
        self.keys = np.zeros(0, np.int64)           # sorted packed coordinates
        self.rows_of_keys = np.zeros(0, np.int64)
        self.coords = np.zeros((0, 3), np.int64)
        self.fields = {k: torch.zeros((0, V), device=device) for k in fills}
        self.touched = torch.zeros((0, V), dtype=torch.bool, device=device)
        self.eff = torch.zeros((0, V), dtype=torch.int64, device=device)

    def rows(self, coords: torch.Tensor) -> torch.Tensor:
        """Rows of blocks ``coords`` [N, 3], added at their priors where new."""
        c = coords.cpu().numpy()
        keys = pack(torch.zeros(len(c), dtype=torch.int64), torch.as_tensor(c)).numpy()
        pos = np.searchsorted(self.keys, keys)
        hit = (pos < len(self.keys)) & (self.keys[np.minimum(pos, len(self.keys) - 1)] == keys) \
            if len(self.keys) else np.zeros(len(keys), bool)
        new, first = np.unique(keys[~hit], return_index=True)
        if len(new):
            B0, n = len(self.coords), len(new)
            self.coords = np.concatenate([self.coords, c[~hit][first]])
            allk = np.concatenate([self.keys, new])
            allr = np.concatenate([self.rows_of_keys, np.arange(B0, B0 + n)])
            o = np.argsort(allk)
            self.keys, self.rows_of_keys = allk[o], allr[o]
            dev, V = self.device, self.V
            for k, fill in self.fills.items():
                self.fields[k] = torch.cat([self.fields[k],
                                            torch.full((n, V), fill, device=dev)])
            self.touched = torch.cat([self.touched,
                                      torch.zeros((n, V), dtype=torch.bool, device=dev)])
            self.eff = torch.cat([self.eff, torch.zeros((n, V), dtype=torch.int64, device=dev)])
        rows = self.rows_of_keys[np.searchsorted(self.keys, keys)]
        return torch.as_tensor(rows, device=self.device)


def _groups(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """[B, n³] raster → [B, (n/m)³, m³], each 2^L-aligned cube a row whose
    element 0 is its minimum corner."""
    g = n // m
    return x.reshape(-1, g, m, g, m, g, m).permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, g ** 3, m ** 3)


def _ungroup(x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    g = n // m
    return x.reshape(-1, g, g, g, m, m, m).permute(0, 1, 4, 2, 5, 3, 6).reshape(-1, n ** 3)


def prune(values: dict, eff: torch.Tensor, n: int, levels: int, state_fn):
    """Collapse every uniform, known sibling group, level by level."""
    state = state_fn(values)
    for L in range(1, levels):
        m = 1 << L
        st, ef = _groups(state, n, m), _groups(eff, n, m)
        coll = ((ef == L - 1).all(-1) & (st == st[..., :1]).all(-1)
                & (st[..., 0] != UNKNOWN))[..., None]

        def take(x):
            g = _groups(x, n, m)
            return _ungroup(torch.where(coll, g[..., :1], g), n, m)

        values = {k: take(v) for k, v in values.items()}
        state = take(state)
        eff = _ungroup(torch.where(coll, L, ef), n, m)
    return values, eff


def beta_state(v: dict, var_thresh: float, free_thresh: float, occupied_thresh: float):
    """Upstream ``bgkoctree_node.cpp:27-44``: p = A/(A+B), var =
    AB/((A+B)²(A+B+1)); UNKNOWN where var > var_thresh or untouched."""
    A, B = v["A"], v["B"]
    s = A + B
    prob, var = A / s, (A * B) / (s * s * (s + 1.0))
    st = torch.where(prob > f32(occupied_thresh), OCCUPIED,
                     torch.where(prob < f32(free_thresh), FREE, UNKNOWN))
    st = torch.where(var > f32(var_thresh), UNKNOWN, st)
    return torch.where(v["touched"] > 0, st, UNKNOWN)


def gp_state(v: dict, l: float, max_ivar: float, min_known_ivar: float, free_thresh: float,
             occupied_thresh: float):
    """Upstream ``gpoctree_node.cpp:31-49``: p = 1/(1 + exp(−l·m_ivar/max_ivar));
    UNKNOWN where ivar < min_known_ivar or untouched."""
    p = 1.0 / (1.0 + torch.exp(-f32(l) * v["m_ivar"] / f32(max_ivar)))
    st = torch.where(p > f32(occupied_thresh), OCCUPIED,
                     torch.where(p < f32(free_thresh), FREE, UNKNOWN))
    st = torch.where(v["ivar"] < f32(min_known_ivar), UNKNOWN, st)
    return torch.where(v["touched"] > 0, st, UNKNOWN)


def apply_scan(pool: Pool, rows: torch.Tensor, new: dict, touched: torch.Tensor, *, n: int,
               levels: int, state_fn) -> None:
    """Write one scan's updated values of blocks ``rows``, then prune them."""
    vals = dict(new)
    vals["touched"] = (pool.touched[rows] | touched).to(torch.float32)
    eff = pool.eff[rows]
    if levels > 1:
        vals, eff = prune(vals, eff, n, levels, state_fn)
    for k in pool.fields:
        pool.fields[k][rows] = vals[k]
    pool.touched[rows] = vals["touched"] > 0
    pool.eff[rows] = eff
