"""The comparison that decides ``correct``: the program's map against the
reference's, block by block and voxel by voxel.

Numbers (each with a limit in the configuration's check file,
``benchmark/checks/<configuration>.json``):

* ``blocks_apart`` — blocks that only one of the two maps holds;
* ``gap_max`` — over every voxel of the blocks both hold and every posterior
  field, the widest |program − reference| / (1 + |reference|);
* ``gap_q9999`` — the 99.99th percentile over the voxels of each voxel's
  widest such gap;
* ``voxels_apart`` — the share of those voxels whose state (from the
  fields and ``touched``), ``touched`` or leaf level differs;
* ``gap_max_agreeing`` — the widest gap over the voxels that are not
  apart, whose state, ``touched`` and leaf level agree (0 where there is
  none): a sound run's voxel that flips a state at a threshold collapses
  its sibling group differently, and its gap there says nothing of the
  arithmetic, while a wrong value that keeps the state shows here.
"""

from __future__ import annotations

import numpy as np
import torch

#: the gap of a voxel whose value is not finite (kept finite for the JSON line)
HUGE = 1e30


def _keys(coords: np.ndarray) -> np.ndarray:
    c = np.asarray(coords, np.int64) + 524288
    return (c[:, 0] << 40) | (c[:, 1] << 20) | c[:, 2]


def _host(x):
    return x.cpu() if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _aligned(prog: dict, ref: dict, state_fn):
    """The blocks both maps hold, voxel by voxel: (blocks apart, or None
    where there is no common block; else a dict of each side's fields,
    ``touched``, leaf levels and states, the gap [B, V], ``apart`` [B, V]
    and the common blocks' coordinates)."""
    pk, rk = _keys(prog["coords"]), _keys(ref["coords"])
    common, pi, ri = np.intersect1d(pk, rk, return_indices=True)
    apart_blocks = int(len(pk) + len(rk) - 2 * len(common))
    if len(common) == 0:
        return apart_blocks, None
    coords = np.asarray(prog["coords"])[pi]
    pi, ri = torch.as_tensor(pi), torch.as_tensor(ri)
    gap = None
    pv, rv = {}, {}
    for name in ref["fields"]:
        p = _host(prog["fields"][name])[pi].double()
        r = _host(ref["fields"][name])[ri].double()
        g = (p - r).abs() / (1.0 + r.abs())
        g = torch.where(torch.isfinite(g), g, HUGE)          # a NaN or inf is a gap
        gap = g if gap is None else torch.maximum(gap, g)
        pv[name], rv[name] = p.float(), r.float()
    pt, rt = _host(prog["touched"])[pi].bool(), _host(ref["touched"])[ri].bool()
    pe, rf = _host(prog["eff"])[pi].long(), _host(ref["eff"])[ri].long()
    ps = state_fn({**pv, "touched": pt.float()})
    rs = state_fn({**rv, "touched": rt.float()})
    apart = (ps != rs) | (pt != rt) | (pe != rf)
    return apart_blocks, {"prog": pv, "ref": rv, "touched": (pt, rt), "eff": (pe, rf),
                          "state": (ps, rs), "gap": gap, "apart": apart, "coords": coords}


def compare(prog: dict, ref: dict, state_fn) -> dict:
    """The numbers of the module docstring for two maps, each a dict of
    ``coords`` [B, 3], ``fields`` name → [B, V], ``touched`` [B, V] and
    ``eff`` [B, V] (tensors or arrays, any device); ``state_fn(values)`` gives
    the voxels' states from the fields and ``touched`` (float)."""
    blocks_apart, a = _aligned(prog, ref, state_fn)
    out = {"blocks_apart": blocks_apart}
    if a is None:
        return {**out, "gap_max": HUGE, "gap_q9999": HUGE, "voxels_apart": 1.0,
                "gap_max_agreeing": HUGE}
    flat, apart = a["gap"].reshape(-1), a["apart"].reshape(-1)
    out["gap_max"] = float(flat.max())
    out["gap_q9999"] = float(torch.kthvalue(flat, max(1, int(np.ceil(0.9999 * flat.numel()))))[0])
    out["voxels_apart"] = float(apart.double().mean())
    agreeing = flat[~apart]
    out["gap_max_agreeing"] = float(agreeing.max()) if agreeing.numel() else 0.0
    return out


def widest(prog: dict, ref: dict, state_fn) -> dict:
    """Where ``gap_max`` comes from: the block of the widest gap, and each of
    its voxels that is apart or has a gap over 1e-3, with both sides' leaf
    level, state and fields ([program, reference])."""
    _, a = _aligned(prog, ref, state_fn)
    if a is None:
        return {}
    b = int(torch.argmax(a["gap"].max(1).values))
    voxels = []
    for v in torch.nonzero((a["gap"][b] > 1e-3) | a["apart"][b]).reshape(-1).tolist():
        voxels.append({"voxel": v, "gap": float(a["gap"][b, v]), "apart": bool(a["apart"][b, v]),
                       "eff": [int(x[b, v]) for x in a["eff"]],
                       "state": [int(x[b, v]) for x in a["state"]],
                       **{k: [float(a["prog"][k][b, v]), float(a["ref"][k][b, v])]
                          for k in a["ref"]}})
    return {"block": [int(x) for x in a["coords"][b]], "voxels": voxels}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= limits[k] for k in limits)

