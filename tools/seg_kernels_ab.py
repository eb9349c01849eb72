#!/usr/bin/env python3
"""K3 (the BGKLV tile row engine), K1 (the BGK and BGKL heavy pass, both
branches), K1′ (the device-ingest heavy pass, both branches), K2 (the BGK
light pass), K5 (the GP light pass), K6 (the raycast DDA), K7 (device
ingest: K7a, K7b, K7c, K7s, K7t, BGKL's K7d) and K8 (the BGKLV prune) of two
checkouts on the same captured inputs, in one call.

Run from the repository root on a machine with one CUDA card, with the
other checkout unpacked into a directory that .gitignore lists:

    git archive <parent> | tar -x -C .archive/parent
    python3 tools/seg_kernels_ab.py .archive/parent [--only k2,k7]

``--only`` keeps the captured inputs whose names start with one of the
given prefixes and drops the main-path runs (run_static, OnlineIntegrator,
raycast_device).

This checkout captures the inputs from chip_smoke.py's synthetic scans:
K3 on a 12-scan BGKLV demo dispatch and on one BGKLV large-map scan
(block_depth 6), K1 on a 16-scan BGKL demo dispatch and on a 12-scan BGKL
large-map dispatch (block_depth 5, segments) and on a 16-scan BGK demo
host-ingest dispatch (points), K1′ on the device-ingest dispatches of 16
BGK demo scans (points), 16 BGKL demo scans and 12 BGKL large-map scans
(segments), K6 on chip_smoke.py's three raycast queries (1,000,000 rays
into the 60-scan BGK demo map, 100,000 into the BGKL and BGKLV maps), and
the arguments of one device-ingest dispatch (``ingest_batch`` or
``ingest_batch_bgkl``) of the BGK, GP and BGKL demos (16 scans) and the
BGKL and BGK large maps (12 scans), K2 on the accumulator (K1's, made by
this checkout) and pool of a 16-scan BGK demo host-ingest dispatch (4³
voxels a block) and of a 12-scan BGKL large-map dispatch (16³), K5 on the
prediction tables (K4's, made by this checkout) and pool of a 16-scan GP
demo dispatch (4³), a 12-scan GP large-map dispatch (8³) and a 12-scan GP
block_depth-5 dispatch (16³), and K8 on the prune of one BGKLV large-map
scan (32³).  K2, K5 and K8 also run from the same blocks made collapsible
(chip_smoke.py's ``collapsible_pool``) and near-collapsible
(``kernels/group_prune.py::near_collapsible_rows``); each pool after is
hashed, and each kernel is timed with its prune (K2's and K5's
``do_prune``, K8's levels) and without it (``do_prune=False``; K8 the
levels inside a tile, ``max_level`` 3), which splits its time between the
prune and the rest, and its call is timed by CUDA events (the host's work
between launches included: each wrapper's checks and scratch).  Then each
checkout, in the order other, this, this, other, runs in a process of
its own (importing its own ``la3dm_tpu_torch`` and building its own
kernels): it times each kernel (chip_smoke.py's ``launch_ms``: device time
of launches queued behind a spin), hashes its outputs (K3: A, B and
touched; K1 and K1′: the accumulator; K6: hit, dist and steps; K7: every
table of the dispatch, the entry columns on their valid rows, which a
checkout may pad), and runs ``pipeline.run_static`` for BGKLV (60 demo
scans, 12 large-map scans), the BGKL large map (12 scans, host and device
ingest), the BGK demo (60 scans, device and host ingest) and the GP demo
(60 scans, device ingest) and, on host ingest, the GP large map and GP at
block_depth 5 (12 scans each), hashing the device-ingest, GP and BGKLV
maps, times
``OnlineIntegrator`` on 12 scans of the BGK, GP and BGKL demos (device
ingest), then times ``raycast_device`` over the 1,000,000 rays on its own
60-scan BGK demo map.  K7's times: the whole dispatch's call (CUDA events,
its host syncs inside), each K7a, K7b, K7c, K7s and K7t launch of it as
chip_smoke.py's ``launch_ms`` times them, each K7a launch and each sort
alone (the membership sort is the third of the point family's four, the
candidate sort the last), and K7t with the candidate sort that feeds it; the
beam slots kept; on the BGKL dispatches K7d's call, its outputs hashed, its
device time from torch.profiler (every kernel, copy and memset of the
call, the host's wait between its launches left out, the same measure for
both checkouts) and the call with its wait by CUDA events.  The last lines
compare: times of both, and whether each output is bit-equal across the
checkouts.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISPATCHES = ("k3_demo", "k3_large", "k1_demo", "k1_large", "k1_bgk_demo", "k1p_bgk_demo",
              "k1p_demo", "k1p_large", "k6_bgk", "k6_bgkl", "k6_bgklv", "k7_bgk_demo",
              "k7_gp_demo", "k7_bgkl_demo", "k7_bgkl_large", "k7_bgk_large", "k2_bgk_demo",
              "k2_bgkl_large", "k5_gp_demo", "k5_gp_large", "k5_gp_depth5", "k8_lv_large")
REPS = {"k3_demo": 5, "k3_large": 5, "k1_demo": 5, "k1_large": 3, "k1_bgk_demo": 5,
        "k1p_bgk_demo": 5, "k1p_demo": 5, "k1p_large": 3, "k6_bgk": 5, "k6_bgkl": 5,
        "k6_bgklv": 5, "k7_bgk_demo": 5, "k7_gp_demo": 5, "k7_bgkl_demo": 5,
        "k7_bgkl_large": 3, "k7_bgk_large": 3, "k2_bgk_demo": 10, "k2_bgkl_large": 10,
        "k5_gp_demo": 10, "k5_gp_large": 10,
        "k5_gp_depth5": 10, "k8_lv_large": 20}
#: K2's, K5's and K8's start pools: the captured one, then the same blocks made
#: collapsible and near-collapsible
POOLS = ("real", "collapsible", "near")


def selected(only) -> list:
    """The names of :data:`DISPATCHES` that start with one of the prefixes
    ``only`` (all of them for None)."""
    return [d for d in DISPATCHES if only is None or d.startswith(tuple(only))]
#: the K7 tables hashed; the entry columns on their valid rows
K7_ROWS = ("ent", "ent_rel", "lab")
K7_TABLES = ("ukey", "ustart", "ucount", "tkey", "nb_row", "tb_u")


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def capture_ingest(cfg, scans):
    """The arguments of the device-ingest call of one dispatch of ``scans``
    on a CUDA map of ``cfg``: (args, kwargs with the function's name)."""
    from la3dm_tpu_torch import pipeline
    from la3dm_tpu_torch.geometry import device_ingest as di

    rec = []
    fns = {n: getattr(di, n) for n in ("ingest_batch", "ingest_batch_bgkl")}
    for n, f in fns.items():
        setattr(di, n, lambda *a, _f=f, _n=n, **k: (rec.append((_n, a, k)), _f(*a, **k))[1])
    try:
        m = pipeline.MAP_CLASSES[cfg.method](cfg, device="cuda")
        m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans])
    finally:
        for n, f in fns.items():
            setattr(di, n, f)
    (name, args, kw), = rec
    return args, {**kw, "fn": name}


def k2_inputs(cs, cfg, scans):
    """K2's inputs of one host-ingest BGK or BGKL dispatch of ``scans``: the
    pool, the same blocks made collapsible and near-collapsible, the
    dispatch's accumulator as K1 fills it (this checkout's), the node table
    and the block lists.  Returns (tensors, kwargs)."""
    import dataclasses

    from la3dm_tpu_torch.kernels import bgk_heavy

    args, st = cs.capture_dispatch(cfg, scans, "cuda")
    (_, _, _, _, all_nodes, node_idx, ent, lab, ids, gs, rb, rs, rn, slots, ctr, ss,
     sc) = args
    acc = bgk_heavy.bgk_heavy(ent, lab, ids, gs, rb, rs, rn, ctr, all_nodes, G=st["G"],
                              sf2=st["sf2"], ell=st["ell"])
    pool0, n = list(args[:4]), st["n"]
    pools = pool0 + cs.collapsible_pool(pool0, slots, n, templates=cs.BETA_TEMPLATES,
                                        raster=True)
    pools += cs.near_collapsible_pool(pool0, slots, n, cs.BGK_NEAR_VALUES, raster=True)
    kw = {k: st[k] for k in ("G", "gate", "n", "max_level")}
    kw.update(ss=[int(x) for x in ss], sc=[int(x) for x in sc],
              state=dataclasses.asdict(st["state_fn"]))
    return [*pools, acc, node_idx, slots], kw


def k5_inputs(cs, cfg, scans):
    """K5's inputs of one host-ingest GP dispatch of ``scans``: the pool,
    the dispatch's prediction tables as K4 fills them (this checkout's),
    the node table and the block lists; the same blocks made collapsible
    and near-collapsible.  Returns (tensors, kwargs)."""
    import dataclasses

    import torch

    from la3dm_tpu_torch.kernels import gp_heavy

    args, st = cs.capture_gp(cfg, scans, run_step=False)
    all_nodes, pts, lab, tiers, centers = args[4], args[6], args[7], args[8], args[10]
    G, T, Vall = st["G"], centers.shape[0], all_nodes.shape[0]
    am = torch.zeros((T * G, Vall), device="cuda")
    av = torch.ones((T * G, Vall), device="cuda")
    pr = torch.zeros(T * G, dtype=torch.bool, device="cuda")
    failed = torch.zeros(1, dtype=torch.int32, device="cuda")
    for s, c, nb, hc in tiers:
        gp_heavy.gp_heavy(pts, lab, s, c, nb, centers, all_nodes, am, av, pr, failed,
                          host_counts=hc, sf2=st["sf2"], ell=st["ell"], noise=st["noise"])
    pool0, node_idx, slots = list(args[:4]), args[5], args[9]
    n = st["n"]
    pools = pool0 + cs.collapsible_pool(pool0, slots, n, templates=cs.GP_TEMPLATES,
                                        raster=True)
    pools += cs.near_collapsible_pool(pool0, slots, n, cs.GP_NEAR_VALUES, raster=True)
    kw = {k: st[k] for k in ("G", "sf2", "min_known_ivar", "max_ivar", "n", "max_level")}
    kw.update(ss=[int(x) for x in args[11]], sc=[int(x) for x in args[12]],
              state=dataclasses.asdict(st["state_fn"]))
    return [*pools, am, av, pr, node_idx, slots], kw


def k8_inputs(cs, m):
    """K8's inputs of the last prune of the BGKLV map ``m``: the pool, the
    same blocks made collapsible and near-collapsible, the slots."""
    import dataclasses

    (args, st) = m._last_prune_call
    pool0, slots, n = list(args[:4]), args[4], st["n"]
    pools = pool0 + cs.collapsible_pool(pool0, slots, n)
    pools += cs.near_collapsible_pool(pool0, slots, n, cs.LV_NEAR_VALUES)
    return [*pools, slots], {"n": n, "max_level": st["max_level"],
                             "state": dataclasses.asdict(st["state_fn"])}


def capture(out_dir: str, only=None) -> None:
    """Capture the inputs with this checkout (those named ``only``, else
    all) and write the PCDs."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from la3dm_tpu_torch import pipeline
    from la3dm_tpu_torch.models import posterior, raycast as rc
    from la3dm_tpu_torch.utils.config import DatasetConfig, load_method_config

    scans = cs.synthetic_scans(60)
    cs.write_pcds(scans, out_dir)
    cfg_lv = load_method_config("bgklv", max_range=cs.MAX_RANGE)
    cfg_lv_large = load_method_config("bgklvoctomap_large_map", max_range=cs.MAX_RANGE)
    cfg_l = load_method_config("bgkl", max_range=cs.MAX_RANGE, device_ingest="off")
    cfg_ll = load_method_config("bgkloctomap_large_map", device_ingest="off")
    cfg_b = load_method_config("bgk", max_range=cs.MAX_RANGE, device_ingest="off")
    cfg_gp = load_method_config("gp", max_range=cs.MAX_RANGE, device_ingest="off")
    cfg_gp_large = load_method_config("gpoctomap_large_map", max_range=cs.MAX_RANGE,
                                      device_ingest="off")
    cfg_gp5 = load_method_config("gpoctomap_large_map", block_depth=5,
                                 max_range=cs.MAX_RANGE, device_ingest="off")
    lv_large = []  # the BGKLV large map, captured once for K3 and K8

    def lv_large_map():
        if not lv_large:
            lv_large.append(cs.capture_lv(cfg_lv_large, scans[:4]))
        return lv_large[0]

    def k1(cfg, n):
        args, statics = cs.capture_dispatch(cfg, scans[:n], "cuda")
        (_, _, _, _, all_nodes, _, ent, lab, ids, gs, rb, rs, rn, _, ctr, _, _) = args
        kw = dict(G=statics["G"], sf2=statics["sf2"], ell=statics["ell"])
        return (ent, lab, ids, gs, rb, rs, rn, ctr, all_nodes), kw

    def k1p(cfg, n):
        (args, kw, _), = cs.record_ingest(cfg, scans[:n])["bgk_aligned_heavy"]
        return args, kw

    # K6: chip_smoke.py's three queries (its maps, rays and arguments)
    ds60 = DatasetConfig(name="synth", dir=out_dir, prefix="synth", scan_num=60,
                         max_range=cs.MAX_RANGE)

    def k6(name, method, n, seed):
        snap = rc.raycast_snapshot(pipeline.run_static(
            load_method_config(method, max_range=cs.MAX_RANGE), ds60).map)
        o, d = cs.ray_set(scans, n, seed)
        if name == "k6_bgk":
            np.save(os.path.join(out_dir, "rays_o.npy"), o)
            np.save(os.path.join(out_dir, "rays_d.npy"), d)
        dn = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        args = (snap.state_tab, snap.tab_hi, snap.tab_lo, snap.tab_slot,
                torch.as_tensor(o), torch.as_tensor(dn))
        kw = dict(res=snap.res, bs=snap.bs, n=snap.n,
                  max_steps=int(np.ceil(cs.MAX_RANGE / snap.res) * 3 + 8),
                  target=posterior.OCCUPIED, max_range=cs.MAX_RANGE,
                  max_probes=snap.max_probes)
        return args, kw

    makers = {
        "k3_demo": lambda: cs.capture_lv(cfg_lv, scans[:12])._last_step_call,
        "k3_large": lambda: lv_large_map()._last_step_call,
        "k1_demo": lambda: k1(cfg_l, 16), "k1_large": lambda: k1(cfg_ll, 12),
        "k1_bgk_demo": lambda: k1(cfg_b, 16),
        "k1p_bgk_demo": lambda: k1p(load_method_config("bgk", max_range=cs.MAX_RANGE), 16),
        "k1p_demo": lambda: k1p(load_method_config("bgkl", max_range=cs.MAX_RANGE), 16),
        "k1p_large": lambda: k1p(load_method_config("bgkloctomap_large_map"), 12),
        "k6_bgk": lambda: k6("k6_bgk", "bgk", cs.RAYS_MAIN, 1),
        "k6_bgkl": lambda: k6("k6_bgkl", "bgkl", cs.RAYS_OTHER, 2),
        "k6_bgklv": lambda: k6("k6_bgklv", "bgklv", cs.RAYS_OTHER, 3),
        "k7_bgk_demo": lambda: capture_ingest(
            load_method_config("bgk", max_range=cs.MAX_RANGE), scans[:16]),
        "k7_gp_demo": lambda: capture_ingest(
            load_method_config("gp", max_range=cs.MAX_RANGE), scans[:16]),
        "k7_bgkl_demo": lambda: capture_ingest(
            load_method_config("bgkl", max_range=cs.MAX_RANGE), scans[:16]),
        "k7_bgkl_large": lambda: capture_ingest(
            load_method_config("bgkloctomap_large_map"), scans[:12]),
        "k7_bgk_large": lambda: capture_ingest(
            load_method_config("bgkoctomap_large_map"), scans[:12]),
        "k2_bgk_demo": lambda: k2_inputs(cs, cfg_b, scans[:16]),
        "k2_bgkl_large": lambda: k2_inputs(cs, cfg_ll, scans[:12]),
        "k5_gp_demo": lambda: k5_inputs(cs, cfg_gp, scans[:16]),
        "k5_gp_large": lambda: k5_inputs(cs, cfg_gp_large, scans[:12]),
        "k5_gp_depth5": lambda: k5_inputs(cs, cfg_gp5, scans[:12]),
        "k8_lv_large": lambda: k8_inputs(cs, lv_large_map()),
    }
    caps = {name: makers[name]() for name in selected(only)}
    for name, (args, kw) in caps.items():
        torch.save(([a.cpu() for a in args], kw), os.path.join(out_dir, f"{name}.pt"))


def _pool_digest(m) -> str:
    p = m.pool
    return _digest(*(p.fields[k] for k in sorted(p.fields)), p.touched, p.eff_level)


def device_ms(cs, fn, reps: int, kernel: str, per_call: int) -> float:
    """Device time (ms) of one call of ``fn``: every kernel, copy and memset
    of ``reps`` calls under torch.profiler (``cs.profiled``, a session
    holding ``per_call`` launches a call of kernels named ``kernel``), over
    ``reps``; the host's gaps and waits are left out."""
    from torch.autograd import DeviceType

    prof, _ = cs.profiled(lambda: [fn() for _ in range(reps)], {kernel: per_call * reps})
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def k7_run(args, kw, reps: int, cs) -> dict:
    """One device-ingest dispatch of this checkout: its tables' digest, the
    whole call's device time (CUDA events, its host syncs inside,
    ``cs.cuda_ms``), each K7a, K7b, K7c, K7s and K7t launch of it timed by
    ``cs.launch_ms`` (``cs``: the checkout's chip_smoke), each K7a launch
    and each sort alone (``k7a_each_ms``: the raw points, then the beams;
    ``k7s_each_ms``), K7t with the candidate sort that feeds it (the last
    sort), the beam samples kept and the beam slots; BGKL's K7d call
    hashed (occ, seg, inr, the pair list) and timed by :func:`device_ms` and
    by ``cs.cuda_ms`` (its wait inside).  Keyword arguments the checkout's
    function does not take are dropped."""
    import inspect

    import torch

    from la3dm_tpu_torch.geometry import device_ingest
    from la3dm_tpu_torch.kernels import (ingest_beams, ingest_bucket, ingest_downsample,
                                         ingest_keys, ingest_members, ingest_rays,
                                         ingest_sort)
    kw = dict(kw)
    fn = getattr(device_ingest, kw.pop("fn"))
    kw = {k: v for k, v in kw.items() if k in inspect.signature(fn).parameters}
    wrapped = [(ingest_beams, "point_keys", "k7a"), (ingest_beams, "beam_samples", "k7a"),
               (ingest_downsample, "centroids", "k7b"), (ingest_rays, "ray_pairs", "k7d"),
               (ingest_members, "memberships", "k7c"), (ingest_sort, "sort_runs", "k7s"),
               (ingest_bucket, "bucket", "k7t")]
    calls = {tag: [] for _, _, tag in wrapped}
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in wrapped]

    def recorder(orig, tag):
        def rec(*a, **k):
            res = orig(*a, **k)
            calls[tag].append((orig, a, k, res))
            return res
        return rec

    for (mod, name, tag), (_, _, orig) in zip(wrapped, saved):
        setattr(mod, name, recorder(orig, tag))
    try:
        tabs = fn(*args, **kw)
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    torch.cuda.synchronize()
    M = int(tabs["ucount"].sum())
    out = {"digest": _digest(*(tabs[k][:M] for k in K7_ROWS),
                             *(tabs[k] for k in K7_TABLES)),
           "rows": M, "blocks": int(tabs["ukey"].shape[0])}
    again = fn(*args, **kw)
    out["repeat_equal"] = _digest(*(again[k][:M] for k in K7_ROWS),
                                  *(again[k] for k in K7_TABLES)) == out["digest"]
    out["ms"] = cs.cuda_ms(lambda _: fn(*args, **kw), reps)

    def timed(f, a, k):
        return lambda _: (ingest_sort.launch if f is ingest_sort.sort_runs else f)(*a, **k)

    for tag in ("k7a", "k7b", "k7c", "k7s", "k7t"):
        out[f"{tag}_ms"] = cs.launch_ms([timed(f, a, k) for f, a, k, _ in calls[tag]], reps)
        out[f"{tag}_launches"] = len(calls[tag])
    for tag in ("k7a", "k7s"):
        out[f"{tag}_each_ms"] = [cs.launch_ms([timed(f, a, k)], reps)
                                 for f, a, k, _ in calls[tag]]
    out["k7t_with_candidates_ms"] = out["k7t_ms"] + out["k7s_each_ms"][-1]
    beams = [res for f, _, _, res in calls["k7a"] if f.__name__ == "beam_samples"]
    if beams:
        keys = beams[0][1]
        out["k7a_slots"] = int(keys.numel())
        # the compact layout leaves its count on the card; the dense one
        # marks a dropped slot with the sentinel
        out["k7a_kept"] = int(beams[0][3]) if len(beams[0]) > 3 \
            else int((keys != ingest_keys.SENT).sum())
    if calls["k7d"]:
        (_, a, k, _), = calls["k7d"]
        rays = ingest_rays.ray_pairs(*a, **k)
        out["k7d_digest"] = _digest(*rays[:5])
        out["k7d_pairs"] = int(rays[3].numel())
        out["k7d_device_ms"] = device_ms(cs, lambda: ingest_rays.ray_pairs(*a, **k), reps,
                                         "ingest_rays", 2)
        out["k7d_call_ms"] = cs.cuda_ms(lambda _: ingest_rays.ray_pairs(*a, **k), reps)
    return out


def prune_run(name: str, args, kw, reps: int, cs) -> dict:
    """K2, K5 or K8 of this checkout on one captured input: from each start
    pool of :data:`POOLS`, the pool after (hashed; a second run from the
    same start bit-equal) and its voxels by eff level on the input's blocks;
    from the real pool, the time of the launches (``cs.launch_ms``) with the
    prune and without it (K2 and K5 ``do_prune=False``, K8 ``max_level``
    3)."""
    import torch

    from la3dm_tpu_torch.kernels import bgk_light, gp_light, lv_prune
    from la3dm_tpu_torch.models import posterior

    kw = dict(kw)
    starts = [args[4 * i:4 * i + 4] for i in range(len(POOLS))]
    rest = args[4 * len(POOLS):]
    slots = rest[-1]
    if name.startswith("k2"):
        acc, node_idx, _ = rest
        ss, sc = kw.pop("ss"), kw.pop("sc")
        sf = posterior.BetaStateFn(**kw.pop("state"))

        def calls(prune: bool) -> list:
            return [lambda st, s=s, c=c: bgk_light.bgk_light(
                acc, *st, node_idx, slots, s, c, **kw, state_fn=sf, do_prune=prune)
                for s, c in zip(ss, sc)]
    elif name.startswith("k5"):
        am, av, pr, node_idx, _ = rest
        ss, sc = kw.pop("ss"), kw.pop("sc")
        sf = posterior.GPStateFn(**kw.pop("state"))

        def calls(prune: bool) -> list:
            return [lambda st, s=s, c=c: gp_light.gp_light(
                am, av, pr, *st, node_idx, slots, s, c, **kw, state_fn=sf, do_prune=prune)
                for s, c in zip(ss, sc)]
    else:
        sf = posterior.LVStateFn(**kw.pop("state"))

        def calls(prune: bool) -> list:
            k = dict(kw, max_level=kw["max_level"] if prune else min(3, kw["max_level"]))
            return [lambda st: lv_prune.lv_prune(*st, slots, **k, state_fn=sf)]

    sl = slots.long()
    sl = torch.unique(sl[sl < starts[0][0].shape[0]])
    out = {"launches": len(calls(True))}
    for tag, start in zip(POOLS, starts):
        runs = []
        for _ in range(2):
            st = [x.clone() for x in start]
            for call in calls(True):
                call(st)
            runs.append(st)
        torch.cuda.synchronize()
        out[f"{tag}_digest"] = _digest(*runs[0])
        out[f"{tag}_repeat_equal"] = all(torch.equal(x, y) for x, y in zip(*runs))
        out[f"{tag}_levels"] = [int((runs[0][3][sl] == L).sum())
                                for L in range(kw["max_level"] + 1)]
    out["digest"] = "/".join(out[f"{tag}_digest"] for tag in POOLS)

    def pool():
        return [x.clone() for x in starts[0]]

    out["ms"] = cs.launch_ms(calls(True), reps, setup=pool)
    out["ms_without_prune"] = cs.launch_ms(calls(False), reps, setup=pool)
    out["call_ms"] = cs.cuda_ms(lambda st: [call(st) for call in calls(True)], reps,
                                setup=pool)
    return out


def online_median(cfg, scans) -> float:
    """OnlineIntegrator over ``scans`` on a CUDA map: the median ms from an
    offer to its synchronised end."""
    import numpy as np

    from la3dm_tpu_torch import pipeline

    m = pipeline.MAP_CLASSES[cfg.method](cfg)
    online = pipeline.OnlineIntegrator(m)
    lat = []
    for cloud, origin in scans:
        t0 = time.perf_counter()
        online.offer(cloud, origin)
        m.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(lat))


def worker(tree: str, data_dir: str, only=None) -> dict:
    """Time and hash the kernels of checkout ``tree`` on the captured inputs
    (those named ``only``, else all); without ``only``, run its main
    paths."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import numpy as np

    import chip_smoke as cs  # the checkout's own (its launch_ms)
    from la3dm_tpu_torch import pipeline
    from la3dm_tpu_torch.kernels import _build, bgk_aligned_heavy, bgk_heavy, lv_rows, raycast
    from la3dm_tpu_torch.models import raycast as rc
    from la3dm_tpu_torch.utils.config import DatasetConfig, load_method_config

    assert os.path.dirname(lv_rows.__file__).startswith(os.path.abspath(tree))
    _build.lib()
    out = {"tree": tree}
    for name in selected(only):
        args, kw = torch.load(os.path.join(data_dir, f"{name}.pt"))
        args = [a.cuda() for a in args]
        if name.startswith(("k2", "k5", "k8")):
            out[name] = prune_run(name, args, kw, REPS[name], cs)
            del args
            torch.cuda.empty_cache()
            continue
        if name.startswith("k3"):
            pool0, rest = args[:4], args[4:]

            def pool():
                return [x.clone() for x in pool0]

            k = pool()
            lv_rows.lv_rows(*k, *rest, **kw)
            torch.cuda.synchronize()
            digest = _digest(*k[:3])
            ms = cs.launch_ms([lambda st: lv_rows.lv_rows(*st, *rest, **kw)], REPS[name],
                              setup=pool)
            again = pool()
            lv_rows.lv_rows(*again, *rest, **kw)
            repeat = all(torch.equal(x, y) for x, y in zip(k, again))
        elif name.startswith("k7"):
            out[name] = k7_run(args, kw, REPS[name], cs)
            del args
            torch.cuda.empty_cache()
            continue
        elif name.startswith("k6"):
            digest = _digest(*raycast.raycast(*args, **kw))
            ms = cs.launch_ms([lambda _: raycast.raycast(*args, **kw)], REPS[name])
            repeat = _digest(*raycast.raycast(*args, **kw)) == digest
        else:
            fn = bgk_aligned_heavy.bgk_aligned_heavy if name.startswith("k1p") \
                else bgk_heavy.bgk_heavy
            acc = fn(*args, **kw)
            torch.cuda.synchronize()
            digest = _digest(acc)
            del acc
            ms = cs.launch_ms([lambda _: fn(*args, **kw)], REPS[name])
            repeat = _digest(fn(*args, **kw)) == digest
        out[name] = {"ms": ms, "digest": digest, "repeat_equal": repeat}
        del args
        torch.cuda.empty_cache()
    out["card"] = torch.cuda.get_device_name(0)
    if only is not None:
        return out

    runs = (("bgklv_static60", load_method_config("bgklv", max_range=cs.MAX_RANGE), 60, 2),
            ("bgklv_large12", load_method_config("bgklvoctomap_large_map",
                                                 max_range=cs.MAX_RANGE), 12, 2),
            ("bgkl_large12_host", load_method_config("bgkloctomap_large_map",
                                                     device_ingest="off"), 12, 3),
            ("bgkl_large12_device", load_method_config("bgkloctomap_large_map"), 12, 3),
            ("bgk_static60_device", load_method_config("bgk", max_range=cs.MAX_RANGE), 60,
             3),
            ("bgk_static60_host", load_method_config("bgk", max_range=cs.MAX_RANGE,
                                                     device_ingest="off"), 60, 3),
            ("gp_static60_device", load_method_config("gp", max_range=cs.MAX_RANGE), 60, 3),
            ("gp_large12_host", load_method_config("gpoctomap_large_map",
                                                   max_range=cs.MAX_RANGE,
                                                   device_ingest="off"), 12, 2),
            ("gp_depth5_large12_host", load_method_config(
                "gpoctomap_large_map", block_depth=5, max_range=cs.MAX_RANGE,
                device_ingest="off"), 12, 2))
    for name, cfg, n, reps in runs:
        ds = DatasetConfig(name="synth", dir=data_dir, prefix="synth", scan_num=n,
                           max_range=cfg.max_range)
        pipeline.run_static(cfg, ds)  # warm-up
        res = [pipeline.run_static(cfg, ds) for _ in range(reps)]
        out[name] = [r.scans_per_second for r in res]
        if name.endswith("_device") or name.startswith(("bgklv", "gp")):
            out[f"{name}_map"] = _pool_digest(res[-1].map)
    scans = cs.synthetic_scans(12)
    for method in ("bgk", "gp", "bgkl"):
        cfg = load_method_config(method, max_range=cs.MAX_RANGE)
        online_median(cfg, scans[:2])  # warm-up
        out[f"{method}_online12_device_median_ms"] = [online_median(cfg, scans)
                                                      for _ in range(2)]
    # one raycast_device call over the 1,000,000 rays, host clock to its end
    # (copies included), on this checkout's 60-scan BGK demo map
    ds = DatasetConfig(name="synth", dir=data_dir, prefix="synth", scan_num=60,
                       max_range=cs.MAX_RANGE)
    m = pipeline.run_static(load_method_config("bgk", max_range=cs.MAX_RANGE), ds).map
    snap = rc.raycast_snapshot(m)
    o, d = (np.load(os.path.join(data_dir, f"rays_{k}.npy")) for k in "od")
    out["raycast_device_ms"] = []
    for _ in range(4):  # the first is a warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc.raycast_device(m, o, d, cs.MAX_RANGE, snapshot=snap)
        out["raycast_device_ms"].append((time.perf_counter() - t0) * 1e3)
    out["raycast_device_ms"] = out["raycast_device_ms"][1:]
    return out


def main() -> int:
    argv = sys.argv[1:]
    only = None
    if "--only" in argv:
        at = argv.index("--only")
        only = argv[at + 1].split(",")
        del argv[at:at + 2]
    if len(argv) == 3 and argv[0] == "--worker":
        print("AB " + json.dumps(worker(argv[1], argv[2], only)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("seg_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(argv) != 1 or (only is not None and not selected(only)):
        print(__doc__, file=sys.stderr)
        return 2
    other = argv[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    # build both checkouts' kernels side by side while this one captures
    builds = [subprocess.Popen([sys.executable, "-c",
                                "from la3dm_tpu_torch.kernels import _build; _build.lib()"],
                               cwd=t) for t in (other, ROOT)]
    for b in builds:
        if b.wait() != 0:
            raise RuntimeError("a kernel build failed")
    results = []
    with tempfile.TemporaryDirectory(prefix="seg_ab_") as tmp:
        t0 = time.perf_counter()
        capture(tmp, only)
        print(f"captured in {time.perf_counter() - t0:.1f} s", flush=True)
        for tree in (other, ROOT, ROOT, other):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                                   tree, tmp] + (["--only", ",".join(only)] if only else []),
                                  capture_output=True, text=True)
            line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
            if proc.returncode != 0 or not line:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"the worker for {tree} failed")
            res = json.loads(line[0][3:])
            res["tree"] = "other" if tree == other else "this"
            print(json.dumps(res), flush=True)
            results.append(res)
    o1, t1, t2, o2 = results
    for name in selected(only):
        same = len({r[name]["digest"] for r in results}) == 1
        if name.startswith(("k2", "k5", "k8")):
            pools = "; ".join(
                f"{tag} pool bit-equal across checkouts "
                f"{len({r[name][tag + '_digest'] for r in results}) == 1}, repeat runs "
                f"{all(r[name][tag + '_repeat_equal'] for r in results)}, voxels by eff "
                f"level {t1[name][tag + '_levels']}" for tag in POOLS)
            print(f"{name}: {t1[name]['launches']} launches; other {o1[name]['ms']:.4f}, "
                  f"{o2[name]['ms']:.4f} ms / this {t1[name]['ms']:.4f}, "
                  f"{t2[name]['ms']:.4f} ms; without the prune other "
                  f"{o1[name]['ms_without_prune']:.4f}, {o2[name]['ms_without_prune']:.4f} / "
                  f"this {t1[name]['ms_without_prune']:.4f}, "
                  f"{t2[name]['ms_without_prune']:.4f} ms; the call other "
                  f"{o1[name]['call_ms']:.4f}, {o2[name]['call_ms']:.4f} / this "
                  f"{t1[name]['call_ms']:.4f}, {t2[name]['call_ms']:.4f} ms; {pools}")
            continue
        if name.startswith("k7"):
            parts = "; ".join(
                f"{tag} other {o1[name].get(tag + '_ms')}, {o2[name].get(tag + '_ms')} / this "
                f"{t1[name].get(tag + '_ms')}, {t2[name].get(tag + '_ms')} ms "
                f"({t1[name].get(tag + '_launches')} launches)"
                for tag in ("k7a", "k7b", "k7c", "k7s", "k7t"))
            for tag, what in (("k7a", "each K7a launch alone (points, beams)"),
                              ("k7s", "each sort alone")):
                parts += (f"; {what} other {o1[name][tag + '_each_ms']}, "
                          f"{o2[name][tag + '_each_ms']} / this {t1[name][tag + '_each_ms']}, "
                          f"{t2[name][tag + '_each_ms']} ms")
            parts += (f"; K7t with the candidate sort other "
                      f"{o1[name]['k7t_with_candidates_ms']:.4f}, "
                      f"{o2[name]['k7t_with_candidates_ms']:.4f} / this "
                      f"{t1[name]['k7t_with_candidates_ms']:.4f}, "
                      f"{t2[name]['k7t_with_candidates_ms']:.4f} ms")
            if "k7a_kept" in t1[name]:
                parts += (f"; beam samples kept {t1[name]['k7a_kept']} of "
                          f"{t1[name]['k7a_slots']} slots (other: {o1[name]['k7a_kept']} of "
                          f"{o1[name]['k7a_slots']})")
            if "k7d_digest" in t1[name]:
                print(f"{name} K7d: {t1[name]['k7d_pairs']} pairs; device time other "
                      f"{o1[name]['k7d_device_ms']:.4f}, {o2[name]['k7d_device_ms']:.4f} / this "
                      f"{t1[name]['k7d_device_ms']:.4f}, {t2[name]['k7d_device_ms']:.4f} ms; the "
                      f"call with its wait other {o1[name]['k7d_call_ms']:.4f}, "
                      f"{o2[name]['k7d_call_ms']:.4f} / this {t1[name]['k7d_call_ms']:.4f}, "
                      f"{t2[name]['k7d_call_ms']:.4f} ms; outputs bit-equal across checkouts "
                      f"{len({r[name]['k7d_digest'] for r in results}) == 1}")
            print(f"{name}: {t1[name]['rows']} rows, {t1[name]['blocks']} blocks; the dispatch's "
                  f"call: other {o1[name]['ms']:.3f}, {o2[name]['ms']:.3f} ms; this "
                  f"{t1[name]['ms']:.3f}, {t2[name]['ms']:.3f} ms; {parts}; tables bit-equal "
                  f"across checkouts (valid rows) {same}; repeat calls bit-equal "
                  f"{all(r[name]['repeat_equal'] for r in results)}")
            continue
        print(f"{name}: other {o1[name]['ms']:.3f}, {o2[name]['ms']:.3f} ms; this "
              f"{t1[name]['ms']:.3f}, {t2[name]['ms']:.3f} ms; outputs bit-equal across "
              f"checkouts {same}; repeat launches bit-equal "
              f"{all(r[name]['repeat_equal'] for r in results)}")
    for name in (k for k in o1 if k.endswith("_map")):
        print(f"{name}: bit-equal across checkouts {len({r[name] for r in results}) == 1}")
    for name in (k for k, v in o1.items() if isinstance(v, list)):  # run_static, raycast
        unit = "ms" if name.endswith("_ms") else "scans/s"
        print(f"{name} {unit}: other {o1[name]} / {o2[name]}; this {t1[name]} / "
              f"{t2[name]}")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
