#!/usr/bin/env python3
"""K3 (the BGKLV tile row engine), K1 (the BGK and BGKL heavy pass, both
branches), K1′ (the device-ingest heavy pass, both branches) and K6 (the
raycast DDA) of two checkouts on the same captured inputs, in one call.

Run from the repository root on a machine with one CUDA card, with the
other checkout unpacked into a directory that .gitignore lists:

    git archive <parent> | tar -x -C .archive/parent
    python3 tools/seg_kernels_ab.py .archive/parent

This checkout captures eleven inputs from chip_smoke.py's synthetic scans:
K3 on a 12-scan BGKLV demo dispatch and on one BGKLV large-map scan
(block_depth 6), K1 on a 16-scan BGKL demo dispatch and on a 12-scan BGKL
large-map dispatch (block_depth 5, segments) and on a 16-scan BGK demo
host-ingest dispatch (points), K1′ on the device-ingest dispatches of 16
BGK demo scans (points), 16 BGKL demo scans and 12 BGKL large-map scans
(segments), and K6 on chip_smoke.py's three raycast queries (1,000,000 rays
into the 60-scan BGK demo map, 100,000 into the BGKL and BGKLV maps).  Then
each checkout, in the order other, this, this, other, runs in a process of
its own (importing its own ``la3dm_tpu_torch`` and building its own
kernels): it times each kernel (chip_smoke.py's ``launch_ms``: device time
of launches queued behind a spin), hashes its outputs (K3: A, B and
touched; K1 and K1′: the accumulator; K6: hit, dist and steps), and runs
``pipeline.run_static`` for BGKLV (60 demo scans, 12 large-map scans), the
BGKL large map (12 scans, host and device ingest) and the BGK demo (60
scans, device and host ingest), then times ``raycast_device`` over the
1,000,000 rays on its own 60-scan BGK demo map.  The last lines compare: times of both, and whether
each output is bit-equal across the checkouts.
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
              "k1p_demo", "k1p_large", "k6_bgk", "k6_bgkl", "k6_bgklv")
REPS = {"k3_demo": 5, "k3_large": 5, "k1_demo": 5, "k1_large": 3, "k1_bgk_demo": 5,
        "k1p_bgk_demo": 5, "k1p_demo": 5, "k1p_large": 3, "k6_bgk": 5, "k6_bgkl": 5,
        "k6_bgklv": 5}


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def capture(out_dir: str) -> None:
    """Capture the inputs with this checkout and write the PCDs."""
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
    caps = {"k3_demo": cs.capture_lv(cfg_lv, scans[:12])._last_step_call,
            "k3_large": cs.capture_lv(cfg_lv_large, scans[:4])._last_step_call}
    for name, cfg, n in (("k1_demo", cfg_l, 16), ("k1_large", cfg_ll, 12),
                         ("k1_bgk_demo", cfg_b, 16)):
        args, statics = cs.capture_dispatch(cfg, scans[:n], "cuda")
        (_, _, _, _, all_nodes, _, ent, lab, ids, gs, rb, rs, rn, _, ctr, _, _) = args
        kw = dict(G=statics["G"], sf2=statics["sf2"], ell=statics["ell"])
        caps[name] = ((ent, lab, ids, gs, rb, rs, rn, ctr, all_nodes), kw)
    for name, cfg, n in (("k1p_bgk_demo", load_method_config("bgk", max_range=cs.MAX_RANGE),
                          16),
                         ("k1p_demo", load_method_config("bgkl", max_range=cs.MAX_RANGE), 16),
                         ("k1p_large", load_method_config("bgkloctomap_large_map"), 12)):
        (args, kw, _), = cs.record_ingest(cfg, scans[:n])["bgk_aligned_heavy"]
        caps[name] = (args, kw)
    # K6: chip_smoke.py's three queries (its maps, rays and arguments)
    ds60 = DatasetConfig(name="synth", dir=out_dir, prefix="synth", scan_num=60,
                         max_range=cs.MAX_RANGE)
    for name, method, n, seed in (("k6_bgk", "bgk", cs.RAYS_MAIN, 1),
                                  ("k6_bgkl", "bgkl", cs.RAYS_OTHER, 2),
                                  ("k6_bgklv", "bgklv", cs.RAYS_OTHER, 3)):
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
        caps[name] = (args, kw)
    for name, (args, kw) in caps.items():
        torch.save(([a.cpu() for a in args], kw), os.path.join(out_dir, f"{name}.pt"))


def worker(tree: str, data_dir: str) -> dict:
    """Time and hash both kernels of checkout ``tree`` on the captured
    dispatches; run run_static on its main paths."""
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
    for name in DISPATCHES:
        args, kw = torch.load(os.path.join(data_dir, f"{name}.pt"))
        args = [a.cuda() for a in args]
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

    runs = (("bgklv_static60", load_method_config("bgklv", max_range=cs.MAX_RANGE), 60, 2),
            ("bgklv_large12", load_method_config("bgklvoctomap_large_map",
                                                 max_range=cs.MAX_RANGE), 12, 2),
            ("bgkl_large12_host", load_method_config("bgkloctomap_large_map",
                                                     device_ingest="off"), 12, 3),
            ("bgkl_large12_device", load_method_config("bgkloctomap_large_map"), 12, 3),
            ("bgk_static60_device", load_method_config("bgk", max_range=cs.MAX_RANGE), 60,
             3),
            ("bgk_static60_host", load_method_config("bgk", max_range=cs.MAX_RANGE,
                                                     device_ingest="off"), 60, 3))
    for name, cfg, n, reps in runs:
        ds = DatasetConfig(name="synth", dir=data_dir, prefix="synth", scan_num=n,
                           max_range=cfg.max_range)
        pipeline.run_static(cfg, ds)  # warm-up
        out[name] = [pipeline.run_static(cfg, ds).scans_per_second for _ in range(reps)]
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
    out["card"] = torch.cuda.get_device_name(0)
    return out


def main() -> int:
    if len(sys.argv) >= 4 and sys.argv[1] == "--worker":
        print("AB " + json.dumps(worker(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("seg_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = sys.argv[1]
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
        capture(tmp)
        print(f"captured in {time.perf_counter() - t0:.1f} s", flush=True)
        for tree in (other, ROOT, ROOT, other):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                                   tree, tmp], capture_output=True, text=True)
            line = [x for x in proc.stdout.splitlines() if x.startswith("AB ")]
            if proc.returncode != 0 or not line:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"the worker for {tree} failed")
            res = json.loads(line[0][3:])
            res["tree"] = "other" if tree == other else "this"
            print(json.dumps(res), flush=True)
            results.append(res)
    o1, t1, t2, o2 = results
    for name in DISPATCHES:
        same = len({r[name]["digest"] for r in results}) == 1
        print(f"{name}: other {o1[name]['ms']:.3f}, {o2[name]['ms']:.3f} ms; this "
              f"{t1[name]['ms']:.3f}, {t2[name]['ms']:.3f} ms; outputs bit-equal across "
              f"checkouts {same}; repeat launches bit-equal "
              f"{all(r[name]['repeat_equal'] for r in results)}")
    for name in (k for k, v in o1.items() if isinstance(v, list)):  # run_static, raycast
        unit = "ms" if name.endswith("_ms") else "scans/s"
        print(f"{name} {unit}: other {o1[name]} / {o2[name]}; this {t1[name]} / "
              f"{t2[name]}")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
