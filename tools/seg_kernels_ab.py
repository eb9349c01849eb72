#!/usr/bin/env python3
"""K3 (the BGKLV tile row engine), K1's segment branch (the BGKL heavy pass)
and K1′ (the device-ingest heavy pass, both branches) of two checkouts on
the same captured dispatches, in one call.

Run from the repository root on a machine with one CUDA card, with the
other checkout unpacked into a directory that .gitignore lists:

    git archive <parent> | tar -x -C .archive/parent
    python3 tools/seg_kernels_ab.py .archive/parent

This checkout captures seven dispatches from chip_smoke.py's synthetic
scans: K3 on a 12-scan BGKLV demo dispatch and on one BGKLV large-map scan
(block_depth 6), K1 on a 16-scan BGKL demo dispatch and on a 12-scan BGKL
large-map dispatch (block_depth 5), K1′ on the device-ingest dispatches of
16 BGK demo scans (points), 16 BGKL demo scans and 12 BGKL large-map scans
(segments).  Then each checkout, in the order other, this, this, other,
runs in a process of its own (importing its own ``la3dm_tpu_torch`` and
building its own kernels): it times each kernel (chip_smoke.py's
``launch_ms``: device time of launches queued behind a spin), hashes its
outputs (K3: A, B and touched; K1 and K1′: the accumulator), and runs
``pipeline.run_static`` for BGKLV (60 demo scans, 12 large-map scans), the
BGKL large map (12 scans, host and device ingest) and the BGK demo (60
scans, device ingest).  The last lines compare: times of both, and whether
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
DISPATCHES = ("k3_demo", "k3_large", "k1_demo", "k1_large", "k1p_bgk_demo", "k1p_demo",
              "k1p_large")
REPS = {"k3_demo": 5, "k3_large": 5, "k1_demo": 5, "k1_large": 3, "k1p_bgk_demo": 5,
        "k1p_demo": 5, "k1p_large": 3}


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def capture(out_dir: str) -> None:
    """Capture the four dispatches with this checkout and write the PCDs."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from la3dm_tpu_torch.utils.config import load_method_config

    scans = cs.synthetic_scans(60)
    cs.write_pcds(scans, out_dir)
    cfg_lv = load_method_config("bgklv", max_range=cs.MAX_RANGE)
    cfg_lv_large = load_method_config("bgklvoctomap_large_map", max_range=cs.MAX_RANGE)
    cfg_l = load_method_config("bgkl", max_range=cs.MAX_RANGE, device_ingest="off")
    cfg_ll = load_method_config("bgkloctomap_large_map", device_ingest="off")
    caps = {"k3_demo": cs.capture_lv(cfg_lv, scans[:12])._last_step_call,
            "k3_large": cs.capture_lv(cfg_lv_large, scans[:4])._last_step_call}
    for name, cfg, n in (("k1_demo", cfg_l, 16), ("k1_large", cfg_ll, 12)):
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
    for name, (args, kw) in caps.items():
        torch.save(([a.cpu() for a in args], kw), os.path.join(out_dir, f"{name}.pt"))


def worker(tree: str, data_dir: str) -> dict:
    """Time and hash both kernels of checkout ``tree`` on the captured
    dispatches; run run_static on its main paths."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as cs  # the checkout's own (its launch_ms)
    from la3dm_tpu_torch import pipeline
    from la3dm_tpu_torch.kernels import _build, bgk_aligned_heavy, bgk_heavy, lv_rows
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
             3))
    for name, cfg, n, reps in runs:
        ds = DatasetConfig(name="synth", dir=data_dir, prefix="synth", scan_num=n,
                           max_range=cfg.max_range)
        pipeline.run_static(cfg, ds)  # warm-up
        out[name] = [pipeline.run_static(cfg, ds).scans_per_second for _ in range(reps)]
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
    for name in (k for k, v in o1.items() if isinstance(v, list)):  # the run_static runs
        print(f"{name} scans/s: other {o1[name]} / {o2[name]}; this {t1[name]} / "
              f"{t2[name]}")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
