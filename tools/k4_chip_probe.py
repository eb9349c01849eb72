#!/usr/bin/env python3
"""K4 alone on the card: chip_smoke.py's K4 checks on the GP dispatches it
builds, and K4's device time by kernel under torch.profiler — a quick run
while K4 changes, before the whole smoke test.

Run from the repository root on a machine with one CUDA card:

    python3 tools/k4_chip_probe.py                   # every dispatch, then the profile
    python3 tools/k4_chip_probe.py demo d5 profile   # a choice of them

Dispatches: ``demo`` (16-scan GP demo), ``large`` (12-scan large map, both
tiers), ``dense`` (the forced 300-point block), ``d5`` (12-scan GP at
block_depth 5); ``profile`` times one launch of each tier of the demo and
depth-5 dispatches by kernel.  Each check is chip_smoke.py's ``check_k4``:
the same limits, controls and timings.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from la3dm_tpu_torch.kernels import _build, gp_heavy  # noqa: E402
from la3dm_tpu_torch.utils.config import load_method_config  # noqa: E402


def profile_tiers(args, statics, what: str) -> None:
    """One launch of each tier of a captured dispatch under torch.profiler:
    device ms and launches by K4 kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    all_nodes, pts, lab, tiers, centers = args[4], args[6], args[7], args[8], args[10]
    G, Vall, T = statics["G"], all_nodes.shape[0], centers.shape[0]
    kw = {k: statics[k] for k in ("sf2", "ell", "noise")}
    for st, ct, nb, hc in tiers:
        tables = {"acc_mean": torch.zeros((T * G, Vall), device="cuda"),
                  "acc_var": torch.ones((T * G, Vall), device="cuda"),
                  "present": torch.zeros(T * G, dtype=torch.bool, device="cuda"),
                  "failed": torch.zeros(1, dtype=torch.int32, device="cuda")}

        def run():
            gp_heavy.gp_heavy(pts, lab, st, ct, nb, centers, all_nodes, **tables,
                              host_counts=hc, **kw)
            torch.cuda.synchronize()

        run()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(cs.PROFILE_PAUSE_S)
            run()
        rows = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                m = re.search(r"(gp_\w+)", e.key)
                k = m.group(1) if m else "other"
                ms, n = rows.get(k, (0.0, 0))
                rows[k] = (ms + e.self_device_time_total / 1e3, n + e.count)
        print(f"profile, {what}, tier of up to {int(hc.max())} points: " + "; ".join(
            f"{k} {ms:.3f} ms x{n}" for k, (ms, n) in sorted(rows.items(),
                                                            key=lambda kv: -kv[1][0])),
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_chip_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    which = sys.argv[1:] or ["demo", "large", "dense", "d5", "profile"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.lib()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    scans = cs.synthetic_scans(16)
    demo = load_method_config("gp", max_range=cs.MAX_RANGE, device_ingest="off")
    large = load_method_config("gpoctomap_large_map", max_range=cs.MAX_RANGE,
                               device_ingest="off")
    depth5 = load_method_config("gpoctomap_large_map", block_depth=5, max_range=cs.MAX_RANGE,
                                device_ingest="off")
    if "demo" in which:
        cs.check_k4(*cs.capture_gp(demo, scans[:16], run_step=False), "16-scan demo dispatch")
    if "large" in which:
        cs.check_k4(*cs.capture_gp(large, scans[:12], run_step=False),
                    "12-scan large-map dispatch", reps=1)
    if "dense" in which:
        cs.check_k4(*cs.capture_gp(large, training=cs.dense_block(), run_step=False),
                    "a forced 300-point block", reps=1)
    if "d5" in which:
        cs.check_k4(*cs.capture_gp(depth5, scans[:12], run_step=False),
                    "12-scan GP depth-5 dispatch", reps=1)
    if "profile" in which:
        profile_tiers(*cs.capture_gp(demo, scans[:16], run_step=False), "16-scan demo dispatch")
        profile_tiers(*cs.capture_gp(depth5, scans[:12], run_step=False),
                      "12-scan GP depth-5 dispatch")
    return 0


if __name__ == "__main__":
    sys.exit(main())
