#!/usr/bin/env python3
"""The GP main path of one checkout on the card, for comparing two commits
in one call: run_static over 60 of chip_smoke.py's synthetic scans on
device ingest and on host ingest (a warm-up, then three runs each), and
OnlineIntegrator's median latency over 12 scans on device ingest (two
passes, the second kept).  Prints one line.

Unpack the other commit into a directory that .gitignore lists, then run
both in turns, for example parent, change, change, parent:

    git archive <parent> | tar -x -C .archive/parent
    for t in .archive/parent . . .archive/parent; do python3 tools/gp_main_path.py $t; done

Each checkout builds its own kernels into its own la3dm_tpu_torch/build/.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gp_main_path: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from la3dm_tpu_torch import pipeline
    from la3dm_tpu_torch.kernels import _build
    from la3dm_tpu_torch.models.gp import GPOctoMap
    from la3dm_tpu_torch.utils.config import DatasetConfig, load_method_config

    _build.lib()
    scans = cs.synthetic_scans(60)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cs.write_pcds(scans, tmp)
        for name, ingest in (("device", "auto"), ("host", "off")):
            cfg = load_method_config("gp", max_range=cs.MAX_RANGE, device_ingest=ingest)
            ds = DatasetConfig(name="synth", dir=tmp, prefix="synth", scan_num=60,
                               max_range=cfg.max_range)
            pipeline.run_static(cfg, ds)
            out[name] = [pipeline.run_static(cfg, ds).scans_per_second for _ in range(3)]
    cfg = load_method_config("gp", max_range=cs.MAX_RANGE)
    for _ in range(2):
        m = GPOctoMap(cfg)
        online, lat = pipeline.OnlineIntegrator(m), []
        for cloud, origin in scans[:12]:
            t0 = time.perf_counter()
            online.offer(cloud, origin)
            m.synchronize()
            lat.append(time.perf_counter() - t0)
    print(f"{root}: GP scans/s over 60 scans, device ingest "
          f"{', '.join(f'{x:.2f}' for x in out['device'])}; host ingest "
          f"{', '.join(f'{x:.2f}' for x in out['host'])}; online median "
          f"{float(np.median(lat)) * 1e3:.2f} ms ({torch.cuda.get_device_name(0)})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
