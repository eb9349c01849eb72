#!/usr/bin/env python3
"""Readings that the limits of ``benchmark/checks/`` are set from, at a
cell's own size, in one process on the card:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... --control-seeds 1,2,3

For each seed of ``--seeds``: one pass of the program exactly as the timed
window runs it (the traffic generator's own ``step``), held against the
reference fed as the generator says (``run.reference``; the lower
readings).  For each seed of ``--control-seeds``: the reference with its
heavy pass's coordinates rounded to TF32, in the program's place, held
against the reference (the control, the upper readings).  For each seed of
``--witness-seeds``: the reference solved in float32, the program's own
precision, held against the reference (a family whose reference takes
``solve``).  One JSON line per reading — a program reading whose
``gap_max`` passes ``--explain-over`` carries the block it comes from
(``compare.widest``) — then the largest program reading and the smallest
control reading of each number.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import compare, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--explain-over", type=float, default=0.1)
    args = ap.parse_args(argv)
    import torch

    parts = run.load_cell(args.workload)
    conf, gen = parts["config"], parts["generator"]
    meth, mr = conf["method"], float(conf["dataset"]["max_range"])
    ref_mod, _ = run.family(meth["method"])

    def state(v):
        return ref_mod.state(v, meth)

    worst, least = {}, {}
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds),
                        ("witness", args.witness_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            load = gen.build(conf, parts["traffic"], seed, "cuda")
            t0 = time.perf_counter()
            if kind == "program":
                m = load["step"]()
                other = run.snapshot(m)
                del m
            else:
                kw = {"tf32": True} if kind == "control" else {"solve": torch.float32}
                other = run.reference(ref_mod, load, meth, max_range=mr, device="cuda", **kw)
            ref = run.reference(ref_mod, load, meth, max_range=mr, device="cuda")
            nums = compare.compare(other, ref, state)
            if kind != "witness":
                agg = worst if kind == "program" else least
                for k, v in nums.items():
                    agg[k] = (max if kind == "program" else min)(agg.get(k, v), v)
            row = {"kind": kind, "seed": seed, **nums, "seconds": time.perf_counter() - t0}
            if kind == "program" and nums["gap_max"] > args.explain_over:
                row["widest"] = compare.widest(other, ref, state)
            print(json.dumps(row), flush=True)
            del other, ref
            torch.cuda.empty_cache()
    print(json.dumps({"program_largest": worst, "control_smallest": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
