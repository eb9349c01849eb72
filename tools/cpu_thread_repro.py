#!/usr/bin/env python3
"""Do the port's plain passes give the same bits on several CPU threads as
on one?  A reproducer outside pytest.

The port's CPU tests run PyTorch on one thread (``tests/torch_cases.py::
one_torch_thread``): in pytest workers the first multithreaded elementwise
pass of a process was seen to return one thread's share perturbed by about
3e-4.  A map with ``device="cpu"`` runs on every thread, so this script runs
the plain passes those tests run, on their seeded inputs, in fresh
processes — each at a given thread count, each pass twice (the process's
first call, then a second) — and compares every output bit for bit with
the one-thread run:

  bgk_heavy_points / bgk_heavy_segments  K1's plain version (heavy_inputs)
  bgk_aligned_heavy                      K1′'s (aligned_heavy_inputs)
  bgk_light                              K2's, one scan after another (in place)
  gp_heavy                               K4's (gp_heavy_inputs; LAPACK inside)
  ingest_bgk / ingest_bgkl               device ingest's plain K7 on ingest_scene

Run from the repository root (CPU only; a few hundred MB a process):

    python3 tools/cpu_thread_repro.py --runs 10 --threads 1,2,4,8

``--jax`` also imports JAX and runs one jitted step in each process first,
as the test processes that hold both packages do.  The last lines list, per
case and thread count, how many processes differed from the one-thread bits
on their first call and on their second; the script exits 1 if any did.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def cases():
    """name → a function that runs the pass once on fresh inputs and
    returns its outputs' digest."""
    import torch

    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from torch_cases import (GP_STATICS, INGEST, aligned_heavy_inputs, gp_heavy_inputs,
                             heavy_inputs, ingest_scene, light_inputs)

    from la3dm_tpu_torch.geometry import blocks as geo, device_ingest
    from la3dm_tpu_torch.kernels import (bgk_aligned_heavy, bgk_heavy, bgk_light, gp_heavy,
                                         ingest_keys)
    from la3dm_tpu_torch.models import posterior as po

    def heavy(segments):
        def run():
            a = heavy_inputs(15 if segments else 5, segments=segments)
            return _digest(bgk_heavy.bgk_heavy_plain(**a, G=7, sf2=0.1 if segments else 1.0,
                                                     ell=0.2))
        return run

    def aligned():
        a = aligned_heavy_inputs(35)
        return _digest(bgk_aligned_heavy.bgk_aligned_heavy_plain(
            a["ent_rel"], a["labels"], a["ustart"], a["ucount"], a["tb_u"], a["ext_nodes"],
            G=7, sf2=1.0, ell=0.2))

    def light():
        acc, A, B, touched, eff, node_idx, slots = light_inputs(7)
        kw = dict(G=7, gate=0.0, n=4, max_level=2, state_fn=po.BetaStateFn(100.0, 0.3, 0.7),
                  do_prune=True)
        for start in range(0, 12, 3):
            bgk_light.bgk_light_plain(acc, A, B, touched, eff, node_idx, slots, start, 3, **kw)
        return _digest(A, B, touched, eff)

    def gp():
        a = gp_heavy_inputs(17, depth=3, S=128)
        gp_heavy.gp_heavy_plain(a["pts"], a["lab"], a["starts"], a["counts"], a["nb_rows"],
                                a["centers"], a["all_nodes"], a["acc_mean"], a["acc_var"],
                                a["present"], a["failed"], cmax=int(a["counts"].max()),
                                **GP_STATICS)
        return _digest(a["acc_mean"], a["acc_var"], a["present"])

    def ingest(segments):
        def run():
            pts, scan, origins, ca, ba = ingest_scene(50)
            mr, ds, fr, bs = INGEST["mr"], INGEST["ds"], INGEST["fr"], INGEST["block_size"]
            off = torch.from_numpy(ingest_keys.pack_offsets(geo.FACE_NEIGHBOR_OFFSETS))
            kf = device_ingest.beam_slots(ds, fr, mr, bs)
            fn = device_ingest.ingest_batch_bgkl if segments else device_ingest.ingest_batch
            kw = {} if segments else {"free_label": 0.0}
            tabs = fn(pts, scan, origins, ca, ba, off, ds=ds, fr=fr, mr=mr, kf=kf,
                      block_size=bs, **kw)
            return _digest(*(tabs[k] for k in sorted(tabs)))
        return run

    return {"bgk_heavy_points": heavy(False), "bgk_heavy_segments": heavy(True),
            "bgk_aligned_heavy": aligned, "bgk_light": light, "gp_heavy": gp,
            "ingest_bgk": ingest(False), "ingest_bgkl": ingest(True)}


def worker(threads: int, with_jax: bool) -> dict:
    if with_jax:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax
        import jax.numpy as jnp

        jax.jit(lambda x: jnp.sin(x) * 2.0)(jnp.arange(1000.0)).block_until_ready()
    import torch

    torch.set_num_threads(threads)
    out = {"threads": torch.get_num_threads()}
    for name, run in cases().items():
        out[name] = [run(), run()]  # the process's first call, then a second
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=10, help="processes a thread count")
    ap.add_argument("--threads", default="1,2,4,8", help="thread counts (1 is the reference)")
    ap.add_argument("--jax", action="store_true", help="import JAX and run a step first")
    ap.add_argument("--worker", nargs=2, type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("REPRO " + json.dumps(worker(args.worker[0], bool(args.worker[1]))), flush=True)
        return 0
    counts = sorted({int(t) for t in args.threads.split(",")} | {1})
    results = {t: [] for t in counts}
    for r in range(args.runs):
        for t in counts:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                                   str(t), str(int(args.jax))], capture_output=True,
                                  text=True, cwd=ROOT)
            line = [x for x in proc.stdout.splitlines() if x.startswith("REPRO ")]
            if proc.returncode != 0 or not line:
                print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"the worker on {t} threads failed")
            results[t].append(json.loads(line[0][6:]))
        print(f"run {r + 1}/{args.runs} done", flush=True)
    ref = results[1][0]
    names = [k for k in ref if k != "threads"]
    any_diff = False
    for name in names:
        parts = []
        for t in counts:
            first = sum(res[name][0] != ref[name][0] for res in results[t])
            second = sum(res[name][1] != ref[name][0] for res in results[t])
            any_diff |= bool(first or second)
            parts.append(f"{t} threads ({results[t][0]['threads']}): {first}/{len(results[t])} "
                         f"first calls, {second} second calls differ")
        print(f"{name}: " + "; ".join(parts))
    print(f"processes: {args.runs} a thread count, JAX loaded first: {args.jax}; any "
          f"difference from one thread: {any_diff}")
    return 1 if any_diff else 0


if __name__ == "__main__":
    sys.exit(main())
