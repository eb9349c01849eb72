#!/usr/bin/env python3
"""The benchmark of ``la3dm_tpu_torch``: one cell of ``BENCHMARK.json`` a run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards.  The
cell names a configuration (``benchmark/configs/<name>.json``: the frozen
method settings, the scene, the sensor and the trajectory) and a traffic
mix (``benchmark/traffic/<name>.json``), whose ``kind`` names its
generator (``benchmark/traffic/<kind>.py``: ``check``, ``build``,
``window``).  Set-up builds the load from the seed, builds the program's
kernels on a checkout's first run (``la3dm_tpu_torch/build/``) and runs
warm passes; the window then runs the generator's passes for
``--seconds``.  With ``--trace 1`` a shorter window runs under
``torch.profiler`` and the per-layer metrics are read from it by the
readers in ``benchmark/metrics/``; without it the cell's end-to-end
metrics are read from the window by the readers in
``benchmark/end_to_end/``.  After the window the map of the last pass is
held against the plain reference (``benchmark/reference/``), fed as the
generator says the program was, by ``benchmark/compare.py`` with the limits
of ``benchmark/checks/``.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number and its limit);
the last lines of standard error repeat the checks.  Without the cards the
cell asks for, the run prints no result and exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
#: kernel caches of any library the program loads, at fixed paths in the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}
#: top-level modules that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "la3dm_tpu")
#: a traced window lasts at most this long, after a pause in which the
#: profiler settles (short profiler sessions lost kernels on an H100)
TRACE_SECONDS, TRACE_PAUSE_S = 4.0, 1.0
#: set-up runs passes for at least this long, so that the card and the
#: host have left their idle clocks before the window opens; longer after a
#: first pass that built the kernels (one that took over BUILT_S), whose
#: build leaves the host busy for a while
WARM_SECONDS, WARM_AFTER_BUILD_S, BUILT_S = 2.0, 10.0, 5.0
#: host threads of the run: the program's host work is serial, and idle
#: worker threads of PyTorch's and numpy's pools only contend for the cores
THREADS = 1
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(workload: str, root: str = ROOT) -> dict:
    """Everything a cell names, found by name: the ``BENCHMARK.json`` entry,
    its configuration and traffic files, the generator of the traffic's
    ``kind`` (which refuses a mix it does not run), its end-to-end and
    per-layer metrics with their readers, and its check file."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cell = _by_name(bench["workloads"], workload, "workload")
    conf = _by_name(bench["configs"], cell["config"], "configuration")
    here = os.path.join(root, "benchmark")
    readers = _readers(bench["per_layer"], workload, os.path.join(here, "metrics"))
    end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    traffic = _json(os.path.join(here, "traffic", cell["traffic"] + ".json"))
    generator = _module(os.path.join(here, "traffic", traffic["kind"] + ".py"), "bench_traffic_")
    generator.check(traffic)
    return {"cell": cell, "bench": bench,
            "config": _json(os.path.join(root, conf["file"])),
            "traffic": traffic, "generator": generator,
            "check": _json(os.path.join(here, "checks", cell["config"] + ".json")),
            "readers": readers, "end_to_end": end_to_end,
            "end_to_end_readers": _readers(bench["end_to_end"], workload,
                                           os.path.join(here, "end_to_end"))}


def _readers(metrics: list, workload: str, folder: str) -> dict:
    """name → ``read`` of each metric that the cell reports, from
    ``<folder>/<name>.py``."""
    return {m["name"]: _module(os.path.join(folder, m["name"] + ".py"), "bench_metric_").read
            for m in metrics if workload in m.get("workloads", [workload])}


def _module(path: str, prefix: str):
    """The Python file ``path``, loaded as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", os.path.basename(path)), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(method: str):
    """(reference module, counts module) of a map family, by its name."""
    return (importlib.import_module(f"benchmark.reference.{method}"),
            importlib.import_module(f"benchmark.counts.{method}"))


def reference(ref_mod, load: dict, method: dict, *, max_range: float, device, **kw) -> dict:
    """The reference's map of a load's raw clouds, fed as the load's
    ``reference`` says the program's path feeds its map: ``server_leaf``,
    each cloud through the server's pre-downsample at that leaf first;
    ``ds``, the hits' leaf; ``batch``, the scans of a heavy pass.  A load
    that names none is the static node's path at the configuration's
    resolution, in one batch."""
    import torch

    from benchmark.reference import server

    how = load.get("reference", {})
    clouds = load["clouds"]
    with torch.no_grad():
        if how.get("server_leaf") is not None:
            clouds = [server.voxel_grid(c, how["server_leaf"], device) for c in clouds]
        return ref_mod.run(clouds, load["origins"], method, max_range=max_range, device=device,
                           ds=how.get("ds"), batch=how.get("batch"), **kw)


# ------------------------------------------------------------------- trace

def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(prof, layers: list) -> dict:
    """The traced window's device time by layer and by operation, its busy
    union, its length and its idle gaps labelled by the host operation that
    ran through each (µs in the profiler's clock, returned in seconds)."""
    from torch.autograd import DeviceType

    evs = prof.events()
    win = [e for e in evs if e.name == "bench.window" and e.device_type == DeviceType.CPU]
    if not win:
        return {}
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    pats = [(name, re.compile(p)) for name, p in layers]
    by_layer, by_op, spans = {}, {}, []
    for e in evs:
        if e.device_type != DeviceType.CUDA or e.name == "bench.window":
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        layer = next((name for name, p in pats if p.search(e.name)), "other")
        by_layer[layer] = by_layer.get(layer, 0.0) + (b - a) * 1e-6
        by_op[e.name] = by_op.get(e.name, 0.0) + (b - a) * 1e-6
        spans.append((a, b))
    busy = _merge(spans)
    cpu = sorted(((e.time_range.start, e.time_range.end, e.name) for e in evs
                  if e.device_type == DeviceType.CPU and e.name != "bench.window"
                  and e.time_range.end > w0 and e.time_range.start < w1))
    starts = [c[0] for c in cpu]
    gaps, edge = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            mid = 0.5 * (a + edge)
            i = bisect.bisect_right(starts, mid)
            # the innermost host operation running through the gap's middle,
            # looked for among the latest that started before it
            inside = [c for c in cpu[max(0, i - 256):i] if c[1] >= mid]
            label = (min(inside, key=lambda c: c[1] - c[0])[2] if inside
                     else "host code outside traced operations")
            gaps[label] = gaps.get(label, 0.0) + (a - edge) * 1e-6
        edge = max(edge, b)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:9]
    if by_layer.get("other"):
        top.append(("other: operations that match no layer of benchmark/kernel_layers.json",
                    by_layer["other"]))
    return {"layer_s": by_layer, "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6, "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}


def traced_window(window, step, scans: int, seconds: float, layers: list, need: str):
    """The generator's ``window`` under torch.profiler for up to ``seconds``:
    (trace dict, the window's dict).  A session whose trace holds no
    operation of the layer ``need`` is run again."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAUSE_S * (1 + 2 * attempt))
            with record_function("bench.window"):
                w = window(step, seconds, scans)
            torch.cuda.synchronize()
        tr = read_trace(prof, layers)
        if tr.get("layer_s", {}).get(need):
            return tr, w
        print(f"trace attempt {attempt + 1} recorded no operation of the layer {need!r}; "
              "retried", file=sys.stderr, flush=True)
    raise RuntimeError(f"the profiler recorded no operation of the layer {need!r}")


# -------------------------------------------------------------------- cell

def snapshot(m) -> dict:
    """The map's blocks as host tensors: coords, fields, touched, eff."""
    nb = m.pool.n_blocks
    return {"coords": m.pool.coords[:nb].copy(),
            "fields": {k: v[:nb].cpu() for k, v in m.pool.fields.items()},
            "touched": m.pool.touched[:nb].cpu(), "eff": m.pool.eff_level[:nb].cpu()}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(parts: dict, *, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, sensor: dict | None = None, method: dict | None = None,
             scans: int | None = None) -> dict:
    """One run of a cell on ``device``; ``sensor`` and ``method`` override
    keys of the configuration and ``scans`` the traffic's sequence length
    (the CPU tests run tiny scenes through the program's plain path this
    way).  Returns the result line's object."""
    import numpy as np
    import torch

    from benchmark import compare

    conf, traffic, check, gen = (parts["config"], parts["traffic"], parts["check"],
                                 parts["generator"])
    conf = {**conf, "sensor": {**conf["sensor"], **(sensor or {})},
            "method": {**conf["method"], **(method or {})}}
    meth, max_range = conf["method"], float(conf["dataset"]["max_range"])
    t_load = time.perf_counter()
    load = gen.build(conf, traffic, seed, device, scans=scans)
    step, n_scans = load["step"], load["scans"]
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()    # the load's own scratch is not the program's

    t_first = time.perf_counter()
    warm = step()
    if warm.stats.get("ingest_host_chunks", 0):
        raise RuntimeError("the pass took the host-ingest path; the cell measures device ingest")
    del warm
    t_warm = time.perf_counter()
    if on_cuda:
        built = t_warm - t_first > BUILT_S
        gen.window(step, WARM_AFTER_BUILD_S if built else WARM_SECONDS, n_scans)
    setup_s = time.perf_counter() - t_start
    setup_parts = {"before_load_s": t_load - t_start, "load_s": t_first - t_load,
                   "first_pass_s": t_warm - t_first,
                   "warm_passes_s": t_start + setup_s - t_warm}
    ref_mod, counts_mod = family(meth["method"])
    layers = _json(os.path.join(HERE, "kernel_layers.json"))["layers"]
    if trace:
        tr, w = traced_window(gen.window, step, n_scans, min(seconds, TRACE_SECONDS), layers,
                              traffic["trace_layer"])
        window_s = tr["window_s"]
    else:
        w = gen.window(step, seconds, n_scans)
        window_s = w["seconds"]
    passes, m = w["passes"], w.pop("map")
    attempted, failed = passes * n_scans, w["failed"]
    peak = int(torch.cuda.max_memory_allocated()) if on_cuda else 0
    prog = snapshot(m)
    del m
    if on_cuda:
        torch.cuda.empty_cache()
        card = power_limit()
        kind = torch.cuda.get_device_name(0)
    else:
        card, kind = "cpu", "cpu"

    t_ref = time.perf_counter()
    ref = reference(ref_mod, load, meth, max_range=max_range, device=device)
    ref_s = time.perf_counter() - t_ref
    numbers = compare.compare(prog, ref, lambda v: ref_mod.state(v, meth))
    limits = check["limits"]
    correct = compare.judge(numbers, limits)

    if trace:
        nodes = block_nodes(meth)
        ctx = {**tr, "scans": attempted, "passes": passes, "host_s": w["host_s"],
               "heavy_work": counts_mod.heavy(ref["work"], nodes, 7),
               "peaks": _json(os.path.join(HERE, "counts", "peaks.json"))}
        metrics = {}
        units = {m["name"]: m["unit"] for m in parts["bench"]["per_layer"]}
        for name, read in parts["readers"].items():
            v = read(ctx)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
    else:
        ctx = {"scans": attempted, "window_s": window_s, "setup_s": setup_s,
               "latencies_s": w.get("latencies")}
        metrics = {}
        for m in parts["end_to_end"]:
            v = parts["end_to_end_readers"][m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if on_cuda else "cpu", "kind": kind, "count": 1,
                      "memory_peak_bytes": peak}}
    if trace:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["card"] = card
    out["passes"] = passes
    if not trace:
        steps = np.diff([0.0] + w["ends"])
        out["pass_s"] = {"first3": [float(x) for x in steps[:3]],
                         "median": float(np.median(steps)), "max": float(steps.max())}
        if w.get("latencies"):
            out["scan_ms"] = {"median": 1e3 * float(np.median(w["latencies"])),
                              "max": 1e3 * float(np.max(w["latencies"]))}
    out["setup_parts"] = setup_parts
    out["reference_s"] = ref_s
    out["work"] = {k: (v if np.isscalar(v) else int(np.asarray(v).size))
                   for k, v in ref["work"].items()}
    out["readings"] = numbers
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return out


def block_nodes(meth: dict) -> int:
    """Octree nodes of a block: Σ_L (n >> L)³."""
    n = 1 << (int(meth["block_depth"]) - 1)
    return sum((n >> L) ** 3 for L in range(int(meth["block_depth"])))


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    parts = load_cell(args.workload)
    import torch

    torch.set_num_threads(THREADS)

    chips = int(parts["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(parts, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print("loaded in this process, which the benchmark forbids: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
