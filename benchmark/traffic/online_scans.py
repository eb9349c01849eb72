"""Traffic kind ``online_scans``: the server node's job — scans arriving one
at a time, each through ``OnlineIntegrator.offer`` (the motion gate, the
host pre-downsample at the map's ``ds_resolution``, ``insert_pointcloud``
with the map's own settings) and waited for (``synchronize``) before the
next is offered: a closed loop, one stream, a fresh map a pass.

A scan's latency runs from before ``offer`` to after ``synchronize``, so it
holds the host pre-downsample.  Every scan must pass the motion gate: a pass
in which the gate skips one raises.  The server's marker republish, a query
of the map, is not run.

A mix of this kind (``benchmark/traffic/<name>.json``) sets
``sequence_scans``, the scans of a pass, and ``trace_layer``, the layer of
``benchmark/kernel_layers.json`` that a traced window has to hold;
``fresh_map_per_pass``, ``loop``, ``streams`` and ``republish`` say what the
passes are.  This generator refuses a mix that asks for anything else or
names a key it does not read.
"""

from __future__ import annotations

import time

from benchmark.traffic import passes

#: the keys a mix may hold: None where any value goes, else the values run
KEYS = {"name": None, "kind": None, "why": None, "source": None,
        "sequence_scans": None, "trace_layer": None,
        "fresh_map_per_pass": (True,), "loop": ("closed",), "streams": (1,),
        "republish": (False,)}
REQUIRED = ("sequence_scans", "trace_layer")
#: scans a heavy pass of the reference: its ȳ and k̄ take 7·Vall·8 bytes a
#: test block (about 260 kB at block_depth 5), so a whole pass at once would
#: not fit the card; 32 scans of the large map peak at 15.6 GB and run a
#: pass in 26 s on an H100 (35 s at 8 scans, whose launches do not fill it)
REFERENCE_BATCH = 32
window = passes.window


def check(traffic: dict) -> None:
    """Refuse a mix with a key this generator does not read, a value it does
    not run, or a key it needs left out."""
    passes.check(traffic, "online_scans", KEYS, REQUIRED)


def build(conf: dict, traffic: dict, seed: int, device: str, scans: int | None = None) -> dict:
    """One run's load: the sequence's raw clouds and origins from the seed;
    ``step(latencies=None)``, one pass of them through ``OnlineIntegrator``
    into a fresh map, appending each scan's seconds to ``latencies`` and
    returning the map; and ``reference``, how the reference is to be fed
    what this path feeds the map.  ``scans`` overrides the mix's sequence
    length."""
    from benchmark import scene
    from la3dm_tpu_torch.pipeline import MAP_CLASSES, OnlineIntegrator, build_map
    from la3dm_tpu_torch.utils.config import MapConfig

    n = int(scans or traffic["sequence_scans"])
    clouds, origins = scene.scans(conf, n, seed, device)
    mcfg = MapConfig(**conf["method"])
    if mcfg.max_range != float(conf["dataset"]["max_range"]):
        raise ValueError("online_scans: the map's max_range, which insert_pointcloud takes, "
                         "differs from the dataset's, which the reference takes")

    def step(latencies: list | None = None):
        m = build_map(mcfg, device=device)
        feed = OnlineIntegrator(m)
        for cloud, origin in zip(clouds, origins):
            t0 = time.perf_counter()
            feed.offer(cloud, origin)
            m.synchronize()
            if latencies is not None:
                latencies.append(time.perf_counter() - t0)
        if feed.n_skipped:
            raise RuntimeError(f"online_scans: the motion gate skipped {feed.n_skipped} of "
                               f"{n} scans")
        return m

    leaf = mcfg.ds_resolution
    server_leaf = leaf if MAP_CLASSES[mcfg.method].SERVER_DOWNSAMPLE else None
    return {"clouds": clouds, "origins": origins, "scans": n, "step": step,
            "reference": {"server_leaf": server_leaf, "ds": leaf, "batch": REFERENCE_BATCH}}
