"""Traffic kind ``offline_passes``: whole passes of one scan sequence, back
to back, each into a fresh map — the static node's job (``run_static``
without its PCD reads).

A mix of this kind (``benchmark/traffic/<name>.json``) sets
``sequence_scans``, the scans of a pass, and ``trace_layer``, the layer of
``benchmark/kernel_layers.json`` that a traced window has to hold.
``fresh_map_per_pass``, ``loop`` and ``streams`` say what the passes are:
this generator runs a fresh map a pass, a closed loop and one stream, and
refuses a mix that asks for anything else or names a key it does not read.
"""

from __future__ import annotations

from benchmark.traffic import passes

#: the keys a mix may hold: None where any value goes, else the values run
KEYS = {"name": None, "kind": None, "why": None, "source": None,
        "sequence_scans": None, "trace_layer": None,
        "fresh_map_per_pass": (True,), "loop": ("closed",), "streams": (1,)}
REQUIRED = ("sequence_scans", "trace_layer")
window = passes.window


def check(traffic: dict) -> None:
    """Refuse a mix with a key this generator does not read, a value it does
    not run, or a key it needs left out."""
    passes.check(traffic, "offline_passes", KEYS, REQUIRED)


def build(conf: dict, traffic: dict, seed: int, device: str, scans: int | None = None) -> dict:
    """One run's load: the sequence's clouds and origins from the seed, and
    ``step``, one pass of them through the program's public entry — a fresh
    map, ``insert_pointclouds`` with the dataset's ``max_range``,
    ``synchronize`` — returning the map (it times no single scan).
    ``scans`` overrides the mix's sequence length."""
    from benchmark import scene
    from la3dm_tpu_torch.pipeline import build_map
    from la3dm_tpu_torch.utils.config import MapConfig

    n = int(scans or traffic["sequence_scans"])
    clouds, origins = scene.scans(conf, n, seed, device)
    mcfg = MapConfig(**conf["method"])
    max_range = float(conf["dataset"]["max_range"])

    def step(latencies: list | None = None):
        m = build_map(mcfg, device=device)
        m.insert_pointclouds(clouds, origins, ds_resolution=mcfg.resolution,
                             free_resolution=mcfg.free_resolution, max_range=max_range)
        m.synchronize()
        return m

    return {"clouds": clouds, "origins": origins, "scans": n, "step": step}
