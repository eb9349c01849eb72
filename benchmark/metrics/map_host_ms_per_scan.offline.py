"""Host time a scan of the map's entry: the self time of the program's spans
``la3dm.map.build`` (the constructor and its pool), ``la3dm.map.insert``
(``insert_pointclouds``, outside its child spans) and ``la3dm.pool.ensure``
(``BlockPool.ensure`` with its growth), over the scans the program counted,
both while the profiler recorded (``la3dm_tpu_torch/utils/profiling.py``)."""

SPANS = ("la3dm.map.build", "la3dm.map.insert", "la3dm.pool.ensure")


def read(ctx):
    try:
        from la3dm_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None     # a program without the span recorder
    snap = snapshot()
    scans = snap["counts"].get("scans")
    if not scans:
        return None
    return 1e3 * sum(snap["spans"].get(n, {}).get("self_s", 0.0) for n in SPANS) / scans
