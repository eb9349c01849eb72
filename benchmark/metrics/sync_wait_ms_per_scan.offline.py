"""Host time a scan spent waiting for the card: the program's
``la3dm.sync.*`` spans (each K7s sort's status read, the size of BGKL's
ray-block pair list, the key and count copy of a dispatch, the map's
``synchronize``), over the scans the program counted, both while the
profiler recorded (``la3dm_tpu_torch/utils/profiling.py``)."""

PREFIX = "la3dm.sync."


def read(ctx):
    try:
        from la3dm_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None     # a program without the span recorder
    snap = snapshot()
    scans = snap["counts"].get("scans")
    if not scans:
        return None
    return 1e3 * sum(v["s"] for k, v in snap["spans"].items() if k.startswith(PREFIX)) / scans
