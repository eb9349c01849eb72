"""Host time a scan of the light pass's launches: the self time of the
program's span ``la3dm.light.launch`` (K2 or K5 with its prune, once a
scan), over the scans the program counted, both while the profiler recorded
(``la3dm_tpu_torch/utils/profiling.py``)."""

SPAN = "la3dm.light.launch"


def read(ctx):
    try:
        from la3dm_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None     # a program without the span recorder
    snap = snapshot()
    scans = snap["counts"].get("scans")
    if not scans:
        return None
    return 1e3 * snap["spans"].get(SPAN, {}).get("self_s", 0.0) / scans
