"""Host time a scan of the heavy pass's launches: the self time of the
program's span ``la3dm.heavy.launch`` (K1′'s host side, or K4's with GP's
size tiers and gathers, once a dispatch; its light launches left out), over
the scans the program counted, both while the profiler recorded
(``la3dm_tpu_torch/utils/profiling.py``)."""

SPAN = "la3dm.heavy.launch"


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
