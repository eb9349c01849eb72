"""Host time a scan of device ingest's launches: the self time of the
program's span ``la3dm.ingest.tables`` (``ingest_batch`` or
``ingest_batch_bgkl``, K7's host side, its ``la3dm.sync.*`` waits left
out), over the scans the program counted, both while the profiler recorded
(``la3dm_tpu_torch/utils/profiling.py``)."""

SPAN = "la3dm.ingest.tables"


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
