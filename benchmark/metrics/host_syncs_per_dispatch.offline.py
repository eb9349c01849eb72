"""Host syncs a dispatch: the program's ``host_syncs`` counter (one at each
wait for the card) over its ``dispatches`` counter (one a dispatch of up to
16 scans), both while the profiler recorded
(``la3dm_tpu_torch/utils/profiling.py``).  A pass's closing
``synchronize`` is spread over its dispatches."""


def read(ctx):
    try:
        from la3dm_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None     # a program without the span recorder
    counts = snapshot()["counts"]
    if not counts.get("scans") or not counts.get("dispatches"):
        return None
    return counts.get("host_syncs", 0) / counts["dispatches"]
