"""Host time a scan of the server's pre-downsample: the time of the
program's span ``la3dm.server.downsample`` (``OnlineIntegrator.offer``'s
voxel grid at ``ds_resolution``, before ``insert_pointcloud``; no span is
its parent or its child), over the scans the program counted, both while
the profiler recorded (``la3dm_tpu_torch/utils/profiling.py``).  A program
without the span reads nothing."""

SPAN = "la3dm.server.downsample"


def read(ctx):
    try:
        from la3dm_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None     # a program without the span recorder
    snap = snapshot()
    scans = snap["counts"].get("scans")
    if not scans or SPAN not in snap["spans"]:
        return None
    return 1e3 * snap["spans"][SPAN]["s"] / scans
