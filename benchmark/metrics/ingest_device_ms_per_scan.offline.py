"""Device time a scan of the device-ingest kernels (K7), with the copies and fills: the traced window's device operations
of the layer ``device ingest`` (``benchmark/kernel_layers.json``)."""

LAYER = "device ingest"


def read(ctx):
    seconds = ctx.get("layer_s", {}).get(LAYER)
    if not seconds or not ctx.get("scans"):
        return None
    return 1e3 * seconds / ctx["scans"]
