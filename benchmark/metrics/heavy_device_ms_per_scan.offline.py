"""Device time a scan of the heavy pass (K1′ or K4): the traced window's device operations
of the layer ``heavy pass`` (``benchmark/kernel_layers.json``)."""

LAYER = "heavy pass"


def read(ctx):
    seconds = ctx.get("layer_s", {}).get(LAYER)
    if not seconds or not ctx.get("scans"):
        return None
    return 1e3 * seconds / ctx["scans"]
