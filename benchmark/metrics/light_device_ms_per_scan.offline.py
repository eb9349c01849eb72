"""Device time a scan of the light pass with its prune (K2 or K5): the traced window's device operations
of the layer ``light pass and prune`` (``benchmark/kernel_layers.json``)."""

LAYER = "light pass and prune"


def read(ctx):
    seconds = ctx.get("layer_s", {}).get(LAYER)
    if not seconds or not ctx.get("scans"):
        return None
    return 1e3 * seconds / ctx["scans"]
