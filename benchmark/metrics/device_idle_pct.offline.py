"""The share of the traced window in which no kernel, copy or fill ran on
the card: 1 − (the union of the device's operation intervals) / (the
window), in per cent."""


def read(ctx):
    if not ctx.get("window_s") or "busy_s" not in ctx:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
