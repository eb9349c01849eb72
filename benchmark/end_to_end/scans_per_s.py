"""Scans a second: the scans of every whole pass in the window over the time
from the window's start to the end of its last pass (host clock)."""


def read(ctx):
    if not ctx.get("window_s"):
        return None
    return ctx["scans"] / ctx["window_s"]
