"""Main-thread host time of the ingest driver a scan: the map's own
``stats["host_s"]`` (``models/ingest.py``) over the traced passes, which
includes the waits at the ingest driver's host syncs."""


def read(ctx):
    if not ctx.get("scans") or "host_s" not in ctx:
        return None
    return 1e3 * ctx["host_s"] / ctx["scans"]
