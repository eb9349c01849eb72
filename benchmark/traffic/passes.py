"""What the traffic kinds of whole passes share: the check of a mix against
the keys its kind reads, and the window of passes back to back."""

from __future__ import annotations

import time


def check(traffic: dict, kind: str, keys: dict, required: tuple) -> None:
    """Refuse a mix with a key the kind does not read (``keys``: None where
    any value goes, else the values it runs), a value it does not run, or a
    key of ``required`` left out."""
    name = traffic.get("name")
    for k, v in traffic.items():
        if k not in keys:
            raise ValueError(f"traffic {name!r}: {kind} reads no key {k!r}")
        if keys[k] is not None and not any(type(v) is type(a) and v == a for a in keys[k]):
            raise ValueError(f"traffic {name!r}: {kind} runs {k} in {keys[k]}, not {v!r}")
    for k in required:
        if k not in traffic:
            raise ValueError(f"traffic {name!r}: {kind} needs {k!r}")


def window(step, seconds: float, scans: int) -> dict:
    """Whole passes back to back until ``seconds`` have gone, each
    ``step(latencies)`` returning its map and appending the seconds of each
    scan it times alone to ``latencies``.  Returns the passes, the window's
    seconds (to the end of its last pass), the last pass's map, the scans
    of passes whose map reports failed models, the ingest driver's host
    seconds, each pass's end and the latencies."""
    passes, failed, host_s, m, ends, latencies = 0, 0, 0.0, None, [], []
    t0 = time.perf_counter()
    while True:
        m = None   # the previous map's memory returns to the allocator first
        m = step(latencies)
        passes += 1
        host_s += m.stats["host_s"]
        if int(getattr(m, "failed_models", 0)):
            failed += scans
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    return {"passes": passes, "seconds": ends[-1], "map": m, "failed": failed,
            "host_s": host_s, "ends": ends, "latencies": latencies}
