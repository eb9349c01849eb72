"""Tracing & profiling hooks.

The reference's observability is wall-clock logs per phase
("Mapping finished in Xs", bgkoctomap_static_node.cpp:98-99; "One cloud
finished in", bgkoctomap_server.cpp:88-89) plus a compile-time Debug_Msg.
Here: a lightweight phase timer usable as a context manager (enabled with
LA3DM_PROFILE=1) and a torch.profiler trace for device timelines.  (The
port's own copy of ``la3dm_tpu/utils/profiling.py``; ``device_trace`` is the
port's.)
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class PhaseTimer:
    """Accumulates wall-clock per named phase; ~zero cost when disabled."""

    def __init__(self, enabled: bool | None = None):
        self.enabled = (os.environ.get("LA3DM_PROFILE", "") == "1"
                        if enabled is None else enabled)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{name:32s} {1e3 * self.totals[name]:9.1f} ms "
                         f"({self.counts[name]}x, "
                         f"{1e3 * self.totals[name] / max(self.counts[name], 1):.2f} ms/call)")
        return "\n".join(lines)


TIMER = PhaseTimer()


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the host and CUDA work inside the block,
    written at its end as a Chrome trace (``chrome://tracing``, Perfetto) to
    ``logdir/trace_<pid>_<time>.json``, the path the block is given; CUDA is
    traced where a card is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
