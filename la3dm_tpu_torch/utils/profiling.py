"""The port's spans and counters, and its device trace.

The reference's observability is wall-clock logs per phase
("Mapping finished in Xs", bgkoctomap_static_node.cpp:98-99; "One cloud
finished in", bgkoctomap_server.cpp:88-89).  Here the program marks its
layer boundaries with :func:`span` (``la3dm.<layer>.<what>``) and counts
work with :func:`count`.  Both do nothing but read one flag unless a
``torch.profiler`` session is recording.  While one records, a span is a
host range on the profiler's timeline, the clock the CUDA kernels and
copies are traced on, and adds its duration and its self time (the
duration less the time its child spans cover) to process-wide totals; a
counter adds to its total.  The range is an operator-scope record
(``_RecordFunctionFast``), not ``record_function``'s user scope: the
profiler mirrors every user-scope range onto the card's timeline as an
annotation over the kernels launched inside it, which a reader of the
trace would take for device work.  :func:`snapshot` reads the totals and
:func:`reset` clears them, so the totals cover exactly the recorded
sessions since the last reset.

Each thread keeps its own stack of open spans.  A span opened inside an
open span of the same name (a sharded map's per-shard call of the method
that opened it) is not a span of its own: its time stays with the outer one
and nothing is counted twice.

:func:`device_trace` (the CLI's ``--profile-dir``) records a session and
writes its Chrome trace and the totals beside it.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

_LOCK = threading.Lock()
_LOCAL = threading.local()
#: name → [seconds, self seconds, calls]
_SPANS: dict[str, list] = {}
_COUNTS: dict[str, int] = {}
_OFF = contextlib.nullcontext()


def _recording() -> bool:
    return _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    __slots__ = ("name", "_range", "_t0", "_children_s")

    def __init__(self, name: str):
        self.name = name
        self._t0 = None

    def __enter__(self):
        stack = _stack()
        if any(s.name == self.name for s in stack):
            return self         # nested in itself: the outer span holds the time
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        self._children_s = 0.0
        stack.append(self)
        # the clock starts once the range is open and stops once it is
        # closed, where the profiler's own readings sit: the totals then
        # agree with the trace's event durations
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._t0 is None:
            return False
        self._range.__exit__(*exc)
        seconds = time.perf_counter() - self._t0
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1]._children_s += seconds
        with _LOCK:
            total = _SPANS.setdefault(self.name, [0.0, 0.0, 0])
            total[0] += seconds
            total[1] += seconds - self._children_s
            total[2] += 1
        return False


def span(name: str):
    """A context manager around one piece of the program's work, named
    ``la3dm.<layer>.<what>`` (module docstring); a shared no-op unless a
    profiler session is recording."""
    return _Span(name) if _recording() else _OFF


def traced(name: str):
    """Decorator: the function's calls as :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session records."""
    if _recording():
        with _LOCK:
            _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def snapshot() -> dict:
    """The totals: ``{"spans": {name: {"s", "self_s", "calls"}}, "counts":
    {name: n}}``."""
    with _LOCK:
        return {"spans": {k: {"s": s, "self_s": self_s, "calls": calls}
                          for k, (s, self_s, calls) in _SPANS.items()},
                "counts": dict(_COUNTS)}


def reset() -> None:
    """Clear the totals."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the host and CUDA work inside the block,
    written at its end as a Chrome trace (``chrome://tracing``, Perfetto) to
    ``logdir/trace_<pid>_<time>.json``, the path the block is given, and the
    block's span and counter totals (:func:`snapshot`) to
    ``logdir/spans_<pid>_<time>.json``; CUDA is traced where a card is
    present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    stamp = f"{os.getpid()}_{time.time_ns()}.json"
    path = os.path.join(logdir, "trace_" + stamp)
    reset()
    with profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(os.path.join(logdir, "spans_" + stamp), "w") as f:
        json.dump(snapshot(), f, indent=1)
