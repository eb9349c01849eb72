"""Single-card entry: the production BGK step with a real insert's arguments.

The port of ``__graft_entry__.py::entry``.  ``entry()`` returns the BGK
sequence step (``models/bgk.py::_bgk_seq_step`` — the heavy pass K1, then
the gated Beta update and prune K2 a scan) with the argument tuple that a
real ``insert_pointcloud`` of ``device_ingest: "off"`` passes, captured
from the insert of a tiny seeded scan.
"""

from __future__ import annotations

import numpy as np

from la3dm_tpu_torch.models import bgk as B
from la3dm_tpu_torch.utils.config import load_method_config


def tiny_scan(n=60, seed=0):
    """``n`` seeded points in the 2.4 m cube round the origin, seen from the
    origin (``__graft_entry__.py::_tiny_scan``)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    return pts, np.zeros(3, np.float32)


def entry(device=None):
    """(step, example_args) of the production BGK step on ``device`` (CUDA
    unless named).  ``step(*args)`` runs K1 and K2 on copies of the pool
    tensors it is given and returns them updated, ``(A, B, touched, eff)``:
    on ``args`` that is the pool the captured insert produced."""
    # device_ingest=off: the capture hook snapshots the host-built argument
    # tuple of the engine step (the device-ingest path feeds K1′ instead)
    m = B.BGKOctoMap(load_method_config("bgk", max_range=8.0, device_ingest="off"),
                     device=device)
    m._capture_step_args = True
    cloud, origin = tiny_scan(400)
    m.insert_pointcloud(cloud, origin)
    args, statics = m._last_step_call

    def step(*arrays):
        """The production BGK sequence step with this insert's statics."""
        pool = tuple(a.clone() for a in arrays[:4])
        B._bgk_seq_step(*pool, *arrays[4:], **statics)
        return pool

    return step, args
