"""K7w — the test blocks' world keys and pool-slot gather of device ingest:
wrapper, plain versions and launch counter.

Replaces no JAX step: the JAX map resolves its test blocks' slots on the
host, one per test block (``la3dm_tpu/models/ingest.py``), as the port did
before.  A dispatch's test-block keys (K7s's candidate runs, ``tkey``) are
scan-local, so a block that 16 scans see comes 16 times.  Here the card
turns them into world keys (:func:`world_keys`), one K7s sort of those
(``ingest_sort.launch`` with ``want_rid``) gives the D distinct blocks and
each test block's run, the host reads the D distinct keys (the first D of
the sort's run-key row, which is copied whole: D is known only after the
copy), allocates slots for those blocks alone (``BlockPool.ensure``), and
:func:`gather` writes each test block's slot (and, for GP, its centre) on
the card.

A world key has K7s's int64 layout with scan 0 and the axes swapped: bits
32-47 hold x, 16-31 y, 0-15 z, each the block coordinate minus the
dispatch's ``base`` plus 32768.  K7s's code of a one-scan window then orders
the keys x-major, then y, then z: ``geometry/blocks.py::pack_key``'s order,
so the distinct blocks come out in the order that ``np.unique`` of the
packed keys gives and ``ensure`` places them as before.  :func:`world_window`
widens the candidate test blocks' window by the spread of the dispatch's
block anchors round ``base``; a dispatch that the widest such window (radius
32767) cannot hold keeps the host's resolution.  A field outside its 16 bits
makes the key the sentinel, which K7s counts as no key: the caller reads
that (fewer valid keys than test blocks) and the out-of-window flag from
the sort's status.

On CUDA tensors :func:`world_keys` and :func:`gather` launch
``csrc/ingest_slots.cu`` (one thread a test block; the per-scan counts by a
binary search of the scan-sorted keys); on CPU tensors they run their plain
versions.  What bounds both kernels is bytes; at a dispatch of the
benchmark's (88k test blocks) each moves under 3 MB, so their time is the
launch's.
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import _build, ingest_keys, ingest_sort

#: kernel launches since the counter was last reset (two per dispatch
#: resolved on the card: the world keys, the gather)
launches = 0

#: the widest radius of a world window: its fields span 1 … 65535
MAX_RADIUS = ingest_keys.FIELD_BIAS - 1


def world_window(radius: int, anchors: np.ndarray) -> tuple[ingest_sort.Window,
                                                            np.ndarray] | None:
    """(the one-scan window of the dispatch's world keys, ``base`` [3]
    int64) for test blocks within ``radius`` of their scan's block anchor
    (``anchors`` [K,3]), or None where the window would be wider than
    :data:`MAX_RADIUS`.  ``base`` is the middle of the anchors' box."""
    a = np.asarray(anchors, np.int64)
    lo, hi = a.min(0), a.max(0)
    base = (lo + hi) // 2
    r = int(radius) + int(np.maximum(hi - base, base - lo).max())
    if r > MAX_RADIUS:
        return None
    return ingest_sort.Window(r, 1), base


def unpack_world_np(keys: np.ndarray, base: np.ndarray) -> np.ndarray:
    """Block coordinates [N,3] int64 of world keys [N] (host)."""
    k = np.asarray(keys, np.int64)
    f = np.stack([(k >> 32) & 0xFFFF, (k >> 16) & 0xFFFF, k & 0xFFFF], axis=-1)
    return f - ingest_keys.FIELD_BIAS + np.asarray(base, np.int64)


def _base3(base) -> tuple[int, int, int]:
    bx, by, bz = (int(b) for b in np.asarray(base).reshape(3))
    return bx, by, bz


def world_keys(tkey, anchors, base, scans: int):
    """(world keys [T] int64, per-scan counts [scans] int32) of the sorted
    scan-local test-block keys ``tkey`` [T] int64 (``anchors`` [K,3] int32
    the scans' block anchors, ``base`` [3] the world window's)."""
    if tkey.device.type == "cpu":
        return world_keys_plain(tkey, anchors, base, scans)
    if tkey.device.type != "cuda":
        raise ValueError(f"world_keys: unsupported device {tkey.device}")
    global launches
    for k, (x, dt) in {"tkey": (tkey, torch.int64), "anchors": (anchors, torch.int32)}.items():
        if x.device != tkey.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"world_keys: {k} must be a contiguous {dt} tensor on "
                             f"{tkey.device}")
    T = tkey.shape[0]
    if tkey.dim() != 1 or anchors.shape != (scans, 3) or not 1 <= T < 2 ** 31:
        raise ValueError("world_keys: inconsistent shapes")
    dev = tkey.device
    wkey = torch.empty(T, dtype=torch.int64, device=dev)
    count = torch.empty(scans, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.lib().la3dm_ingest_slots_world(
        tkey.data_ptr(), anchors.data_ptr(), T, scans, *_base3(base), wkey.data_ptr(),
        count.data_ptr(), stream)
    _build.check(code, "ingest_slots_world")
    launches += 1
    return wkey, count


def world_keys_plain(tkey, anchors, base, scans: int):
    """The plain PyTorch :func:`world_keys`."""
    b = torch.as_tensor(np.asarray(base, np.int64).reshape(3), device=tkey.device)
    f = ingest_keys.unpack(tkey, anchors) - b + ingest_keys.FIELD_BIAS
    ok = ((f >= 0) & (f <= 0xFFFF)).all(-1)
    w = (f[:, 0] << 32) | (f[:, 1] << 16) | f[:, 2]
    wkey = torch.where(ok, w, ingest_keys.SENT)
    edges = torch.arange(scans + 1, dtype=torch.int64, device=tkey.device) << 48
    at = torch.searchsorted(tkey, edges)
    return wkey, (at[1:] - at[:-1]).to(torch.int32)


def sort_world(wkey, window: ingest_sort.Window):
    """K7s over the world keys without a wait: (perm [≥ T] int64, ukey [≥ D]
    int64, rid [≥ T] int32, status [4] int32 — valid keys, runs, the
    out-of-window flag), each valid on its prefix.  On the CPU the plain
    sort; a key outside the window sets the flag there too."""
    if wkey.device.type == "cuda":
        out, rid, status = ingest_sort.launch(wkey, window, want_rid=True)
        return out[0], out[1], rid, status
    n_out = int(ingest_sort.pack_plain(wkey, window)[1].sum())
    if n_out:
        e = torch.empty(0, dtype=torch.int64)
        return e, e, e.to(torch.int32), torch.tensor([0, 0, 1, 0], dtype=torch.int32)
    runs = ingest_sort.sort_runs_plain(wkey, window, want_rid=True)
    status = torch.tensor([runs.perm.shape[0], runs.ukey.shape[0], 0, 0], dtype=torch.int32)
    return runs.perm, runs.ukey, runs.rid, status


def gather(perm, rid, uslots, ukey, base, *, block_size: float | None = None):
    """(slots [T] int32, centres [T,3] f32 or None) of the test blocks:
    test block perm[j] (``perm`` [T] int64, the sort index of its world
    key) is run rid[j] (``rid`` [T] int32), whose slot is uslots[rid[j]]
    (``uslots`` [D] int32) and whose world key is ukey[rid[j]] (``ukey``
    [≥ D] int64).  ``block_size``: also the centres, (float)((double)c ·
    (double)(float)bs) as ``geometry/blocks.py::block_center`` rounds them."""
    if perm.device.type == "cpu":
        return gather_plain(perm, rid, uslots, ukey, base, block_size=block_size)
    if perm.device.type != "cuda":
        raise ValueError(f"gather: unsupported device {perm.device}")
    global launches
    want = {"perm": (perm, torch.int64), "rid": (rid, torch.int32),
            "uslots": (uslots, torch.int32), "ukey": (ukey, torch.int64)}
    for k, (x, dt) in want.items():
        if x.device != perm.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"gather: {k} must be a contiguous {dt} tensor on {perm.device}")
    T = perm.shape[0]
    if rid.shape != (T,) or not 1 <= T < 2 ** 31:
        raise ValueError("gather: inconsistent shapes")
    dev = perm.device
    slots = torch.empty(T, dtype=torch.int32, device=dev)
    centres = None if block_size is None else torch.empty((T, 3), dtype=torch.float32,
                                                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.lib().la3dm_ingest_slots_gather(
        perm.data_ptr(), rid.data_ptr(), uslots.data_ptr(), ukey.data_ptr(), T,
        *_base3(base), float(np.float32(block_size or 0.0)), slots.data_ptr(),
        None if centres is None else centres.data_ptr(), stream)
    _build.check(code, "ingest_slots_gather")
    launches += 1
    return slots, centres


def gather_plain(perm, rid, uslots, ukey, base, *, block_size: float | None = None):
    """The plain PyTorch :func:`gather`."""
    T, dev = perm.shape[0], perm.device
    r = rid.long()
    slots = torch.empty(T, dtype=torch.int32, device=dev)
    slots[perm] = uslots[r]
    if block_size is None:
        return slots, None
    k = ukey[r]
    f = torch.stack([(k >> 32) & 0xFFFF, (k >> 16) & 0xFFFF, k & 0xFFFF], dim=-1)
    b = torch.as_tensor(np.asarray(base, np.int64).reshape(3), device=dev)
    c = (f - ingest_keys.FIELD_BIAS + b).to(torch.float64) * float(np.float32(block_size))
    centres = torch.empty((T, 3), dtype=torch.float32, device=dev)
    centres[perm] = c.to(torch.float32)
    return slots, centres

