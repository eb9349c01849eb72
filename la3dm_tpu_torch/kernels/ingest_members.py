"""K7c — the closed-box membership expansion of device scan ingest: wrapper,
plain versions and launch counter.

Replaces ``la3dm_tpu/geometry/device_ingest.py::_closed_box_memberships``
(lines 256-283) with the key packing of ``_local_keys`` (lines 286-295): for
each entry, the 8 candidate blocks of ``floor(e/bs + 0.5)`` and its
per-axis second candidate, the closed-box tests ``ctr − half ≤ e ≤ ctr +
half`` in f32, and each candidate's block key (:mod:`ingest_keys`).  Two
layouts: compact, only the memberships that exist, in entry-major (entry,
candidate) order, with each one's entry (the point family: about one in
eight of the dense slots holds one); dense, 8 slots an entry, the sentinel
where there is no membership (:func:`memberships_plain`, the JAX function's
layout; BGKL's hits, which its ray pairs follow in one key array).  The
caller's stable sort of the keys gives the per-block runs, the same in
both layouts.

On CUDA tensors it launches ``csrc/ingest_members.cu`` (tiles of 512
entries, each entry's candidates computed once and its key fields staged
in shared memory; compact: each tile's place by a decoupled look-back, its
memberships staged in order and written coalesced, the count left on the
device); on CPU tensors it runs :func:`compact_memberships_plain` or
:func:`memberships_plain`.  What bounds the kernel is bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import _build, ingest_keys, math as km

#: kernel launches since the counter was last reset (one per dispatch)
launches = 0

#: entries a tile of the kernel
TILE_ENTRIES = 512

#: [8,3] axis-bit selector of the candidates (the JAX meshgrid order)
_BITS = np.stack(np.meshgrid(np.arange(2), np.arange(2), np.arange(2), indexing="ij"),
                 axis=-1).reshape(8, 3)

#: (device, stream) → [words, epoch]: the tile counter (word 0, zero between
#: launches) and look-back words (one a tile, each tagged with its launch's
#: epoch) of the compacting launches on that stream (this compact kernel
#: and K7a's beams, ``csrc/tile_scan.cuh``), grown as needed and kept for the
#: process, and the epoch of the last launch; a launch needs no memset
_SCRATCH: dict = {}
_EPOCH_MAX = 0xFFFFFFFF


def _sizes(block_size: float) -> tuple[float, float]:
    return float(np.float32(block_size)), float(np.float32(block_size / 2.0))


def look_back_words(device, stream: int, tiles: int) -> tuple[torch.Tensor, int]:
    """A compacting launch's scratch on ``stream`` for ``tiles`` tiles and
    its epoch (one more than the last launch's).  The launches on one stream
    run in turn, so they share it."""
    key = (str(device), stream)
    have = _SCRATCH.get(key)
    if have is None or have[0].shape[0] < 1 + tiles:
        n = 1 << tiles.bit_length()
        have = _SCRATCH[key] = [torch.zeros(1 + n, dtype=torch.int64, device=device), 0]
    if have[1] == _EPOCH_MAX:       # the tags start again from clean words
        have[0].zero_()
        have[1] = 0
    have[1] += 1
    return have[0], have[1]


def memberships(ent, scan, evalid, anchors, *, block_size: float, dense: bool = False):
    """(keys, rows, count) of the memberships of entries ``ent`` [E,3] of
    scans ``scan`` [E] int32; ``evalid`` [E] bool masks entries out,
    ``anchors`` [K,3] int32 are the scans' block anchors.  Compact: keys
    int64 and rows int32 (each one's entry) valid on their first M rows
    (exactly M on the CPU, 8E on the card), count [1] int32 holding M on
    the tensors' device (no host sync).  ``dense``: keys [8E] (the sentinel
    where there is no membership), rows [8E] (p // 8), count None."""
    if ent.device.type == "cpu":
        if dense:
            keys = memberships_plain(ent, scan, evalid, anchors, block_size=block_size)
            rows = torch.arange(keys.shape[0], dtype=torch.int32) // 8
            return keys, rows, None
        keys, rows = compact_memberships_plain(ent, scan, evalid, anchors,
                                               block_size=block_size)
        return keys, rows, torch.tensor([keys.shape[0]], dtype=torch.int32)
    if ent.device.type != "cuda":
        raise ValueError(f"memberships: unsupported device {ent.device}")
    global launches
    want = {"ent": (ent, torch.float32), "scan": (scan, torch.int32),
            "evalid": (evalid, torch.bool), "anchors": (anchors, torch.int32)}
    for k, (x, dt) in want.items():
        if x.device != ent.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"memberships: {k} must be a contiguous {dt} tensor on "
                             f"{ent.device}")
    E = ent.shape[0]
    if ent.shape[1:] != (3,) or scan.shape != (E,) or evalid.shape != (E,) \
            or anchors.shape[1:] != (3,):
        raise ValueError("memberships: inconsistent shapes")
    if 8 * E >= 2 ** 30:
        raise ValueError(f"memberships: {E} entries (fewer than 2^27 taken)")
    dev = ent.device
    # one allocation: keys [8E] int64, rows [8E] int32, the count
    buf = torch.empty(96 * E + 8, dtype=torch.uint8, device=dev)
    keys = buf[:64 * E].view(torch.int64)
    rows = buf[64 * E:96 * E].view(torch.int32)
    count = None if dense else buf[96 * E:96 * E + 4].view(torch.int32)
    if E == 0:
        if count is not None:
            count.zero_()
        return keys, rows, count
    bs, half = _sizes(block_size)
    stream = torch.cuda.current_stream(dev).cuda_stream
    words, epoch = (None, 0) if dense else look_back_words(
        dev, stream, -(-E // TILE_ENTRIES))
    code = _build.lib().la3dm_ingest_members(
        ent.data_ptr(), scan.data_ptr(), evalid.data_ptr(), anchors.data_ptr(), E, bs, half,
        int(dense), keys.data_ptr(), rows.data_ptr(), None if dense else count.data_ptr(),
        None if dense else words.data_ptr(), None if dense else words.data_ptr() + 8, epoch,
        stream)
    _build.check(code, "ingest_members")
    launches += 1
    return keys, rows, count


def closed_box_memberships(ent, evalid, block_size: float):
    """(mcoord [E,8,3] int32, mok [E,8] bool): the JAX function's outputs."""
    bs, half = _sizes(block_size)
    base = torch.floor(km.div(ent, bs) + 0.5).to(torch.int32)

    def in_box(coord):
        ctr = coord.to(torch.float32) * bs
        return (ctr - half <= ent) & (ent <= ctr + half)

    base_ok, hi_ok, lo_ok = in_box(base), in_box(base + 1), in_box(base - 1)
    sec = torch.where(hi_ok, 1, -1).to(torch.int32)
    sec_ok = hi_ok | lo_ok
    bits = torch.as_tensor(_BITS, dtype=torch.int32, device=ent.device)
    mcoord = base[:, None, :] + bits[None] * sec[:, None, :]
    mok = torch.where(bits[None].bool(), sec_ok[:, None, :],
                      base_ok[:, None, :]).all(-1) & evalid[:, None]
    return mcoord, mok


def memberships_plain(ent, scan, evalid, anchors, *, block_size: float):
    """The plain PyTorch dense layout: membership keys [E·8] int64, entry
    e's candidate j at 8e + j, the sentinel where it is none."""
    mcoord, mok = closed_box_memberships(ent, evalid, block_size)
    keys = ingest_keys.pack(scan.repeat_interleave(8), mcoord.reshape(-1, 3), anchors)
    return torch.where(mok.reshape(-1), keys, ingest_keys.SENT)


def compact_memberships_plain(ent, scan, evalid, anchors, *, block_size: float):
    """The plain PyTorch compact layout: (keys [M] int64, rows [M] int32),
    the dense layout's memberships in its order and each one's entry."""
    dense = memberships_plain(ent, scan, evalid, anchors, block_size=block_size)
    at = torch.nonzero(dense != ingest_keys.SENT).reshape(-1)
    return dense[at], (at // 8).to(torch.int32)
