"""K7c — the closed-box membership expansion of device scan ingest: wrapper,
plain version and launch counter.

Replaces ``la3dm_tpu/geometry/device_ingest.py::_closed_box_memberships``
(lines 256-283) with the key packing of ``_local_keys`` (lines 286-295): for
each entry, the 8 candidate blocks of ``floor(e/bs + 0.5)`` and its
per-axis second candidate, the closed-box tests ``ctr − half ≤ e ≤ ctr +
half`` in f32, and each candidate's block key (:mod:`ingest_keys`) or the
sentinel, entry-major ([E·8]).  The caller's stable sort of these keys gives
the per-block runs.

On CUDA tensors it launches ``csrc/ingest_members.cu`` (one thread per
entry); on CPU tensors it runs :func:`memberships_plain`.  What bounds the
kernel is bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import _build, ingest_keys, math as km

#: kernel launches since the counter was last reset (one per dispatch)
launches = 0

#: [8,3] axis-bit selector of the candidates (the JAX meshgrid order)
_BITS = np.stack(np.meshgrid(np.arange(2), np.arange(2), np.arange(2), indexing="ij"),
                 axis=-1).reshape(8, 3)


def _sizes(block_size: float) -> tuple[float, float]:
    return float(np.float32(block_size)), float(np.float32(block_size / 2.0))


def memberships(ent, scan, evalid, anchors, *, block_size: float):
    """Membership keys [E·8] int64 of entries ``ent`` [E,3] of scans ``scan``
    [E] int32; ``evalid`` [E] bool masks entries out, ``anchors`` [K,3]
    int32 are the scans' block anchors."""
    if ent.device.type == "cpu":
        return memberships_plain(ent, scan, evalid, anchors, block_size=block_size)
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
    mkey = torch.empty(E * 8, dtype=torch.int64, device=ent.device)
    if E == 0:
        return mkey
    bs, half = _sizes(block_size)
    stream = torch.cuda.current_stream(ent.device).cuda_stream
    code = _build.lib().la3dm_ingest_members(
        ent.data_ptr(), scan.data_ptr(), evalid.data_ptr(), anchors.data_ptr(), E, bs, half,
        mkey.data_ptr(), stream)
    _build.check(code, "ingest_members")
    launches += 1
    return mkey


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
    """The plain PyTorch :func:`memberships`."""
    mcoord, mok = closed_box_memberships(ent, evalid, block_size)
    keys = ingest_keys.pack(scan.repeat_interleave(8), mcoord.reshape(-1, 3), anchors)
    return torch.where(mok.reshape(-1), keys, ingest_keys.SENT)
