"""K7t — the bucket tail of device scan ingest: wrapper, plain version and
launch counter.

Replaces the tail of ``la3dm_tpu/geometry/device_ingest.py::_bucket_align``
(lines 298-389): the payload columns in block order and the slot maps
``nb_row`` / ``tb_u`` (lines 357-385).  From K7s's sort of the membership
keys (``perm``, ``rid``, the runs' keys ``ukey``) and the sorted test-block
keys ``tkey``, :func:`bucket` returns the entry rows in block order (``ent``,
``lab``), the rows relative to their block's centre (``ent_rel``, (coord in
f32)·bs subtracted per axis, both ends of a segment), and the slot maps:
``nb_row[u, g]`` the test block ukey[u] − off[g] in ``tkey``, ``tb_u[t, g]``
the entry block tkey[t] + off[g] in ``ukey`` (U where there is none).

On CUDA tensors it launches ``csrc/ingest_bucket.cu`` (one thread a row, an
(entry block, slot) and a (test block, slot)); on CPU tensors it runs
:func:`bucket_plain`.  What bounds the kernel is bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import _build, ingest_keys

#: kernel launches since the counter was last reset (one per dispatch)
launches = 0


def bucket(perm, rid, mrow, ent, lab, ukey, tkey, off, anchors, *, block_size: float):
    """(ent_s [M,D], ent_rel [M,D], lab_s [M] f32, nb_row [U,G], tb_u [T,G]
    int64) of the M sorted memberships: ``perm`` [M] int64 each one's row in
    the membership keys, ``rid`` [M] int32 its run (its block ``ukey[rid]``),
    ``mrow`` [≥ M] int32 each membership's entry row in ``ent`` [E,D] /
    ``lab`` [E] (K7c's rows); ``ukey`` [U] and ``tkey`` [T] the sorted
    entry-block and test-block keys, ``off`` [G] the neighbour offsets as
    key deltas, ``anchors`` [K,3] int32 the block anchors."""
    if ent.device.type == "cpu":
        return bucket_plain(perm, rid, mrow, ent, lab, ukey, tkey, off, anchors,
                            block_size=block_size)
    if ent.device.type != "cuda":
        raise ValueError(f"bucket: unsupported device {ent.device}")
    global launches
    want = {"perm": (perm, torch.int64), "rid": (rid, torch.int32),
            "mrow": (mrow, torch.int32),
            "ent": (ent, torch.float32),
            "lab": (lab, torch.float32), "ukey": (ukey, torch.int64),
            "tkey": (tkey, torch.int64), "off": (off, torch.int64),
            "anchors": (anchors, torch.int32)}
    for k, (x, dt) in want.items():
        if x.device != ent.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"bucket: {k} must be a contiguous {dt} tensor on {ent.device}")
    M, U, T, G = perm.shape[0], ukey.shape[0], tkey.shape[0], off.shape[0]
    D = ent.shape[1] if ent.dim() == 2 else 0
    if D not in (3, 6) or rid.shape != (M,) or lab.shape != ent.shape[:1] \
            or mrow.shape[0] < M or anchors.shape[1:] != (3,) \
            or U == 0 or T == 0 or G == 0:
        raise ValueError("bucket: inconsistent shapes")
    dev = ent.device
    ent_s = torch.empty((M, D), dtype=torch.float32, device=dev)
    ent_rel = torch.empty((M, D), dtype=torch.float32, device=dev)
    lab_s = torch.empty(M, dtype=torch.float32, device=dev)
    nb_row = torch.empty((U, G), dtype=torch.int64, device=dev)
    tb_u = torch.empty((T, G), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.lib().la3dm_ingest_bucket(
        perm.data_ptr(), rid.data_ptr(), mrow.data_ptr(),
        ent.data_ptr(), lab.data_ptr(),
        ukey.data_ptr(), tkey.data_ptr(), off.data_ptr(), anchors.data_ptr(), M, U, T, G, D,
        float(np.float32(block_size)), ent_s.data_ptr(), ent_rel.data_ptr(),
        lab_s.data_ptr(), nb_row.data_ptr(), tb_u.data_ptr(), stream)
    _build.check(code, "ingest_bucket")
    launches += 1
    return ent_s, ent_rel, lab_s, nb_row, tb_u


def bucket_plain(perm, rid, mrow, ent, lab, ukey, tkey, off, anchors, *, block_size: float):
    """The plain PyTorch :func:`bucket`: gathers and ``torch.searchsorted``."""
    eidx = mrow[perm].long()
    ent_s, lab_s = ent[eidx], lab[eidx]
    ctr = ingest_keys.unpack(ukey[rid.long()], anchors).to(torch.float32) \
        * float(np.float32(block_size))
    ent_rel = ent_s - ctr.repeat(1, ent.shape[1] // 3)
    U = ukey.shape[0]
    nb_row = torch.searchsorted(tkey, ukey[:, None] - off[None, :])
    want = tkey[:, None] + off[None, :]
    pos = torch.searchsorted(ukey, want)
    found = ukey[torch.clamp_max(pos, U - 1)] == want
    tb_u = torch.where(found, pos, U)
    return ent_s, ent_rel, lab_s, nb_row, tb_u
