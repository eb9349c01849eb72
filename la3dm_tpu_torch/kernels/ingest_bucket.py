"""K7t — the bucket tail of device scan ingest: wrapper, plain versions and
launch counter.

Replaces the tail of ``la3dm_tpu/geometry/device_ingest.py::_bucket_align``
(lines 298-389): the payload columns in block order and the slot maps
``nb_row`` / ``tb_u`` (lines 351-385).  From K7s's sort of the membership
keys (``perm``, ``rid``, the runs' keys ``ukey``) and its sort of the
candidate keys ukey[u] + off[g′] (``cperm``, the runs ``cstart`` /
``ccount``, whose keys are the test blocks ``tkey``), :func:`bucket`
returns the entry rows in block order (``ent``, ``lab``), the rows relative
to their block's centre (``ent_rel``, (coord in f32)·bs subtracted per
axis, both ends of a segment), and the slot maps: ``nb_row[u, g]`` the test
block ukey[u] − off[g] in ``tkey``, ``tb_u[t, g]`` the entry block tkey[t] +
off[g] in ``ukey`` (U where there is none).

The offsets are symmetric (:func:`mirror_slots`: off[mirror[g]] = −off[g]),
so candidate (u, g′) in run t gives both maps at once: nb_row[u,
mirror[g′]] = t and tb_u[t, mirror[g′]] = u.  :func:`bucket_runs_plain`
reads them so; :func:`bucket_plain` keeps the searchsorted formulation
(``torch.searchsorted`` over the sorted keys), the rule both are held to.

On CUDA tensors :func:`bucket` launches ``csrc/ingest_bucket.cu`` (a warp
64 sorted rows, a CTA 256 test blocks and their candidate runs, no search);
on CPU tensors it runs :func:`bucket_runs_plain`.  What bounds the kernel
is bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import _build, ingest_keys

#: kernel launches since the counter was last reset (one per dispatch)
launches = 0


def mirror_slots(off) -> np.ndarray:
    """The mirror slot of each neighbour offset ([G] int32: off[mirror[g]] =
    −off[g]) of ``off`` ([G] key deltas, or [G,3] offsets; numpy or a CPU
    tensor); ValueError where the offsets are not symmetric."""
    o = np.asarray(off, np.int64)
    o = o.reshape(o.shape[0], -1)
    match = (o[None, :, :] == -o[:, None, :]).all(-1)   # [g, j]: off[j] = −off[g]
    if not match.any(1).all():
        raise ValueError("bucket: the neighbour offsets are not symmetric "
                         f"({int((~match.any(1)).sum())} without a mirror)")
    return match.argmax(1).astype(np.int32)


def bucket(perm, rid, mrow, ent, lab, ukey, tkey, cperm, cstart, ccount, off, anchors, *,
           block_size: float, mirror=None):
    """(ent_s [M,D], ent_rel [M,D], lab_s [M] f32, nb_row [U,G], tb_u [T,G]
    int64) of the M sorted memberships: ``perm`` [M] int64 each one's row in
    the membership keys, ``rid`` [M] int32 its run (its block ``ukey[rid]``),
    ``mrow`` [≥ M] int32 each membership's entry row in ``ent`` [E,D] /
    ``lab`` [E] (K7c's rows); ``ukey`` [U] and ``tkey`` [T] the sorted
    entry-block and test-block keys; ``cperm`` [U·G], ``cstart``,
    ``ccount`` [T] int64 the candidate sort (sort index and runs) of the
    keys ukey[u] + off[g′] at u·G + g′; ``off`` [G] the neighbour offsets as
    key deltas, ``anchors`` [K,3] int32 the block anchors.  ``mirror`` [G]
    int32 on the tensors' device is :func:`mirror_slots` of ``off``; None
    derives it from ``off`` (on a card a host read, and a wait)."""
    if ent.device.type == "cpu":
        return bucket_runs_plain(perm, rid, mrow, ent, lab, ukey, tkey, cperm, cstart, ccount,
                                 off, anchors, block_size=block_size, mirror=mirror)
    if ent.device.type != "cuda":
        raise ValueError(f"bucket: unsupported device {ent.device}")
    global launches
    if mirror is None:
        mirror = torch.as_tensor(mirror_slots(off.cpu()), device=ent.device)
    want = {"perm": (perm, torch.int64), "rid": (rid, torch.int32),
            "mrow": (mrow, torch.int32), "ent": (ent, torch.float32),
            "lab": (lab, torch.float32), "ukey": (ukey, torch.int64),
            "tkey": (tkey, torch.int64), "cperm": (cperm, torch.int64),
            "cstart": (cstart, torch.int64), "ccount": (ccount, torch.int64),
            "off": (off, torch.int64), "mirror": (mirror, torch.int32),
            "anchors": (anchors, torch.int32)}
    for k, (x, dt) in want.items():
        if x.device != ent.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"bucket: {k} must be a contiguous {dt} tensor on {ent.device}")
    M, U, T, G = perm.shape[0], ukey.shape[0], tkey.shape[0], off.shape[0]
    D = ent.shape[1] if ent.dim() == 2 else 0
    if D not in (3, 6) or G not in (7, 27) or rid.shape != (M,) \
            or lab.shape != ent.shape[:1] or mrow.shape[0] < M or anchors.shape[1:] != (3,) \
            or cperm.shape != (U * G,) or cstart.shape != (T,) or ccount.shape != (T,) \
            or mirror.shape != (G,) or U == 0 or T == 0:
        raise ValueError("bucket: inconsistent shapes")
    if M >= 2 ** 30 or U * G >= 2 ** 30:
        raise ValueError(f"bucket: {M} rows, {U}·{G} candidates (fewer than 2^30 taken)")
    dev = ent.device
    ent_s = torch.empty((M, D), dtype=torch.float32, device=dev)
    ent_rel = torch.empty((M, D), dtype=torch.float32, device=dev)
    lab_s = torch.empty(M, dtype=torch.float32, device=dev)
    nb_row = torch.empty((U, G), dtype=torch.int64, device=dev)
    tb_u = torch.empty((T, G), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _build.lib().la3dm_ingest_bucket(
        perm.data_ptr(), rid.data_ptr(), mrow.data_ptr(), ent.data_ptr(), lab.data_ptr(),
        ukey.data_ptr(), cperm.data_ptr(), cstart.data_ptr(), ccount.data_ptr(),
        mirror.data_ptr(), anchors.data_ptr(), M, U, T, G, D, float(np.float32(block_size)),
        ent_s.data_ptr(), ent_rel.data_ptr(), lab_s.data_ptr(), nb_row.data_ptr(),
        tb_u.data_ptr(), stream)
    _build.check(code, "ingest_bucket")
    launches += 1
    return ent_s, ent_rel, lab_s, nb_row, tb_u


def _rows_plain(perm, rid, mrow, ent, lab, ukey, anchors, block_size: float):
    """(ent_s, ent_rel, lab_s): the gathers, and the centres subtracted."""
    eidx = mrow[perm].long()
    ent_s, lab_s = ent[eidx], lab[eidx]
    ctr = ingest_keys.unpack(ukey[rid.long()], anchors).to(torch.float32) \
        * float(np.float32(block_size))
    return ent_s, ent_s - ctr.repeat(1, ent.shape[1] // 3), lab_s


def bucket_plain(perm, rid, mrow, ent, lab, ukey, tkey, cperm, cstart, ccount, off, anchors,
                 *, block_size: float, mirror=None):
    """The plain PyTorch :func:`bucket` by search: gathers and
    ``torch.searchsorted`` (the candidate sort and ``mirror`` unread)."""
    U = ukey.shape[0]
    nb_row = torch.searchsorted(tkey, ukey[:, None] - off[None, :])
    want = tkey[:, None] + off[None, :]
    pos = torch.searchsorted(ukey, want)
    found = ukey[torch.clamp_max(pos, U - 1)] == want
    tb_u = torch.where(found, pos, U)
    return (*_rows_plain(perm, rid, mrow, ent, lab, ukey, anchors, block_size), nb_row, tb_u)


def bucket_runs_plain(perm, rid, mrow, ent, lab, ukey, tkey, cperm, cstart, ccount, off,
                      anchors, *, block_size: float, mirror=None):
    """The plain PyTorch :func:`bucket` read off the candidate runs, as the
    kernel reads them: member p = u·G + g′ of run t writes nb_row[u,
    mirror[g′]] = t and tb_u[t, mirror[g′]] = u (``tkey`` unread)."""
    U, T, G = ukey.shape[0], ccount.shape[0], off.shape[0]
    dev = ukey.device
    if mirror is None:
        mirror = torch.as_tensor(mirror_slots(off.cpu()), device=dev)
    t = torch.repeat_interleave(torch.arange(T, dtype=torch.int64, device=dev), ccount)
    u, g = cperm // G, mirror.long()[cperm % G]
    nb_row = torch.empty(U * G, dtype=torch.int64, device=dev)
    nb_row[u * G + g] = t
    tb_u = torch.full((T * G,), U, dtype=torch.int64, device=dev)
    tb_u[t * G + g] = u
    return (*_rows_plain(perm, rid, mrow, ent, lab, ukey, anchors, block_size),
            nb_row.view(U, G), tb_u.view(T, G))
