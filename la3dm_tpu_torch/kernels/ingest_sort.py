"""K7s — the stable sort and run cut of device ingest's scan-local keys:
windows, compact codes, wrapper, plain version and launch counter.

Replaces the key sorts of ``la3dm_tpu/geometry/device_ingest.py``:
``_downsample``'s sort of the voxel keys and ``_run_ends`` (lines 166-246),
and ``_bucket_align``'s sort of the membership keys, its payload sort and the
sort of the candidate test-block keys (lines 315, 338, 355).  For keys in the
int64 layout of :mod:`ingest_keys` (the sentinel marks an invalid row),
:func:`sort_runs` returns the stable sort index of the valid keys and their
runs (:class:`Runs`).

Each field of a valid key lies within a :class:`Window` round its scan's
anchor, which the statics bound: :func:`cell_window` for ds-voxel keys (the
outlier mask keeps points within ``mr + √3·ds`` of the origin),
:func:`block_window` for block memberships (entries within that reach, ±1
block for the closed box; one block more for the candidate test blocks,
whose neighbour offsets reach one block an axis).  The kernel sorts the
mixed-radix code of a key in that window, ``((scan·W + z)·W + y)·W + x``,
which orders keys as the int64 keys do in ``bits`` bits: :func:`pack_plain`
and :func:`unpack_plain` are its plain versions.  A valid key outside its
window raises (ValueError), on the card through a flag read at the one sync
of :func:`sort_runs`.

On CUDA tensors :func:`sort_runs` launches ``csrc/ingest_sort.cu`` and
waits once for the sizes; on CPU tensors it runs :func:`sort_runs_plain`.
Up to :data:`SMALL_SORT_KEYS` keys one CTA sorts and cuts the runs in one
launch; above, a histogram of every pass, one Onesweep pass a digit and the
run cut (:func:`kernels_per_sort`).  What bounds the kernel is bytes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from la3dm_tpu_torch.kernels import _build, ingest_keys
from la3dm_tpu_torch.utils import profiling

#: sorts run since the counter was last reset (one C call each, which
#: queues the kernels of :func:`kernels_per_sort`)
launches = 0
#: CUDA kernels those sorts queued
kernel_launches = 0

#: the most keys the one-CTA path takes (at most the kernel's tile, 4096); a
#: sort of more keys takes the multi-CTA path
SMALL_SORT_KEYS = 4096

#: the widest cell window device ingest accepts: ``device_ingest.beam_slots``
#: keeps 2·mr/ds + 8 ≤ 1024, so mr/ds ≤ 508, and :func:`cell_window` adds
#: √3 and 2
MAX_CELL_RADIUS = 512


@dataclasses.dataclass(frozen=True)
class Window:
    """Valid keys of ``scans`` scans whose fields lie within ``radius`` of
    their scan's anchor."""

    radius: int
    scans: int

    @property
    def width(self) -> int:
        return 2 * self.radius + 1

    @property
    def lo(self) -> int:
        """The field value of the window's low edge."""
        return ingest_keys.FIELD_BIAS - self.radius

    @property
    def bits(self) -> int:
        """Bit length of the largest code."""
        return max(1, (self.scans * self.width ** 3 - 1).bit_length())

    @property
    def passes(self) -> int:
        """Radix passes of at most 8 bits, equal digits."""
        return -(-self.bits // 8)

    @property
    def key_bytes(self) -> int:
        return 4 if self.bits <= 32 else 8

    def wider(self, margin: int) -> "Window":
        return Window(self.radius + margin, self.scans)


def _reach(mr: float, ds: float) -> float:
    """The outlier mask's reach (``ingest_beams.point_keys``' ``lim``)."""
    return mr + math.sqrt(3.0) * ds


def cell_window(mr: float, ds: float, scans: int) -> Window:
    """ds-voxel keys of points within the reach of their scan's origin (the
    raw points and the beam samples): |floor(p/ds) − floor(o/ds)| ≤
    ⌈reach/ds⌉ + 1, and 1 more for the f32 rounding of p·(1/ds)."""
    return Window(math.ceil(_reach(mr, ds) / ds) + 2, scans)


def block_window(mr: float, ds: float, block_size: float, scans: int) -> Window:
    """Block keys of closed-box memberships of entries within the reach:
    floor(e/bs + 0.5) lies within reach/bs + 0.5 of o/bs, the anchor within 1
    of o/bs, the second candidate 1 further, and 1 for f32 rounding."""
    return Window(math.ceil(_reach(mr, ds) / block_size) + 3, scans)


def widest_window(scans: int) -> Window:
    """The widest cell window of ``scans`` scans that device ingest accepts."""
    return Window(MAX_CELL_RADIUS, scans)


def small_sort(n_keys: int) -> bool:
    """Whether a sort of ``n_keys`` keys takes the one-CTA path."""
    return n_keys <= SMALL_SORT_KEYS


def kernels_per_sort(window: Window, n_keys: int) -> int:
    """CUDA kernels one sort of ``n_keys`` keys queues: one on the one-CTA
    path; else every pass's histogram, a pass each, and the run cut."""
    return 1 if small_sort(n_keys) else window.passes + 2


class Runs(NamedTuple):
    """The sort of N keys with V valid ones in R runs."""

    perm: torch.Tensor    # [V] int64: the stable sort index of the valid keys
    ukey: torch.Tensor    # [R] int64: each run's key
    starts: torch.Tensor  # [R] int64: its first row in perm
    counts: torch.Tensor  # [R] int64: its length
    rid: torch.Tensor | None  # [V] int32: the run of each sorted row (want_rid)


# ------------------------------------------------------------ compact codes

def pack_plain(keys: torch.Tensor, window: Window) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes [N] int64, −1 where the key is the sentinel or outside the
    window; outside [N] bool: valid keys outside the window)."""
    valid = keys != ingest_keys.SENT
    k = torch.where(valid, keys, 0)
    s = k >> 48
    W = window.width
    f = torch.stack([k & 0xFFFF, (k >> 16) & 0xFFFF, (k >> 32) & 0xFFFF], dim=-1) - window.lo
    inside = ((f >= 0) & (f < W)).all(-1) & (s < window.scans)
    code = ((s * W + f[:, 2]) * W + f[:, 1]) * W + f[:, 0]
    return torch.where(valid & inside, code, -1), valid & ~inside


def unpack_plain(codes: torch.Tensor, window: Window) -> torch.Tensor:
    """Keys [N] int64 of codes [N]."""
    W = window.width
    x = codes % W
    c = codes // W
    y = c % W
    c = c // W
    z = c % W
    s = c // W
    lo = window.lo
    return (s << 48) | ((z + lo) << 32) | ((y + lo) << 16) | (x + lo)


def _outside_error(n: int, window: Window) -> ValueError:
    return ValueError(f"ingest_sort: {n} valid key(s) outside their window (radius "
                      f"{window.radius}, {window.scans} scans)")


# ------------------------------------------------------------ the sort

def launch(keys: torch.Tensor, window: Window, *, want_rid: bool = False, count=None):
    """Queue K7s on the current stream and return without waiting: (out [4,
    N] int64 — perm, ukey, starts, counts, each valid on a prefix —, rid [N]
    int32 or None, status [4] int32 on the card — valid keys, runs, the
    out-of-window flag).  ``keys`` [N] int64 on a CUDA device, N ≥ 1;
    ``count`` (a one-element int32 tensor on that device, or None): sort
    only the first min(N, count) keys, the count read on the device."""
    global launches, kernel_launches
    if keys.device.type != "cuda":
        raise ValueError(f"ingest_sort.launch: unsupported device {keys.device}")
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("ingest_sort: keys must be a contiguous 1-D int64 tensor")
    N = keys.shape[0]
    if not 1 <= N < 2 ** 30:
        raise ValueError(f"ingest_sort: {N} keys (1 to 2^30 - 1 taken)")
    if window.scans < 1 or window.radius < 0 \
            or window.lo < 0 or window.lo + window.width > 0x10000:
        raise ValueError(f"ingest_sort: bad window {window}")
    dev = keys.device
    if count is not None and (count.device != dev or count.dtype != torch.int32
                              or count.numel() != 1):
        raise ValueError("ingest_sort: count must be a one-element int32 tensor on the "
                         "keys' device")
    lib = _build.lib()
    small = small_sort(N)
    # one allocation: out [4,N] int64, rid [N] int32, the workspace (its
    # first words the status)
    n_out, n_rid = _align(32 * N), _align(4 * N) if want_rid else 0
    n_work = lib.la3dm_ingest_sort_workspace(N, window.bits, window.key_bytes, int(small))
    buf = torch.empty(n_out + n_rid + n_work, dtype=torch.uint8, device=dev)
    out = buf[:32 * N].view(torch.int64).view(4, N)
    rid = buf[n_out:n_out + 4 * N].view(torch.int32) if want_rid else None
    work = buf[n_out + n_rid:]
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.la3dm_ingest_sort(
        keys.data_ptr(), N, window.lo, window.width, window.scans, window.bits,
        window.key_bytes, int(small), work.data_ptr(), n_work, out.data_ptr(),
        rid.data_ptr() if want_rid else None, None if count is None else count.data_ptr(),
        stream)
    _build.check(code, "ingest_sort")
    launches += 1
    kernel_launches += kernels_per_sort(window, N)
    return out, rid, work[:16].view(torch.int32)


def sort_runs(keys: torch.Tensor, window: Window, *, want_rid: bool = False,
              count=None) -> Runs:
    """The stable sort of ``keys`` [N] int64 restricted to its valid keys,
    and their runs (:class:`Runs`); ``window`` bounds the valid keys.
    ``count`` (a one-element int32 tensor on the keys' device, or None):
    only the first min(N, count) keys are sorted; the rest may hold
    anything (K7c's compact keys, whose count stays on the card)."""
    if keys.device.type == "cpu":
        return sort_runs_plain(keys, window, want_rid=want_rid, count=count)
    if keys.device.type != "cuda":
        raise ValueError(f"sort_runs: unsupported device {keys.device}")
    if keys.shape[0] == 0:
        return _empty(keys.device, want_rid)
    out, rid, status = launch(keys, window, want_rid=want_rid, count=count)
    with profiling.span("la3dm.sync.sort_runs"):
        host = host_status(keys.device)
        host.copy_(status, non_blocking=True)
        torch.cuda.current_stream(keys.device).synchronize()
        V, R, flag, _ = host.tolist()
    profiling.count("host_syncs")
    if flag:
        n_out = int(pack_plain(_first(keys, count), window)[1].sum())
        raise _outside_error(n_out, window)
    return Runs(out[0, :V], out[1, :R], out[2, :R], out[3, :R],
                rid[:V] if want_rid else None)


def _align(n: int) -> int:
    return -(-n // 256) * 256


#: a pinned host copy of the status words per device, reused by every sort
#: (each waits for its copy before the next can start)
_HOST_STATUS: dict = {}


def host_status(dev) -> torch.Tensor:
    """The pinned host copy of K7s's status words on ``dev``."""
    if dev not in _HOST_STATUS:
        _HOST_STATUS[dev] = torch.empty(4, dtype=torch.int32, pin_memory=True)
    return _HOST_STATUS[dev]


def _empty(dev, want_rid: bool) -> Runs:
    e = torch.empty(0, dtype=torch.int64, device=dev)
    return Runs(e, e, e, e, torch.empty(0, dtype=torch.int32, device=dev) if want_rid else None)


def _first(keys: torch.Tensor, count) -> torch.Tensor:
    """The keys a sort with ``count`` reads (a host read of the count)."""
    return keys if count is None else keys[:min(int(count.item()), keys.shape[0])]


def sort_runs_plain(keys: torch.Tensor, window: Window, *, want_rid: bool = False,
                    count=None) -> Runs:
    """The plain PyTorch :func:`sort_runs`: the window check of
    :func:`pack_plain`, then ``torch.sort(stable=True)`` and
    ``unique_consecutive`` over the int64 keys with a sentinel appended (its
    run, the last, dropped)."""
    keys = _first(keys, count)
    n_out = int(pack_plain(keys, window)[1].sum())
    if n_out:
        raise _outside_error(n_out, window)
    sent = torch.full((1,), ingest_keys.SENT, dtype=torch.int64, device=keys.device)
    skey, perm = torch.sort(torch.cat([keys, sent]), stable=True)
    ukey, counts = torch.unique_consecutive(skey, return_counts=True)
    ukey, counts = ukey[:-1], counts[:-1]
    V = int(counts.sum())
    rid = None
    if want_rid:
        rid = torch.repeat_interleave(torch.arange(len(counts), dtype=torch.int32,
                                                   device=keys.device), counts)
    return Runs(perm[:V], ukey, torch.cumsum(counts, 0) - counts, counts, rid)


def passes_bytes(n_keys: int, n_valid: int, n_runs: int, window: Window,
                 want_rid: bool) -> int:
    """Bytes K7s's launches move (each pass's reads and writes, the run
    cut's).  The one-CTA path reads the int64 keys once and writes perm and
    the runs.  Otherwise the histogram and the first pass read the int64
    keys (twice) and the first pass writes code and index; a later pass
    reads and writes code and index; the last writes an int64 index; the run
    cut reads the codes twice and writes the runs."""
    runs = n_runs * 24 + (4 * n_valid if want_rid else 0)
    if small_sort(n_keys):
        return 8 * n_keys + 8 * n_valid + runs
    kb = window.key_bytes
    total = 2 * 8 * n_keys + n_valid * (kb + 4)
    for p in range(1, window.passes):
        total += n_valid * ((kb + 4) + (kb + (8 if p == window.passes - 1 else 4)))
    if window.passes == 1:
        total += n_valid * 4    # the int64 index, not a u32
    return total + 2 * n_valid * kb + runs
