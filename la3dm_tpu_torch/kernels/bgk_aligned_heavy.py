"""K1′ — the BGK heavy pass of the device-ingest path, for point entries
(BGK) and segment entries (BGKL): wrapper, plain version and launch
counter.

Replaces ``la3dm_tpu/models/bgk.py::_aligned_heavy`` (lines 204-252) and the
accumulator half of ``_bgk_seq_step_aligned`` (lines 255-302).  For each
test block t and slot g, the entries of entry block u = ``tb_u[t, g]`` (U:
none), relative to u's centre, against the shifted node table
``ext_nodes[g] = all_nodes − off_g·bs``: the clamped sparse kernel's
Σ label·k and Σ k, into acc[T, Vall, 2G] — K2's accumulator layout, so the
light pass runs unchanged after it.  Segment entries ([M,6], start and end
both relative to the centre, lines 229-230) take the point-to-segment
distance (``cov_sparse_segment(lv=False)``).  Sums run over rows of Wa = 8 entries
from the start of u's run, then over the rows, as the JAX step sums them.

On CUDA tensors :func:`bgk_aligned_heavy` launches ``csrc/
bgk_aligned_heavy.cu`` (one CTA per test block, one thread per node, no
atomics); on CPU tensors it runs :func:`bgk_aligned_heavy_plain`.  What bounds
the kernel is FP32 arithmetic on the CUDA cores (``bgk_heavy.FLOP_PER_EVAL`` a
point evaluation, ``bgk_heavy.FLOP_PER_EVAL_SEGMENT`` a segment one);
parity keeps it off the tensor cores.
"""

from __future__ import annotations

import torch

from la3dm_tpu_torch.kernels import _build, math as km

#: the JAX step's entry-row width: each row is summed, then the rows
WA = 8
#: kernel launches since the counter was last reset (one per dispatch)
launches = 0


def bgk_aligned_heavy(ent_rel, labels, ustart, ucount, tb_u, ext_nodes, *, G: int,
                      sf2: float, ell: float):
    """acc [T, Vall, 2G] f32 (ȳ_g | k̄_g per test block and node).
    ``ent_rel`` [M,3] (points) or [M,6] (segments) / ``labels`` [M] hold the
    block-sorted entries;
    ``ustart``/``ucount`` [U] int64 each entry block's run; ``tb_u`` [T,G]
    int64; ``ext_nodes`` [G·Vall, 3]."""
    if ent_rel.device.type == "cpu":
        return bgk_aligned_heavy_plain(ent_rel, labels, ustart, ucount, tb_u, ext_nodes,
                                       G=G, sf2=sf2, ell=ell)
    if ent_rel.device.type != "cuda":
        raise ValueError(f"bgk_aligned_heavy: unsupported device {ent_rel.device}")
    global launches
    want = {"ent_rel": (ent_rel, torch.float32), "labels": (labels, torch.float32),
            "ustart": (ustart, torch.int64), "ucount": (ucount, torch.int64),
            "tb_u": (tb_u, torch.int64), "ext_nodes": (ext_nodes, torch.float32)}
    for k, (x, dt) in want.items():
        if x.device != ent_rel.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"bgk_aligned_heavy: {k} must be a contiguous {dt} tensor "
                             f"on {ent_rel.device}")
    T, U = tb_u.shape[0], ucount.shape[0]
    D = ent_rel.shape[1] if ent_rel.dim() == 2 else 0
    if (D not in (3, 6) or labels.shape != ent_rel.shape[:1]
            or ustart.shape != (U,) or tb_u.shape[1:] != (G,)
            or ext_nodes.shape[1:] != (3,) or ext_nodes.shape[0] % G):
        raise ValueError("bgk_aligned_heavy: inconsistent shapes")
    Vall = ext_nodes.shape[0] // G
    acc = torch.empty((T, Vall, 2 * G), dtype=torch.float32, device=ent_rel.device)
    if T == 0:
        return acc
    stream = torch.cuda.current_stream(ent_rel.device).cuda_stream
    code = _build.lib().la3dm_bgk_aligned_heavy(
        ent_rel.data_ptr(), labels.data_ptr(), ustart.data_ptr(), ucount.data_ptr(),
        tb_u.data_ptr(), ext_nodes.data_ptr(), T, U, Vall, G, D, float(sf2), float(ell),
        acc.data_ptr(), stream)
    _build.check(code, "bgk_aligned_heavy")
    launches += 1
    return acc


def bgk_aligned_heavy_plain(ent_rel, labels, ustart, ucount, tb_u, ext_nodes, *, G: int,
                            sf2: float, ell: float, budget: int = 1 << 22):
    """The plain PyTorch K1′: the (t, g) pairs with an entry block, longest
    run first, in chunks of about ``budget`` kernel evaluations; each pair's
    sums in the kernel's order (each Wa-row in entry order, then the rows)."""
    T, U = tb_u.shape[0], ucount.shape[0]
    Vall = ext_nodes.shape[0] // G
    dev = ent_rel.device
    out = torch.zeros((T * G, 2, Vall), dtype=torch.float32, device=dev)
    flat = tb_u.reshape(-1)
    pair = torch.nonzero(flat < U).reshape(-1)
    if pair.numel():
        u = flat[pair]
        cnt = ucount[u]
        order = torch.argsort(cnt, descending=True, stable=True)
        pair, u, cnt = pair[order], u[order], cnt[order]
        cnt_h = cnt.cpu().tolist()
        nodes = ext_nodes.view(G, Vall, 3)
        c0 = 0
        while c0 < len(cnt_h):
            W = max(cnt_h[c0], 1)
            c1 = min(len(cnt_h), c0 + max(1, budget // (W * Vall)))
            _pairs_plain(out, pair[c0:c1], ustart[u[c0:c1]], cnt[c0:c1], W, nodes, ent_rel,
                         labels, G=G, sf2=sf2, ell=ell)
            c0 = c1
    # [T·G, 2, Vall] → [T, Vall, 2G]: (ȳ_g | k̄_g) per node
    return out.view(T, G, 2, Vall).permute(0, 3, 2, 1).reshape(T, Vall, 2 * G).contiguous()


def _pairs_plain(out, pair, st, cnt, W: int, nodes, ent_rel, labels, *, G: int,
                 sf2: float, ell: float) -> None:
    """One chunk of (t, g) pairs, each with ≤ W entries, into ``out``."""
    wcol = torch.arange(W, device=ent_rel.device)
    valid = wcol[None, :] < cnt[:, None]                                  # [c,W]
    idx = torch.where(valid, st[:, None] + wcol[None, :], 0)
    if ent_rel.shape[1] == 6:
        K = km.cov_sparse_segment(nodes[pair % G], ent_rel[idx], sf2, ell)  # [c,Vall,W]
    else:
        K = km.cov_sparse(nodes[pair % G], ent_rel[idx], sf2, ell)
    K = torch.where(valid[:, None, :], K, 0.0)
    lab = torch.where(valid, labels[idx], 0.0)
    ybar = torch.zeros(K.shape[:2], dtype=torch.float32, device=K.device)
    kbar = torch.zeros_like(ybar)
    for r0 in range(0, W, WA):
        ry = K[:, :, r0] * lab[:, None, r0]
        rk = K[:, :, r0]
        for w in range(r0 + 1, min(r0 + WA, W)):
            ry = ry + K[:, :, w] * lab[:, None, w]
            rk = rk + K[:, :, w]
        ybar = ybar + ry
        kbar = kbar + rk
    out[pair, 0] = ybar
    out[pair, 1] = kbar
