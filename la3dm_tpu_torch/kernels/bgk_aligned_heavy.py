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
bgk_aligned_heavy.cu`` (one warp per (test block, 32 nodes) work unit, the
nodes in ``bgk_heavy.node_order``; exact warp-level culling in K1′'s own
frame; no atomics on the output); on CPU tensors it runs
:func:`bgk_aligned_heavy_plain`.  :func:`bgk_aligned_heavy_cull` is the
kernel's culling predicate in plain PyTorch.  What bounds the kernel is FP32
arithmetic on the CUDA cores (``bgk_heavy.FLOP_PER_EVAL`` a point evaluation,
``bgk_heavy.FLOP_PER_EVAL_SEGMENT`` a segment one) on the pairs the culling
keeps; parity keeps it off the tensor cores.
"""

from __future__ import annotations

import torch

from la3dm_tpu_torch.kernels import _build, bgk_heavy, math as km

#: the JAX step's entry-row width: each row is summed, then the rows
WA = 8
#: entries a warp of the kernel takes at a time, one a lane
STEP = 32
#: the most slots the kernel takes: four warps' rows of 2G + 1 floats a lane
#: within 48 KB of shared memory (BGK and BGKL use 7 or 27)
MAX_G = 47
#: kernel launches since the counter was last reset (one per dispatch)
launches = 0


def bgk_aligned_heavy(ent_rel, labels, ustart, ucount, tb_u, ext_nodes, *, G: int,
                      sf2: float, ell: float, culled=None):
    """acc [T, Vall, 2G] f32 (ȳ_g | k̄_g per test block and node).
    ``ent_rel`` [M,3] (points) or [M,6] (segments) / ``labels`` [M] hold the
    block-sorted entries;
    ``ustart``/``ucount`` [U] int64 each entry block's run; ``tb_u`` [T,G]
    int64; ``ext_nodes`` [G·Vall, 3].  ``culled`` (an int64 [1] tensor on the
    card, or None) counts the (warp, entry) pairs the kernel's warps skip."""
    if ent_rel.device.type == "cpu":
        return bgk_aligned_heavy_plain(ent_rel, labels, ustart, ucount, tb_u, ext_nodes,
                                       G=G, sf2=sf2, ell=ell)
    if ent_rel.device.type != "cuda":
        raise ValueError(f"bgk_aligned_heavy: unsupported device {ent_rel.device}")
    global launches
    want = {"ent_rel": (ent_rel, torch.float32), "labels": (labels, torch.float32),
            "ustart": (ustart, torch.int64), "ucount": (ucount, torch.int64),
            "tb_u": (tb_u, torch.int64), "ext_nodes": (ext_nodes, torch.float32)}
    if culled is not None:
        want["culled"] = (culled, torch.int64)
    for k, (x, dt) in want.items():
        if x.device != ent_rel.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"bgk_aligned_heavy: {k} must be a contiguous {dt} tensor "
                             f"on {ent_rel.device}")
    T, U = tb_u.shape[0], ucount.shape[0]
    D = ent_rel.shape[1] if ent_rel.dim() == 2 else 0
    if (D not in (3, 6) or labels.shape != ent_rel.shape[:1]
            or ustart.shape != (U,) or tb_u.shape[1:] != (G,)
            or ext_nodes.shape[1:] != (3,) or ext_nodes.shape[0] % G
            or (culled is not None and culled.shape != (1,))):
        raise ValueError("bgk_aligned_heavy: inconsistent shapes")
    if G > MAX_G:
        raise ValueError(f"bgk_aligned_heavy: G={G} (the kernel takes at most {MAX_G})")
    Vall = ext_nodes.shape[0] // G
    acc = torch.empty((T, Vall, 2 * G), dtype=torch.float32, device=ent_rel.device)
    if T == 0:
        return acc
    order = bgk_heavy.node_order(Vall, str(ent_rel.device))
    stream = torch.cuda.current_stream(ent_rel.device).cuda_stream
    code = _build.lib().la3dm_bgk_aligned_heavy(
        ent_rel.data_ptr(), labels.data_ptr(), ustart.data_ptr(), ucount.data_ptr(),
        tb_u.data_ptr(), ext_nodes.data_ptr(), order.data_ptr(),
        culled.data_ptr() if culled is not None else None, T, U, Vall, G, D, float(sf2),
        float(ell), bgk_heavy.cull_reach(ell), acc.data_ptr(), stream)
    _build.check(code, "bgk_aligned_heavy")
    launches += 1
    return acc


def aligned_steps(ucount, tb_u):
    """The kernel's steps: each (t, g) pair with an entry block (``tb_u[t,
    g]`` < U), in (t, g) order, walks its block's run STEP entries at a time.
    Returns (pair, offset, count) [S] int64: the pair's flat index t·G + g,
    the step's first entry within the run, and its entries (1..STEP)."""
    U, dev = ucount.shape[0], ucount.device
    flat = tb_u.reshape(-1)
    pair = torch.nonzero(flat < U).reshape(-1)
    cnt = ucount[flat[pair]]
    nstep = (cnt + STEP - 1) // STEP
    step_pair = torch.repeat_interleave(torch.arange(len(pair), device=dev), nstep)
    k = torch.arange(len(step_pair), device=dev) - (torch.cumsum(nstep, 0) - nstep)[step_pair]
    return pair[step_pair], STEP * k, (cnt[step_pair] - STEP * k).clamp(max=STEP)


def bgk_aligned_heavy_cull(ent_rel, ustart, ucount, tb_u, ext_nodes, *, G: int, ell: float,
                           per_warp: bool = False, chunk: int = 1 << 22):
    """The kernel's culling predicate in plain PyTorch: [S, ⌈Vall/32⌉, STEP]
    bool over (step of :func:`aligned_steps`, warp, entry of the step), True
    where the warp's nodes ``node_order(Vall)[32·w : 32·w + 32]`` of the
    step's slot table ``ext_nodes[g]`` skip the entry, False for padding
    entries; with ``per_warp``, the culled pairs of each warp [⌈Vall/32⌉]
    int64 summed over the steps (``chunk`` node points at a time).

    An entry is skipped where its segment (a point entry: the point) misses
    the box of the warp's live nodes, taken from ext_nodes[g]'s f32 values,
    padded by r_c·ℓ (``bgk_heavy.cull_reach``) and the margin 1e-4·(1 + |x|)
    (``km.warp_box``, ``km.segment_misses_box``).  Then the kernel's value
    is exactly 0 at every node of the warp.  Segments: every node lies
    farther than r_c·ℓ from the segment, and the sparse kernel is 0 from
    r_c on (``bgk_heavy.R_CULL``).  Points: the kernel evaluates
    ``sqrt(dist2(x/ℓ − e/ℓ))``.  A culled point lies, on some axis, farther
    than ℓ + m/2 from each node x (m the margin); the two divisions and the
    difference lose at most about 2⁻²³·(|x − e| + |x|)/ℓ of the scaled
    difference, less than the m/(2ℓ) to spare for every ℓ below about
    400 m, so |dx| ≥ 1, d2 ≥ dx² ≥ 1 (monotone rounding), r = √d2 ≥ 1 and the
    kernel is 0 (``tests/test_torch_cull.py`` holds this on the CPU)."""
    Vall = ext_nodes.shape[0] // G
    wpb, dev = (Vall + 31) // 32, ent_rel.device
    pair, off, count = aligned_steps(ucount, tb_u)
    start = ustart[tb_u.reshape(-1)[pair]] + off
    order = bgk_heavy.node_order(Vall, str(dev)).long()
    nodes = torch.nn.functional.pad(ext_nodes.view(G, Vall, 3)[:, order],
                                    (0, 0, 0, wpb * 32 - Vall))
    live = (torch.arange(wpb * 32, device=dev) < Vall).view(wpb, 32)
    slot = pair % G
    rows = max(1, chunk // (wpb * 32))
    ids = torch.arange(ent_rel.shape[0], device=dev)

    def cull(s0, s1):
        return km.warp_cull(lambda c0, c1: nodes[slot[s0 + c0:s0 + c1]].view(-1, wpb, 32, 3),
                            live, bgk_heavy.cull_reach(ell), ent_rel, ids, start[s0:s1],
                            count[s0:s1], row_w=STEP, chunk=rows)

    S = len(pair)
    if not per_warp:
        return cull(0, S)
    per = torch.zeros(wpb, dtype=torch.int64, device=dev)
    for s0 in range(0, S, rows):
        per += cull(s0, min(S, s0 + rows)).sum((0, 2))
    return per


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
