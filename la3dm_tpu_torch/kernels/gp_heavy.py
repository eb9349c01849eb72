"""K4 — the GP heavy pass: wrapper, plain version and launch counter.

Replaces ``la3dm_tpu/models/gp.py::_gp_heavy`` (lines 61-116, with
``kernels/gp.py::gp_train_core`` / ``gp_predict_core`` and
``kernels/math.py::cov_matern32``) for one size tier: every block model's
exact GP (Matérn-3/2 Gram + noise·I, Cholesky, α = K⁻¹y), predicted at the
all-level node centres of each test block it serves, set into the
per-(block row, slot) tables ``acc_mean``/``acc_var`` [Tp·G, Vall] and
``present`` [Tp·G] in place.  A model whose Gram is not positive definite
gives NaN outputs and is added to ``failed``.

A size tier is the set of models the map passes in one call; the tier's
largest point count, ``cmax``, takes the place of the JAX step's padded size
S.  The JAX step pads every model to S with far-staggered points, which
makes the padded Gram block-diagonal and the padded kernel rows exactly 0,
so any padded size ≥ the true count gives the same numbers.

On a CUDA tensor :func:`gp_heavy` launches the hand-written kernels
(``csrc/gp_heavy.cu``): a blocked factor over all of the tier's models —
one warp a model up to 32 points, else 64 × 64 tiles spread over CTAs, one
launch a step (:func:`factor_items`), L in f32, W = L⁻¹ in f64 — then a
persistent predict over (model, tile of query nodes) units, each over the
slots its model serves: one warp a unit of 16 nodes in a base tier, one
CTA a unit of :func:`predict_tiling`'s nodes above; every sum in f64, the
tile products on the tensor cores' f64 MMA.  The tier runs in chunks whose
workspaces stay under ``_WS_ELEMS`` (:func:`plan_chunks`).  On a CPU
tensor it runs :func:`gp_heavy_plain`, the JAX step's padded, chunked batch
at S = cmax.  What bounds the kernels is the predict's arithmetic
(:func:`flops`).
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import _build, gp as kgp

#: the base tier holds the models of at most this many points (the map's
#: size-tier split, models/gp.py)
BASE_MAX_C = 128
#: the factor's tile edge (``csrc/gp_heavy.cu`` TILE); a model of at most
#: TILE points is one tile of its count rounded up to 16
TILE = 64
#: models padded to at most this many points are factored one a warp
#: (``csrc/gp_heavy.cu`` SMALL_C)
SMALL_C = 32
#: bound on each chunk's Σ cp², the elements of its L (f32), W (f64) and
#: W's f32 copy (8 GiB in all)
_WS_ELEMS = 1 << 29
#: shared memory a predict CTA may give its Ks tile, its partial sums and
#: its query coordinates (of the H100's 227 KB a block)
_SMEM_BYTES = 200 * 1024
#: shared-memory bytes a query column costs beside its Ks column: 2 × 16
#: f64 partial sums and 3 f32 coordinates
_COL_BYTES = 2 * 16 * 8 + 3 * 4
#: most query nodes a predict unit takes
_NQ_MAX = 256
#: query nodes a unit takes when its Ks lives in the global workspace
_NQ_GLOBAL = 64
#: predict CTAs per SM that the global Ks workspace is sized for
_GRID_PER_SM = 8
#: launch phases of the factor (``csrc/gp_heavy.cu``)
DIAG, PANEL, WINV, Z, SMALL = 0, 1, 2, 3, 4
#: kernel launches since the counter was last reset (one per dispatch tier)
launches = 0

_INT_ARGS = ("starts", "counts", "nb_rows")


def chunk_for(S: int) -> int:
    """Model-chunk size of the plain version, bounding its [chunk, S, S]
    factor (the JAX step's ``_chunk_for``)."""
    return max(1, min(256, (1 << 24) // max(S * S, 1)))


def flops(counts, served, Vall: int) -> float:
    """Operations of K4 on models with these point counts, each serving
    ``served`` (block, slot) rows of Vall query nodes: the Gram ≈ 12c², the
    factor c³/3 multiply-adds, the two solves 2c², and per query column
    12c (its kernel row) + c² (v = L⁻¹Ks) + 4c (mean and Σv²)."""
    c = np.asarray(counts, np.float64)
    q = np.asarray(served, np.float64) * Vall
    return float((12 * c ** 2 + 2 * c ** 3 / 3 + 2 * c ** 2
                  + q * (12 * c + c ** 2 + 4 * c)).sum())


def served_rows(nb_rows, Tp: int) -> np.ndarray:
    """Per model, the slots that serve a test block (0 ≤ row < Tp)."""
    nb = np.asarray(nb_rows)
    return ((nb >= 0) & (nb < Tp)).sum(axis=1)


def padded_size(counts) -> np.ndarray:
    """Each model's padded size cp: its count rounded up to 16 up to TILE
    points (one tile), else to a multiple of TILE."""
    c = np.asarray(counts, np.int64)
    return np.where(c <= TILE, (c + 15) & -16, (c + TILE - 1) & -TILE)


def plan_chunks(counts) -> list[np.ndarray]:
    """The tier's models with points, largest first (stable), cut into
    chunks whose Σ cp² stays within ``_WS_ELEMS`` (a larger model is a
    chunk of its own)."""
    c = np.asarray(counts, np.int64)
    key = c.max(initial=0) - c  # a 16-bit key sorts by radix
    order = np.argsort(key.astype(np.uint16) if key.max(initial=0) < 1 << 16 else key,
                       kind="stable")
    order = order[c[order] > 0]
    cum = np.cumsum(padded_size(c[order]) ** 2)
    chunks, first = [], 0
    while first < len(order):
        base = cum[first - 1] if first else 0
        end = max(int(np.searchsorted(cum, base + _WS_ELEMS, side="right")), first + 1)
        chunks.append(order[first:end])
        first = end
    return chunks


def _ranks(sizes) -> np.ndarray:
    """0..n-1 within each group of ``sizes``, concatenated."""
    sizes = np.asarray(sizes, np.int64)
    return np.arange(sizes.sum()) - np.repeat(np.cumsum(sizes) - sizes, sizes)


def factor_items(cp) -> tuple[np.ndarray, np.ndarray]:
    """The factor's launches for models of padded sizes ``cp`` (not
    increasing, so that the models of more than k tiles are a prefix and
    the models of at most SMALL_C points a suffix): ``steps`` [launches, 4]
    int32 (phase, step, first, count) in launch order, and ``items`` [n, 2]
    int32 (model, row tile) of the PANEL launches.  SMALL: models first ..
    first + count - 1, one warp each.  DIAG step k: models 0 .. count - 1,
    those of more than k tiles.  PANEL step k: items first .. first + count
    - 1, the tiles i > k of those models.  WINV step i: count = n·i CTAs,
    CTA b on model b // i, tile column b % i (j < i).  Z: models 0 ..
    count - 1, one CTA each."""
    cp = np.asarray(cp, np.int64)
    if np.any(np.diff(cp) > 0):
        raise ValueError("factor_items: cp must not increase")
    n_big = int((cp > SMALL_C).sum())
    nt = -(-cp[:n_big] // TILE)
    over = [int((nt > k).sum()) for k in range(int(nt.max(initial=0)))]
    steps, items, first = [], [], 0
    if n_big < len(cp):
        steps.append((SMALL, 0, n_big, len(cp) - n_big))
    for k, n in enumerate(over):
        steps.append((DIAG, k, 0, n))
        below = nt[:n] - k - 1
        if below.any():
            items.append(np.stack([np.repeat(np.arange(n), below), k + 1 + _ranks(below)], 1))
            steps.append((PANEL, k, first, len(items[-1])))
            first += len(items[-1])
    steps += [(WINV, i, 0, n * i) for i, n in enumerate(over) if i]
    if n_big:
        steps.append((Z, 0, 0, n_big))
    items = np.concatenate(items) if items else np.zeros((0, 2), np.int64)
    return (items.astype(np.int32).reshape(-1, 2),
            np.asarray(steps, np.int32).reshape(-1, 4))


def predict_tiling(c16max: int, Vall: int, smem_bytes: int | None = None):
    """(nq, n_tiles, shared) of the CTA predict: query nodes a unit takes
    (a multiple of 16), node tiles a model's units cover, and whether a
    unit's Ks [c16max, nq] fits in shared memory (else a global
    workspace)."""
    budget = _SMEM_BYTES if smem_bytes is None else smem_bytes
    cap = budget // (4 * c16max + _COL_BYTES) // 16 * 16
    shared = cap >= 16
    cap = min(cap if shared else _NQ_GLOBAL, _NQ_MAX)
    n_tiles = -(-Vall // cap)
    nq = -(-(-(-Vall // n_tiles)) // 16) * 16
    return nq, n_tiles, shared


def _pinned(x: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` through pinned memory, without a sync."""
    return torch.from_numpy(np.ascontiguousarray(x)).pin_memory().to(device,
                                                                     non_blocking=True)


def gp_heavy(pts, lab, starts, counts, nb_rows, centers, all_nodes, acc_mean,
             acc_var, present, failed, *, host_counts, sf2: float, ell: float,
             noise: float) -> None:
    """One tier's models into the prediction tables, in place.  ``counts``
    [M] on the device and ``host_counts``, the same counts as a host array
    (the launch plan is built from them without a host sync); the tier's
    largest count takes the place of the JAX step's padded size S.
    ``nb_rows`` [M, G]: the block-list row model m serves at slot g (≥ Tp ⇒
    none).  ``failed`` [1] int32 counts failed factorisations."""
    hc = np.asarray(host_counts).astype(np.int64)
    M, G = nb_rows.shape
    if hc.shape != (M,):
        raise ValueError("gp_heavy: host_counts must hold counts' M values")
    if M == 0:
        return
    if hc.min() < 0 or hc.max() <= 0:
        raise ValueError("gp_heavy: host_counts must be >= 0, some > 0")
    if pts.device.type == "cpu":
        gp_heavy_plain(pts, lab, starts, counts, nb_rows, centers, all_nodes,
                       acc_mean, acc_var, present, failed, cmax=int(hc.max()), sf2=sf2,
                       ell=ell, noise=noise)
        return
    if pts.device.type != "cuda":
        raise ValueError(f"gp_heavy: unsupported device {pts.device}")
    global launches
    args = dict(pts=pts, lab=lab, starts=starts, counts=counts, nb_rows=nb_rows,
                centers=centers, all_nodes=all_nodes, acc_mean=acc_mean,
                acc_var=acc_var, present=present, failed=failed)
    want = {k: torch.float32 for k in ("pts", "lab", "centers", "all_nodes",
                                       "acc_mean", "acc_var")}
    want.update({k: torch.int32 for k in (*_INT_ARGS, "failed")}, present=torch.bool)
    for k, x in args.items():
        if x.device != pts.device or x.dtype != want[k] or not x.is_contiguous():
            raise ValueError(f"gp_heavy: {k} must be a contiguous {want[k]} "
                             f"tensor on {pts.device}")
    Tp, Vall = centers.shape[0], all_nodes.shape[0]
    if (pts.shape[1:] != (3,) or centers.shape[1:] != (3,)
            or all_nodes.shape[1:] != (3,) or lab.shape[0] != pts.shape[0]
            or starts.shape[0] != M or counts.shape[0] != M
            or acc_mean.shape != (Tp * G, Vall) or acc_var.shape != (Tp * G, Vall)
            or present.shape != (Tp * G,) or failed.numel() != 1):
        raise ValueError("gp_heavy: inconsistent shapes")
    dev = pts.device
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s = float(np.float32(1.73205 / float(ell)))
    base = int(hc.max()) <= BASE_MAX_C
    chunks = plan_chunks(hc)
    for models in chunks:
        cp = padded_size(hc[models])
        minfo = np.empty((len(models), 4), np.int32)  # model, cp, W offset, z offset
        minfo[:, 0], minfo[:, 1] = models, cp
        minfo[1:, 2], minfo[1:, 3] = np.cumsum(cp[:-1] ** 2), np.cumsum(cp[:-1])
        minfo[0, 2:] = 0
        items, steps = factor_items(cp)
        c16max = int(-(-hc[models].max() // 16) * 16)
        if base:  # one warp a unit of 16 nodes
            nq, n_tiles, shared = 16, -(-Vall // 16), True
        else:
            nq, n_tiles, shared = predict_tiling(c16max, Vall)
        minfo_d = _pinned(minfo, dev)
        items_d = _pinned(items, dev)
        Lw = torch.empty(int(minfo[-1, 2]) + int(cp[-1]) ** 2, dtype=torch.float32,
                         device=dev)
        Wd = torch.empty(Lw.numel(), dtype=torch.float64, device=dev)
        Wf = torch.empty_like(Lw)
        zw = torch.empty(int(minfo[-1, 3]) + int(cp[-1]), dtype=torch.float64, device=dev)
        mfail = torch.zeros(len(models), dtype=torch.int32, device=dev)
        queue = torch.empty(1, dtype=torch.int32, device=dev)
        grid_cap = sms * _GRID_PER_SM
        ks_ws = (None if shared else
                 torch.empty(grid_cap * c16max * nq, dtype=torch.float32, device=dev))
        code = lib.la3dm_gp_heavy(
            pts.data_ptr(), lab.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            nb_rows.data_ptr(), centers.data_ptr(), all_nodes.data_ptr(),
            minfo_d.data_ptr(), items_d.data_ptr(), steps.ctypes.data, len(steps),
            Lw.data_ptr(), Wd.data_ptr(), Wf.data_ptr(), zw.data_ptr(), mfail.data_ptr(),
            queue.data_ptr(), None if ks_ws is None else ks_ws.data_ptr(),
            acc_mean.data_ptr(), acc_var.data_ptr(), present.data_ptr(), failed.data_ptr(),
            Tp, G, Vall, nq, n_tiles, len(models), c16max, grid_cap, int(base), s,
            float(np.float32(sf2)), float(np.float32(noise)), stream)
        _build.check(code, "gp_heavy")
    if chunks:  # models without points launch nothing
        launches += 1


def gp_heavy_plain(pts, lab, starts, counts, nb_rows, centers, all_nodes, acc_mean,
                   acc_var, present, failed, *, cmax: int, sf2: float, ell: float,
                   noise: float) -> None:
    """The plain PyTorch heavy pass, as the JAX step computes it: models
    padded to S = cmax, in chunks of :func:`chunk_for`, through
    ``kernels/gp.py``."""
    S = int(cmax)
    M, G = nb_rows.shape
    N, Tp, Vall = pts.shape[0], centers.shape[0], all_nodes.shape[0]
    dev = pts.device
    scol = torch.arange(S, device=dev)
    gcol = torch.arange(G, device=dev)
    chunk = chunk_for(S)
    for c0 in range(0, M, chunk):
        st = starts[c0:c0 + chunk].long()
        ct = counts[c0:c0 + chunk].long()
        nbt = nb_rows[c0:c0 + chunk].long()
        valid = scol < ct[:, None]                                  # [c,S]
        idx = torch.clamp_max(st[:, None] + scol, N - 1)
        p = pts[idx]                                                # [c,S,3]
        y = torch.where(valid, lab[idx], 0.0)
        L, alpha = kgp.gp_train_core(p, y, valid, sf2, ell, noise)
        failed += torch.isnan(L[:, 0, 0]).sum().to(torch.int32)
        ctr = centers[torch.clamp_max(nbt, Tp - 1)]                 # [c,G,3]
        xq = (all_nodes[None, None] + ctr[:, :, None, :]).reshape(-1, G * Vall, 3)
        mean, var = kgp.gp_predict_core(L, alpha, p, valid, xq, sf2, ell)
        serve = (ct > 0)[:, None] & (nbt < Tp)                      # [c,G]
        flat = (nbt * G + gcol)[serve]
        acc_mean[flat] = mean.reshape(-1, G, Vall)[serve]
        acc_var[flat] = var.reshape(-1, G, Vall)[serve]
        present[flat] = True
