"""K4 — the GP heavy pass: wrapper, plain version and launch counter.

Replaces ``la3dm_tpu/models/gp.py::_gp_heavy`` (lines 61-116, with
``kernels/gp.py::gp_train_core`` / ``gp_predict_core`` and
``kernels/math.py::cov_matern32``) for one size tier: every block model's
exact GP (Matérn-3/2 Gram + noise·I, Cholesky, α = K⁻¹y), predicted at the
all-level node centres of each test block it serves, set into the
per-(block row, slot) tables ``acc_mean``/``acc_var`` [Tp·G, Vall] and
``present`` [Tp·G] in place.  A model whose Gram is not positive definite
gives NaN outputs and is added to ``failed``.

A size tier is the set of models the map passes in one call; ``cmax``, the
tier's largest point count, takes the place of the JAX step's padded size
S.  The JAX step pads every model to S with far-staggered points, which
makes the padded Gram block-diagonal and the padded kernel rows exactly 0,
so any padded size ≥ the true count gives the same numbers.

On a CUDA tensor :func:`gp_heavy` launches the hand-written kernel
(``csrc/gp_heavy.cu``: one CTA per model on its true point count; for
cmax ≤ 128, the base tier, the factor lives in shared memory, otherwise in
a global workspace, with the solves and each query's sums carried in f64);
on a CPU tensor it runs :func:`gp_heavy_plain`, the JAX step's padded,
chunked batch at S = cmax.  What bounds the kernel is FP32 arithmetic on
the CUDA cores (:func:`flops`).
"""

from __future__ import annotations

import numpy as np
import torch

from la3dm_tpu_torch.kernels import _build, gp as kgp

#: base tier: counts ≤ this run with the factor in shared memory
SHARED_MAX_C = 128
#: CUDA threads per CTA of the base tier (whose threads' v columns share
#: the shared memory with the factor) and of the overflow tier; the
#: launcher takes the count from here and sizes its workspace stride by it
_THREADS_SHARED = 128
_THREADS_GLOBAL = 256
#: bound on the overflow tier's workspace, in floats (2 GiB)
_WS_FLOATS = 1 << 29
#: kernel launches since the counter was last reset (one per dispatch tier)
launches = 0

_INT_ARGS = ("starts", "counts", "nb_rows")


def chunk_for(S: int) -> int:
    """Model-chunk size of the plain version, bounding its [chunk, S, S]
    factor (the JAX step's ``_chunk_for``)."""
    return max(1, min(256, (1 << 24) // max(S * S, 1)))


def flops(counts, Q: int) -> float:
    """Operations of K4 on models with these point counts and Q = G·Vall
    queries each: the Gram ≈ 12c², the factor c³/3 multiply-adds, the two
    solves 2c², the predict Q·(12c + c² + 4c)."""
    c = np.asarray(counts, np.float64)
    return float((12 * c ** 2 + 2 * c ** 3 / 3 + 2 * c ** 2
                  + Q * (12 * c + c ** 2 + 4 * c)).sum())


def gp_heavy(pts, lab, starts, counts, nb_rows, centers, all_nodes, acc_mean,
             acc_var, present, failed, *, cmax: int, sf2: float, ell: float,
             noise: float) -> None:
    """One tier's models (``counts`` in (0, cmax], cmax a host integer) into
    the prediction tables, in place.  ``nb_rows`` [M, G]: the block-list row
    model m serves at slot g (≥ Tp ⇒ none).  ``failed`` [1] int32 counts
    failed factorisations."""
    if pts.device.type == "cpu":
        gp_heavy_plain(pts, lab, starts, counts, nb_rows, centers, all_nodes,
                       acc_mean, acc_var, present, failed, cmax=cmax, sf2=sf2,
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
    M, G = nb_rows.shape
    Tp, Vall = centers.shape[0], all_nodes.shape[0]
    if (pts.shape[1:] != (3,) or centers.shape[1:] != (3,)
            or all_nodes.shape[1:] != (3,) or lab.shape[0] != pts.shape[0]
            or starts.shape[0] != M or counts.shape[0] != M
            or acc_mean.shape != (Tp * G, Vall) or acc_var.shape != (Tp * G, Vall)
            or present.shape != (Tp * G,) or failed.numel() != 1):
        raise ValueError("gp_heavy: inconsistent shapes")
    cmax = int(cmax)
    if cmax <= 0:
        raise ValueError(f"gp_heavy: cmax={cmax}")
    if M == 0:
        return
    if cmax <= SHARED_MAX_C:
        threads, grid, ws = _THREADS_SHARED, M, None
    else:
        threads = _THREADS_GLOBAL
        per_cta = cmax * cmax + cmax * threads
        grid = min(M, max(1, _WS_FLOATS // per_cta))
        ws = torch.empty(grid * per_cta, dtype=torch.float32, device=pts.device)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    code = _build.lib().la3dm_gp_heavy(
        pts.data_ptr(), lab.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        nb_rows.data_ptr(), centers.data_ptr(), all_nodes.data_ptr(),
        None if ws is None else ws.data_ptr(), acc_mean.data_ptr(),
        acc_var.data_ptr(), present.data_ptr(), failed.data_ptr(), M, Tp, G, Vall,
        cmax, grid, threads, float(np.float32(1.73205 / float(ell))), float(np.float32(sf2)),
        float(np.float32(noise)), stream)
    _build.check(code, "gp_heavy")
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
