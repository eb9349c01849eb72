#!/usr/bin/env python3
"""Where the GP heavy pass (K4, la3dm_tpu_torch/csrc/gp_heavy.cu) loses
accuracy on large models: a CPU study in PyTorch, no card needed.

One seeded Matérn-3/2 GP (ℓ 1, sf2 1, noise 0.01) on ``--points`` training
points uniform in a 3.2 m cube (a block_depth-5 block at resolution 0.2),
predicted at ``--queries`` points, is computed in f64 (the truth) and in f32
several ways: LAPACK's (torch.linalg, the plain version's path); K4's
earlier column-by-column design — a right-looking f32 factor, then the two
solves and each query's forward substitution, mean and Σv² summed term by
term — with those sums in f32 (its base tier) or in f64 (its overflow
tier); and K4's blocked design — 64 × 64 tiles with every sum in f64, L
rounded to f32 tile by tile and W = L⁻¹ kept in f64 as the factor stores
them, then z = W y, V = W Ks with W rounded to f32 (the predict's copy),
mean = V·z and Σv² in f64.  Each line prints the largest |Δ|/(1+|f64|) of
the means and the variances.

    python3 tools/k4_sum_precision.py --points 1200 --queries 3000
    python3 tools/k4_sum_precision.py --dispatch-every 6

The second form replays LAPACK's path, the column design with f64 sums
and the blocked design on real models instead (about 10 minutes): every sixth of the 387 models (largest first)
of the overflow tier of chip_smoke.py's 12-scan GP dispatch at block_depth
5, built on the CPU from its seeded scenes, each predicted at every node of
the blocks it serves.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def matern(a, b, dtype, s, sf2):
    a = torch.as_tensor(a, dtype=dtype) * s
    b = torch.as_tensor(b, dtype=dtype) * s
    d = torch.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    return (1 + d) * torch.exp(-d) * sf2


def right_looking_factor(K):
    """K4's factor: column by column, every trailing entry updated in f32."""
    A = K.clone()
    c = A.shape[0]
    for k in range(c):
        A[k, k] = torch.sqrt(A[k, k])
        A[k + 1:, k] = A[k + 1:, k] / A[k, k]
        A[k + 1:, k + 1:] -= torch.tril(A[k + 1:, k:k + 1] * A[None, k + 1:, k])
    return torch.tril(A)


def k4_solves(L, y, acc):
    """L z = y, then Lᵀ α = z, in place, each entry summed in ``acc``."""
    L = L.to(acc)
    a = torch.as_tensor(y, dtype=acc).clone()
    c = L.shape[0]
    for k in range(c):
        a[k] = a[k] / L[k, k]
        a[k + 1:] -= L[k + 1:, k] * a[k]
    for k in range(c - 1, -1, -1):
        a[k] = a[k] / L[k, k]
        a[:k] -= L[k, :k] * a[k]
    return a


def k4_predict(L, alpha, Ks, sf2, acc):
    """Each query's substitution r, mean and Σv² summed in ``acc`` in K4's
    order; v stored in f32, as K4 stores it."""
    c = L.shape[0]
    L = L.to(acc)
    R = Ks.to(acc).clone()
    V = torch.empty_like(R)
    for i in range(c):
        V[i] = (R[i] / L[i, i]).float().to(acc)
        R[i + 1:] -= L[i + 1:, i:i + 1] * V[i][None, :]
    mu = torch.zeros(Ks.shape[1], dtype=acc)
    ss = torch.zeros(Ks.shape[1], dtype=acc)
    for i in range(c):
        mu += Ks[i].to(acc) * alpha.to(acc)[i]
        ss += V[i] * V[i]
    return mu.float(), (sf2 - ss).float()


def blocked_factor(K, y, b=64, w_f32=False):
    """K4's blocked factor: the model padded to cp = b·tiles with
    identity rows; step k factors the diagonal tile K_kk − Σ L_kl L_klᵀ in
    f64 and rounds it to f32, W_kk = L_kk⁻¹ in f64, then L_ik = (K_ik −
    Σ L_il L_klᵀ) W_kkᵀ rounded to f32; then W_ij = −W_ii Σ_k L_ik W_kj row
    tile by row tile in f64, and z = W y.  Returns W [cp, cp] and z, f64.
    ``w_f32`` rounds each W tile to f32 as it is made, as the blocked
    design first did on the card."""
    f64 = torch.float64
    c = K.shape[0]
    nt = -(-c // b)
    cp = nt * b
    A = torch.eye(cp, dtype=f64)
    A[:c, :c] = K.double()
    L = torch.zeros(cp, cp, dtype=f64)
    W = torch.zeros(cp, cp, dtype=f64)
    keep = (lambda x: x.float().double()) if w_f32 else (lambda x: x)
    for k in range(nt):
        sk = slice(k * b, (k + 1) * b)
        R = A[sk, sk] - L[sk, :k * b] @ L[sk, :k * b].T
        W[sk, sk] = keep(torch.tril(torch.linalg.inv(torch.linalg.cholesky(R).float().double())))
        for i in range(k + 1, nt):
            si = slice(i * b, (i + 1) * b)
            R = A[si, sk] - L[si, :k * b] @ L[sk, :k * b].T
            L[si, sk] = (R @ W[sk, sk].T).float().double()
    for i in range(1, nt):
        si = slice(i * b, (i + 1) * b)
        for j in range(i):
            sj = slice(j * b, (j + 1) * b)
            W[si, sj] = keep(-W[si, si] @ (L[si, j * b:i * b] @ W[j * b:i * b, sj]))
    yp = torch.zeros(cp, dtype=f64)
    yp[:c] = torch.as_tensor(y, dtype=f64)
    return W, W @ yp


def blocked_predict(W, z, Ks, sf2):
    """K4's blocked predict: V = W Ks with W rounded to f32, as the predict
    reads it, then mean = V·z and Σv² in f64."""
    Kp = torch.zeros(W.shape[0], Ks.shape[1], dtype=torch.float64)
    Kp[:Ks.shape[0]] = Ks.double()
    V = W.float().double() @ Kp
    return (V * z[:, None]).sum(0).float(), (sf2 - (V * V).sum(0)).float()


def errors(pts, y, q, sf2=1.0, noise=0.01, ell=1.0, column_f32=True):
    """Largest |Δ|/(1+|f64|) of the means and the variances of each f32
    path against f64, for one model's training points, labels and queries
    (the column design's f32 paths only with ``column_f32``: their
    term-by-term loops are slow)."""
    f64 = torch.float64
    s = float(np.float32(1.73205 / ell))
    c = len(pts)
    L64 = torch.linalg.cholesky(matern(pts, pts, f64, s, sf2) + noise * torch.eye(c, dtype=f64))
    Ks64 = matern(pts, q, f64, s, sf2)
    a64 = torch.cholesky_solve(torch.as_tensor(y, dtype=f64)[:, None], L64)[:, 0]
    mean64 = Ks64.T @ a64
    v64 = torch.linalg.solve_triangular(L64, Ks64, upper=False)
    var64 = sf2 - (v64 * v64).sum(0)

    def err(mean, var):
        return (((mean.double() - mean64).abs() / (1 + mean64.abs())).max().item(),
                ((var.double() - var64).abs() / (1 + var64.abs())).max().item())

    K = matern(pts, pts, torch.float32, s, sf2) + noise * torch.eye(c)
    Ks = matern(pts, q, torch.float32, s, sf2)
    out = {}
    L = torch.linalg.cholesky(K)
    z = torch.linalg.solve_triangular(L, torch.as_tensor(y)[:, None], upper=False)
    a = torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]
    v = torch.linalg.solve_triangular(L, Ks, upper=False)
    out["LAPACK f32 (the plain version's path)"] = err(Ks.T @ a, sf2 - (v * v).sum(0))
    Lk = right_looking_factor(K)
    if column_f32:
        a32 = k4_solves(Lk, y, torch.float32)
        out["column order, sums in f32 (base tier)"] = err(
            *k4_predict(Lk, a32, Ks, sf2, torch.float32))
        out["column order, f32 solves, f64 query sums"] = err(
            *k4_predict(Lk, a32, Ks, sf2, f64))
    out["column order, sums in f64 (overflow tier)"] = err(
        *k4_predict(Lk, k4_solves(Lk, y, f64), Ks, sf2, f64))
    if column_f32:
        out["LAPACK f32 factor, column-order f32 sums"] = err(
            *k4_predict(L, a, Ks, sf2, torch.float32))
    out["blocked, W tiles kept in f32"] = err(
        *blocked_predict(*blocked_factor(K, y, w_f32=True), Ks, sf2))
    out["blocked, W in f64, f32 copy in V (K4)"] = err(
        *blocked_predict(*blocked_factor(K, y), Ks, sf2))
    return out


def dispatch_models(every: int):
    """Every ``every``-th model (by size) of the overflow tier of
    chip_smoke.py's 12-scan GP dispatch at block_depth 5, built on the CPU:
    (points, labels, queries at the all-level nodes of every block it
    serves)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from la3dm_tpu_torch.models import gp as gp_model
    from la3dm_tpu_torch.models.gp import GPOctoMap
    from la3dm_tpu_torch.utils.config import load_method_config

    scans = cs.synthetic_scans(12)
    cfg = load_method_config("gpoctomap_large_map", block_depth=5, max_range=cs.MAX_RANGE,
                             device_ingest="off")
    m = GPOctoMap(cfg, device="cpu")
    m._capture_step_args = True
    step, gp_model._gp_seq_step = gp_model._gp_seq_step, lambda *a, **k: None
    try:
        m.insert_pointclouds([c for c, _ in scans], [o for _, o in scans],
                             ds_resolution=cfg.resolution,
                             free_resolution=cfg.free_resolution, max_range=cfg.max_range)
    finally:
        gp_model._gp_seq_step = step
    a = m._last_step_call[0]
    nodes, pts, lab, centers = a[4].numpy(), a[6].numpy(), a[7].numpy(), a[10].numpy()
    st, _, nb, hc = a[8][-1]
    st, nb = st.numpy(), nb.numpy()
    for i in np.argsort(-hc, kind="stable")[::every]:
        s0, c = int(st[i]), int(hc[i])
        q = np.concatenate([nodes + centers[r] for r in nb[i] if 0 <= r < len(centers)])
        yield pts[s0:s0 + c], lab[s0:s0 + c], q.astype(np.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=1200)
    ap.add_argument("--queries", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dispatch-every", type=int, default=0,
                    help="instead, every N-th model of chip_smoke.py's block_depth-5 "
                         "dispatch (its overflow tier, largest first)")
    args = ap.parse_args()
    if args.dispatch_every:
        worst, n = {}, 0
        for pts, y, q in dispatch_models(args.dispatch_every):
            for name, e in errors(pts, y, q, column_f32=False).items():
                w = worst.get(name, (0.0, 0.0))
                worst[name] = (max(w[0], e[0]), max(w[1], e[1]))
            n += 1
        print(f"{n} models of the block_depth-5 dispatch's overflow tier, every "
              f"{args.dispatch_every}-th by size; the largest over them:")
    else:
        rng = np.random.default_rng(args.seed)
        c, Q = args.points, args.queries
        pts = rng.uniform(0, 3.2, (c, 3)).astype(np.float32)
        q = rng.uniform(0, 3.2, (Q, 3)).astype(np.float32)
        y = np.where(rng.uniform(size=c) < 0.5, 1.0, -1.0).astype(np.float32)
        print(f"{c} points, {Q} queries")
        worst = errors(pts, y, q)
    for name, (em, ev) in worst.items():
        print(f"{name:<44} means {em:.3e}   variances {ev:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
