#!/usr/bin/env python3
"""Where the GP heavy pass (K4, la3dm_tpu_torch/csrc/gp_heavy.cu) loses
accuracy on large models: a CPU study in PyTorch, no card needed.

One seeded Matérn-3/2 GP (ℓ 1, sf2 1, noise 0.01) on ``--points`` training
points uniform in a 3.2 m cube (a block_depth-5 block at resolution 0.2),
predicted at ``--queries`` points, is computed in f64 (the truth) and in f32
five ways: LAPACK's (torch.linalg, the plain version's path), and K4's own
algorithm — a right-looking f32 factor, then the two solves and each
query's forward substitution, mean and Σv² summed term by term in K4's
order — with those sums in f32 (K4's base tier) or in f64 (K4's overflow
tier).  Each line prints the largest |Δ|/(1+|f64|) of the means and the
variances.

    python3 tools/k4_sum_precision.py --points 1200 --queries 3000
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=1200)
    ap.add_argument("--queries", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    c, Q = args.points, args.queries
    s, sf2, noise = float(np.float32(1.73205 / 1.0)), 1.0, 0.01
    pts = rng.uniform(0, 3.2, (c, 3)).astype(np.float32)
    q = rng.uniform(0, 3.2, (Q, 3)).astype(np.float32)
    y = np.where(rng.uniform(size=c) < 0.5, 1.0, -1.0).astype(np.float32)

    f64 = torch.float64
    L64 = torch.linalg.cholesky(matern(pts, pts, f64, s, sf2) + noise * torch.eye(c, dtype=f64))
    Ks64 = matern(pts, q, f64, s, sf2)
    a64 = torch.cholesky_solve(torch.as_tensor(y, dtype=f64)[:, None], L64)[:, 0]
    mean64 = Ks64.T @ a64
    v64 = torch.linalg.solve_triangular(L64, Ks64, upper=False)
    var64 = sf2 - (v64 * v64).sum(0)

    def err(name, mean, var):
        em = ((mean.double() - mean64).abs() / (1 + mean64.abs())).max().item()
        ev = ((var.double() - var64).abs() / (1 + var64.abs())).max().item()
        print(f"{name:<44} means {em:.3e}   variances {ev:.3e}")

    K = matern(pts, pts, torch.float32, s, sf2) + noise * torch.eye(c)
    Ks = matern(pts, q, torch.float32, s, sf2)
    print(f"{c} points, {Q} queries; smallest f64 variance {var64.min().item():.3e}")
    L = torch.linalg.cholesky(K)
    z = torch.linalg.solve_triangular(L, torch.as_tensor(y)[:, None], upper=False)
    a = torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]
    v = torch.linalg.solve_triangular(L, Ks, upper=False)
    err("LAPACK f32 (the plain version's path)", Ks.T @ a, sf2 - (v * v).sum(0))
    Lk = right_looking_factor(K)
    a32 = k4_solves(Lk, y, torch.float32)
    err("K4 order, sums in f32 (base tier)", *k4_predict(Lk, a32, Ks, sf2, torch.float32))
    err("K4 order, f32 solves, f64 query sums", *k4_predict(Lk, a32, Ks, sf2, f64))
    a64k = k4_solves(Lk, y, f64)
    err("K4 order, sums in f64 (overflow tier)", *k4_predict(Lk, a64k, Ks, sf2, f64))
    err("LAPACK f32 factor, K4 f32 sums", *k4_predict(L, a, Ks, sf2, torch.float32))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
