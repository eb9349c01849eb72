"""Seeded inputs for the port's kernel tests (numpy and torch only, so the
card-side tests can use them on a machine without JAX)."""

import numpy as np
import pytest
import torch

from la3dm_tpu_torch.geometry import blocks as geo


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run PyTorch on one CPU thread for the test (autouse where imported):
    on several threads the first elementwise pass of a worker process was
    seen to return one thread's share perturbed by about 3e-4, enough to
    move the 1e-4 comparisons; on one thread every result is reproducible."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def heavy_inputs(seed, G=7, n_blocks=5, ell=0.2, dev="cpu"):
    """A small dispatch: entries round each test block, ragged rows of ≤ 64
    merged entries per block, row_block non-decreasing."""
    rng = np.random.default_rng(seed)
    nodes, _ = geo.all_level_nodes(0.1, 3)
    centers = rng.uniform(-1, 1, (n_blocks, 3)).astype(np.float32)
    per_block = rng.integers(0, 150, n_blocks)
    ent, lab, ids, gs, rb, rs, rn = [], [], [], [], [], [], []
    for b, cnt in enumerate(per_block):
        base = sum(len(e) for e in ent)
        ent.append(centers[b] + rng.uniform(-0.4, 0.4, (cnt, 3)).astype(np.float32))
        lab.append((rng.uniform(size=cnt) > 0.5).astype(np.float32))
        start = len(ids)
        ids.extend(base + rng.permutation(cnt))
        gs.extend(rng.integers(0, G, cnt))
        for r0 in range(0, cnt, 64):
            rb.append(b)
            rs.append(start + r0)
            rn.append(min(64, cnt - r0))
    out = dict(entries=np.concatenate(ent).astype(np.float32),
               labels=np.concatenate(lab).astype(np.float32),
               ids=np.array(ids, np.int32), gslot=np.array(gs, np.int8),
               row_block=np.array(rb, np.int32), row_start=np.array(rs, np.int32),
               row_count=np.array(rn, np.int32), centers=centers, all_nodes=nodes)
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def light_inputs(seed, G=7, T=12, cap=32, dev="cpu"):
    rng = np.random.default_rng(seed)
    _, node_idx = geo.all_level_nodes(0.1, 3)
    V, Vall = node_idx.shape[1], 73
    kbar = rng.uniform(-0.1, 3.0, (T, Vall, G)).astype(np.float32)
    kbar[rng.uniform(size=kbar.shape) < 0.4] = 0.0
    ybar = kbar * (rng.uniform(size=kbar.shape) > 0.3)
    acc = np.concatenate([ybar, kbar], axis=-1).astype(np.float32)
    for t in range(T // 2):  # uniform blocks, alternately occupied and free
        acc[t] = 0.0
        acc[t, :, G] = 1.0 + t
        acc[t, :, 0] = (t % 2) * (1.0 + t)
    slots = rng.permutation(cap)[:T].astype(np.int32)
    slots[-1] = cap                      # a padding slot
    A = np.full((cap, V), 0.001, np.float32)
    B = np.full((cap, V), 0.001, np.float32)
    touched = np.zeros((cap, V), bool)
    eff = np.zeros((cap, V), np.int8)
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return t(acc), t(A), t(B), t(touched), t(eff), t(node_idx), t(slots)
