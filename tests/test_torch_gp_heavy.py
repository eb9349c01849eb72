"""K4's host-side plans (kernels/gp_heavy.py) against direct enumerations,
on the CPU: the operation count of the bound, the factor's launches and
work items, the workspace chunks and the predict's query tiling.  The kernels themselves run only on a card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest

from la3dm_tpu_torch.kernels import gp_heavy

from torch_cases import gp_heavy_inputs  # tests/ on sys.path


@pytest.mark.parametrize("depth,S", [(3, 128), (4, 512)])
def test_flops_counts_only_served_rows(depth, S):
    """The bound's operation count against a loop over models and slots:
    the predict term counts each (model, slot) that serves a test block,
    Vall query columns each; a slot that serves none adds nothing."""
    a = gp_heavy_inputs(30, depth=depth, S=S)
    counts, nb = a["counts"].numpy(), a["nb_rows"].numpy()
    Tp, Vall = a["centers"].shape[0], a["all_nodes"].shape[0]
    want, served = 0.0, []
    for c, row in zip(counts.astype(np.float64), nb):
        n = 0
        want += 12 * c ** 2 + 2 * c ** 3 / 3 + 2 * c ** 2
        for r in row:
            if 0 <= r < Tp:
                n += 1
                want += Vall * (12 * c + c ** 2 + 4 * c)
        served.append(n)
    got_served = gp_heavy.served_rows(nb, Tp)
    np.testing.assert_array_equal(got_served, served)
    assert 0 < got_served.sum() < nb.size                # some slots serve none
    assert gp_heavy.flops(counts, got_served, Vall) == pytest.approx(want, rel=1e-12)
    all_slots = gp_heavy.flops(counts, np.full(len(counts), nb.shape[1]), Vall)
    assert gp_heavy.flops(counts, got_served, Vall) < all_slots


def test_padded_size():
    c = np.array([1, 15, 16, 17, 48, 63, 64, 65, 128, 129, 300, 2096])
    np.testing.assert_array_equal(gp_heavy.padded_size(c),
                                  [16, 16, 16, 32, 48, 64, 64, 128, 128, 192, 320, 2112])


def _launches(cp):
    """The factor's launches for padded sizes ``cp``, enumerated directly:
    (phase, step, [(model, tile)])."""
    nt = [0 if c <= gp_heavy.SMALL_C else -(-c // gp_heavy.TILE) for c in cp]
    out = [(gp_heavy.SMALL, 0, [(m, 0) for m in range(len(cp)) if nt[m] == 0])]
    kmax = max(nt, default=0)
    for k in range(kmax):
        out.append((gp_heavy.DIAG, k, [(m, k) for m in range(len(nt)) if nt[m] > k]))
        out.append((gp_heavy.PANEL, k, [(m, i) for m in range(len(nt)) if nt[m] > k
                                        for i in range(k + 1, nt[m])]))
    for i in range(1, kmax):
        out.append((gp_heavy.WINV, i, [(m, j) for m in range(len(nt)) if nt[m] > i
                                       for j in range(i)]))
    out.append((gp_heavy.Z, 0, [(m, 0) for m in range(len(nt)) if nt[m]]))
    return [(p, s, items) for p, s, items in out if items]


def _covered(phase, step, first, count, items):
    """The (model, tile) pairs one launch covers, as the kernels read its
    step (kernels/gp_heavy.py::factor_items)."""
    if phase == gp_heavy.SMALL:
        return [(m, 0) for m in range(first, first + count)]
    if phase == gp_heavy.DIAG:
        return [(m, step) for m in range(count)]
    if phase == gp_heavy.PANEL:
        return [tuple(x) for x in items[first:first + count].tolist()]
    if phase == gp_heavy.WINV:
        return [(b // step, b % step) for b in range(count)]
    return [(m, 0) for m in range(count)]                     # Z: one CTA a model


@pytest.mark.parametrize("counts", [[1], [40, 20, 5], [100, 70, 64, 33, 32], [300, 160, 90],
                                    [2096, 500, 320, 320, 16],
                                    np.random.default_rng(3).integers(1, 700, 40)])
def test_factor_items_match_enumeration(counts):
    cp = gp_heavy.padded_size(np.sort(np.asarray(counts))[::-1])
    items, steps = gp_heavy.factor_items(cp)
    assert items.dtype == steps.dtype == np.int32
    want = _launches([int(x) for x in cp])
    assert [(p, s) for p, s, _ in want] == [(p, s) for p, s, _, _ in steps.tolist()]
    for (phase, step, first, count), (_, _, its) in zip(steps.tolist(), want):
        assert _covered(phase, step, first, count, items) == its
    panel = steps[steps[:, 0] == gp_heavy.PANEL]
    assert panel[:, 3].sum() == len(items)
    with pytest.raises(ValueError, match="increase"):
        gp_heavy.factor_items(cp[::-1] if len(set(cp.tolist())) > 1 else [16, 32])


def test_plan_chunks_cover_models_largest_first(monkeypatch):
    """Chunks hold every model with points once, by count descending (ties
    in tier order), each chunk's Σ cp² within the cap unless it is one
    model; models without points are left out."""
    counts = np.array([5, 0, 200, 64, 65, 200, 3, 1000, 0, 129])
    cap = 130_000
    monkeypatch.setattr(gp_heavy, "_WS_ELEMS", cap)
    chunks = gp_heavy.plan_chunks(counts)
    order = np.concatenate(chunks)
    np.testing.assert_array_equal(order, [7, 2, 5, 9, 4, 3, 0, 6])
    for ch in chunks:
        ws = int((gp_heavy.padded_size(counts[ch]) ** 2).sum())
        assert ws <= cap or len(ch) == 1
    assert [len(ch) for ch in chunks] == [1, 1, 6]
    monkeypatch.setattr(gp_heavy, "_WS_ELEMS", 1 << 29)
    assert len(gp_heavy.plan_chunks(counts)) == 1
    assert gp_heavy.plan_chunks(np.zeros(3, np.int64)) == []


@pytest.mark.parametrize("c16max,Vall", [(16, 73), (80, 73), (128, 585), (512, 585),
                                         (2096, 4681), (4000, 4681), (16, 1)])
def test_predict_tiling(c16max, Vall):
    """nq is a multiple of 16 and the tiles cover the nodes with less than
    one tile to spare; a shared Ks fits the budget, and only a model too
    large for 16 columns goes to the global workspace."""
    nq, n_tiles, shared = gp_heavy.predict_tiling(c16max, Vall)
    assert nq % 16 == 0 and nq * n_tiles >= Vall > nq * (n_tiles - 1)
    need = c16max * 4 + gp_heavy._COL_BYTES
    assert shared == (16 * need <= gp_heavy._SMEM_BYTES)
    assert nq <= (gp_heavy._NQ_MAX if shared else gp_heavy._NQ_GLOBAL)
    if shared:
        assert nq * need <= gp_heavy._SMEM_BYTES
    assert gp_heavy.predict_tiling(c16max, Vall, smem_bytes=16 * need - 1)[2] is False
