"""What surrounds the redesigned K1 and K2, on the CPU, with no card.

* K2's tile cut points (``k2_tile_cuts``): every row end and every slot
  lies in exactly one tile, and tiles differ by at most one item.
* A Python model of ``csrc/k2_reduce.cu``'s merge-path kernel, step for
  step (tiles, each thread's search and serial run, the block scan, the
  carries), agrees with the plain version on every row; so the way the
  kernel splits the work is right before the card runs it.
* The engine gives K1 a nonzero window only on a degree-relabeled plan,
  and K2 the cuts it computed once for its plan.

The row-length cases are shared with the card tests in
``test_torch_kernels.py``.  The file imports neither JAX nor graph_tpu.
"""

import numpy as np
import pytest
import torch

from graph_tpu_torch.engine import EdgeEngine
from graph_tpu_torch.engine import engine as engine_mod
from graph_tpu_torch.engine.kernels import (
    IMAX, INF_BITS, K1_WINDOW, K1_WINDOW_MAX, K2_TILE, k1_gather,
    k1_gather_plain, k1_gather_weighted, k2_num_tiles, k2_reduce,
    k2_reduce_min, k2_reduce_min_plain, k2_reduce_plain, k2_tile_cuts)
from graph_tpu_torch.engine.plan import build_plan
from graph_tpu_torch.generate import host_rmat

#: ``kThreads`` and ``kItems`` of csrc/k2_reduce.cu
K_THREADS, K_ITEMS = 128, 15
assert K_THREADS * K_ITEMS == K2_TILE


def _rmat_counts(scale):
    plan = build_plan(*host_rmat(scale, seed=5), 1 << scale,
                      relabel="degree", device="cpu")
    return np.diff(plan.indptr.numpy())


#: Row lengths, by name: each a shape the merge path must get right.
TILE_CASES = {
    # row 0 ends on the last item of tile 0, row 1 on the first of tile 2
    # (n + m = 3 tiles exactly)
    "tile_boundary": lambda: np.array([K2_TILE - 1, K2_TILE, 1000, 0,
                                       K2_TILE - 1004]),
    # a row over 4 tiles, every other row empty
    "spanning_hub": lambda: np.array([0] * 50 + [3 * K2_TILE + 100]
                                     + [0] * 50),
    "n1": lambda: np.array([5000]),
    "n1_empty": lambda: np.array([0]),
    "small_m": lambda: np.random.default_rng(2).integers(0, 8, 30),
    "hub_and_empties": lambda: np.concatenate([
        np.random.default_rng(3).integers(0, 12, 400) * (np.arange(400) % 3 > 0),
        [20_000], np.zeros(60, np.int64)]),
    "rmat10": lambda: _rmat_counts(10),
}


def indptr_of(counts) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _values(m, op, seed=0):
    """Slot values: full-range int32 (sums wrap, imin sees negatives), or
    nonnegative f32 bit patterns for min."""
    v = np.random.default_rng(seed).integers(-2**31, 2**31, m).astype(np.int32)
    return v & np.int32(0x7FFFFFFF) if op == "min" else v


def _tile_bounds(cuts, n, m):
    ntiles = cuts.size - 1
    diag = np.arange(ntiles + 1, dtype=np.int64) * (n + m) // ntiles
    return diag, diag - cuts  # each tile's first item and first slot


@pytest.mark.parametrize("case", ["rmat12", "hub_300001", "tile_boundary",
                                  "spanning_hub", "n1", "n1_empty",
                                  "small_m"])
def test_cuts_cover_each_row_end_and_slot_once(case):
    if case == "rmat12":
        counts = _rmat_counts(12)
    elif case == "hub_300001":  # chip_smoke's edge-case rows
        counts = np.random.default_rng(13).integers(0, 40, 3001)
        counts[::5] = 0
        counts[17] = 300_001
    else:
        counts = TILE_CASES[case]()
    indptr = indptr_of(counts)
    n, m = counts.size, int(indptr[-1])
    cuts = k2_tile_cuts(torch.from_numpy(indptr), m)
    assert cuts.dtype == torch.int64
    cuts = cuts.numpy()
    ntiles = k2_num_tiles(n, m)
    assert cuts.size == ntiles + 1
    diag, slot = _tile_bounds(cuts, n, m)
    assert cuts[0] == 0 and cuts[-1] == n and (np.diff(cuts) >= 0).all()
    assert slot[0] == 0 and slot[-1] == m and (np.diff(slot) >= 0).all()
    # balanced: every tile holds floor or ceil of (n + m) / T items
    items = np.diff(diag)
    assert items.max() - items.min() <= 1 and items.max() <= K2_TILE
    # each row end lies in the one tile whose rows hold it
    rows = np.arange(n)
    pos = indptr[1:] + rows
    t = np.searchsorted(cuts, rows, side="right") - 1
    assert ((diag[t] <= pos) & (pos < diag[t + 1])).all()
    # each slot lies in the one tile whose slots hold it
    k = np.arange(m)
    pos = k + np.searchsorted(indptr[1:], k, side="right")
    t = np.searchsorted(slot, k, side="right") - 1
    assert ((diag[t] <= pos) & (pos < diag[t + 1])).all()
    # the tile counts add up
    assert np.bincount(t, minlength=ntiles).sum() == m
    if case == "tile_boundary":  # the case is what its name says
        assert ntiles == 3 and n + m == 3 * K2_TILE
        assert indptr[1] + 0 == K2_TILE - 1 and indptr[2] + 1 == 2 * K2_TILE


def _merge_path_model(contrib, indptr, cuts, op):
    """csrc/k2_reduce.cu's two passes, step for step, in Python."""
    n, m = indptr.size - 1, contrib.size
    total, ntiles = n + m, cuts.size - 1
    if op == "sum":
        ident, f = 0, (lambda a, b: (a + b) & 0xFFFFFFFF)
        vals = (contrib.astype(np.int64) & 0xFFFFFFFF).tolist()
    else:
        ident, f = (IMAX if op == "imin" else INF_BITS), min
        vals = contrib.tolist()
    y = [None] * n

    def store(row, v):
        assert y[row] is None, f"row {row} stored twice"
        y[row] = v

    carries = []
    for t in range(ntiles):
        d0, d1 = t * total // ntiles, (t + 1) * total // ntiles
        row0, row1 = int(cuts[t]), int(cuts[t + 1])
        slot0 = d0 - row0
        nrows, nslots, items = row1 - row0, d1 - row1 - slot0, d1 - d0
        assert 0 <= items <= K_THREADS * K_ITEMS
        s_val = vals[slot0:slot0 + nslots]
        s_end = (indptr[row0 + 1:row1 + 1] - slot0).tolist()
        threads = []
        for tid in range(K_THREADS):
            dt = min(tid * K_ITEMS, items)
            dn = min(dt + K_ITEMS, items)
            lo, hi = max(0, dt - nslots), min(dt, nrows)
            while lo < hi:
                mid = (lo + hi) // 2
                if s_end[mid] + mid < dt:
                    lo = mid + 1
                else:
                    hi = mid
            i, j = lo, dt - lo
            acc, first, first_row = ident, ident, -1
            for _ in range(dt, dn):
                if j < (s_end[i] if i < nrows else 2**62):
                    acc = f(acc, s_val[j])
                    j += 1
                else:
                    if first_row < 0:
                        first, first_row = acc, i
                    else:
                        store(row0 + i, acc)
                    acc = ident
                    i += 1
            threads.append((first_row, first, acc))
        scanned = ident  # the segmented scan, one thread after another
        for first_row, first, acc in threads:
            if first_row >= 0:
                store(row0 + first_row, f(scanned, first))
                scanned = acc
            else:
                scanned = f(scanned, acc)
        carries.append(scanned)
    for t, v in enumerate(carries):  # the carry pass
        row = int(cuts[t + 1])
        if row < n and v != ident:
            y[row] = f(y[row], v)
    assert None not in y
    out = np.array(y, dtype=np.int64)
    return (out.astype(np.uint32).view(np.int32) if op == "sum"
            else out.astype(np.int32))


@pytest.mark.parametrize("op", ["sum", "imin", "min"])
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_merge_path_model_equals_plain(case, op):
    indptr = indptr_of(TILE_CASES[case]())
    contrib = _values(int(indptr[-1]), op)
    cuts = k2_tile_cuts(torch.from_numpy(indptr), contrib.size).numpy()
    got = _merge_path_model(contrib, indptr, cuts, op)
    c, ip = torch.from_numpy(contrib), torch.from_numpy(indptr)
    want = (k2_reduce_plain(c, ip) if op == "sum"
            else k2_reduce_min_plain(c, ip, op))
    np.testing.assert_array_equal(got, want.numpy())


def _engines():
    g = np.random.default_rng(8)
    n, m = 3000, 40000
    src = (g.zipf(1.3, m) % n).astype(np.int64)
    dst = g.integers(0, n, m)
    w = (g.random(m) * 1e-3).astype(np.float32)
    return {relabel: EdgeEngine.build(src, dst, n, values=w, relabel=relabel,
                                      device="cpu")
            for relabel in (None, "degree")}


def test_engine_window_only_on_relabeled_plans(monkeypatch):
    """Every K1 call of the engine gets K1_WINDOW on a relabeled plan and
    0 on one on node ids; every K2 call gets the engine's cuts."""
    seen = []

    def spy(fn, kind):
        def call(*args, **kwargs):
            seen.append((kind, args, kwargs))
            return fn(*args, **kwargs)
        return call

    for name in ("k1_gather", "k1_gather_weighted", "k2_reduce",
                 "k2_reduce_min"):
        monkeypatch.setattr(engine_mod, name,
                            spy(getattr(engine_mod, name), name))
    for relabel, eng in _engines().items():
        want = K1_WINDOW if relabel == "degree" else 0
        assert eng.window == want
        assert torch.equal(eng.k2_cuts,
                           k2_tile_cuts(eng.plan.indptr, eng.plan.m))
        x = torch.from_numpy(
            np.random.default_rng(1).random(eng.plan.n).astype(np.float32)
            * 1e-3)
        seen.clear()
        for combine in ("none", "add", "mul"):
            for reduce in ("sum", "min"):
                eng.apply(x, combine=combine, reduce=reduce)
        eng.smin_int(torch.arange(eng.plan.n, dtype=torch.int32))
        k1 = [(k, a, kw) for k, a, kw in seen if k.startswith("k1")]
        k2 = [(k, a, kw) for k, a, kw in seen if k.startswith("k2")]
        assert len(k1) == len(k2) == 7
        for kind, args, kwargs in k1:
            h = kwargs["window"] if "window" in kwargs else args[2]
            assert h == want, (relabel, kind)
        for kind, args, kwargs in k2:
            assert args[-1] is eng.k2_cuts, (relabel, kind)


def test_window_and_cuts_leave_results_alone_on_cpu():
    g = np.random.default_rng(4)
    xq = torch.from_numpy(g.integers(-2**31, 2**31, 500).astype(np.int32))
    src = torch.from_numpy(g.integers(0, 500, 3000).astype(np.int32))
    want = k1_gather_plain(xq, src)
    for h in (0, 7, 500, K1_WINDOW, K1_WINDOW_MAX):  # above n_src: capped
        assert torch.equal(k1_gather(xq, src, h), want)
    w = torch.ones(3000)
    assert torch.equal(k1_gather_weighted(xq.float(), src, w, "mul", False,
                                          window=64), xq.float()[src.long()])
    indptr = torch.from_numpy(indptr_of(TILE_CASES["small_m"]()))
    c = torch.from_numpy(_values(int(indptr[-1]), "sum"))
    cuts = k2_tile_cuts(indptr, c.numel())
    assert torch.equal(k2_reduce(c, indptr, cuts), k2_reduce_plain(c, indptr))
    assert torch.equal(k2_reduce_min(c, indptr, "imin", cuts),
                       k2_reduce_min_plain(c, indptr, "imin"))


@pytest.mark.parametrize("window", [-1, K1_WINDOW_MAX + 1])
def test_window_out_of_range_raises(window):
    xq = torch.zeros(10, dtype=torch.int32)
    src = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="window"):
        k1_gather(xq, src, window)
    with pytest.raises(ValueError, match="window"):
        k1_gather_weighted(xq.float(), src, torch.ones(4), "add", False,
                           window=window)
