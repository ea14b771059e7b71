"""The port's out-of-core engine against graph_tpu's, with the same slabs.

``graph_tpu``'s ``OocEdgeEngine`` runs its Pallas kernels in interpret
mode; the port's runs the kernels' plain versions on the CPU.  Both cut
the same slab bounds for the same ``n_slabs``.  ``spmv``, ``relax`` and
``smin_int`` must match bit for bit, and each also equals the port's
resident EdgeEngine on the same edges.  The drivers must give equal
results: labels and distances equal; PageRank, whose update the port
rounds as its in-core path does, equal to the port's ``page_rank`` bit
for bit and to graph_tpu's driver within 1e-6.  Graphs have just over one or two MID (65,536)
blocks of nodes, so that they split into several slabs.
"""

import numpy as np
import pytest
import torch

import graph_tpu_torch as gtt
from graph_tpu.engine import ooc as jooc
from graph_tpu_torch.engine import EdgeEngine, EdgePlan, OocEdgeEngine
from graph_tpu_torch.engine import ooc
from graph_tpu_torch.engine.kernels import INF
from graph_tpu_torch.engine.plan import build_plan

MID = 65536


def _graph(n=140_000, m=160_000, seed=5, weighted=False):
    r = np.random.default_rng(seed)
    src = r.integers(0, n, m).astype(np.int64)
    dst = r.integers(0, n, m).astype(np.int64)
    dst[: m // 8] = r.integers(0, 300, m // 8)  # a few hot destinations
    w = (r.random(m) * 4).astype(np.float32) if weighted else None
    return src, dst, w, n


@pytest.fixture(scope="module")
def weighted_pair():
    """One weighted graph as both packages' out-of-core engines (3 slabs)
    and the port's resident engine."""
    src, dst, w, n = _graph(weighted=True)
    mine = OocEdgeEngine.build(src, dst, n, values=w, n_slabs=3,
                               device="cpu")
    theirs = jooc.OocEdgeEngine.build(src, dst, n, values=w, n_slabs=3,
                                      interpret=True)
    resident = EdgeEngine.build(src, dst, n, values=w, device="cpu")
    return mine, theirs, resident, n


def test_slab_bounds_equal_graph_tpu(weighted_pair):
    mine, theirs, _, n = weighted_pair
    assert len(mine.slabs) == len(theirs.slabs) == 3
    assert [(s.d0, s.rows) for s in mine.slabs] == \
        [(s.d0, s.rows) for s in theirs.slabs]
    for sl in mine.slabs:
        assert sl.plan.n == sl.rows and sl.plan.n_src == n
        assert sl.plan.perm is None and sl.d0 % MID == 0
    assert sum(s.plan.m for s in mine.slabs) == mine.m
    assert mine.bytes_per_call == sum(
        ooc.plan_bytes(s.plan.m, s.rows, True) for s in mine.slabs)


def test_spmv_relax_smin_int_bit_exact(weighted_pair):
    mine, theirs, resident, n = weighted_pair
    r = np.random.default_rng(1)
    x = (r.random(n) * 1e-5).astype(np.float32)
    y = mine.spmv(x)
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    np.testing.assert_array_equal(y.numpy(), theirs.spmv(x))
    assert torch.equal(y, resident.spmv(torch.from_numpy(x)))
    # the bound contract: x scaled in, y scaled out, as graph_tpu does
    xb = (r.random(n) * 3e-5).astype(np.float32)
    np.testing.assert_array_equal(mine.spmv(xb, bound=4.0).numpy(),
                                  theirs.spmv(xb, bound=4.0))

    dist = (r.random(n) * 10).astype(np.float32)
    dist[::5] = INF
    got = mine.relax(dist)
    np.testing.assert_array_equal(got.numpy(), theirs.relax(dist))
    assert torch.equal(got, resident.relax(torch.from_numpy(dist)))
    assert (got == INF).any()  # rows without in-edges keep the fill

    labels = r.integers(-2**31, 2**31, n).astype(np.int32)
    got = mine.smin_int(labels)
    np.testing.assert_array_equal(got.numpy(), theirs.smin_int(labels))
    assert torch.equal(got, resident.smin_int(torch.from_numpy(labels)))


def test_vector_checks_and_unweighted_relax(weighted_pair):
    mine, _, _, n = weighted_pair
    with pytest.raises(ValueError, match="x must be"):
        mine.spmv(np.zeros(n - 1, np.float32))
    with pytest.raises(ValueError, match="x must be"):
        mine.smin_int(np.zeros(n, np.float32))
    src, dst, _, n = _graph(n=70_000, m=20_000, seed=2)
    plain = OocEdgeEngine.build(src, dst, n, n_slabs=2, device="cpu")
    with pytest.raises(ValueError, match="values"):
        plain.relax(np.zeros(n, np.float32))


def test_max_bytes_budget_partitions():
    src, dst, _, n = _graph(n=140_000, m=400_000, seed=9)
    # 400k slots * 4 B + 140k rows * 8 B ~ 2.8 MB; a 1 MB budget splits
    eng = OocEdgeEngine.build(src, dst, n, max_bytes=1 << 20, device="cpu")
    assert len(eng.slabs) >= 2
    covered = [(s.d0, s.d0 + s.rows) for s in eng.slabs]
    assert covered[0][0] == 0 and covered[-1][1] == n
    for (a0, a1), (b0, b1) in zip(covered, covered[1:]):
        assert a1 == b0 and b0 % MID == 0
    one = OocEdgeEngine.build(src, dst, n, device="cpu")
    assert len(one.slabs) == 1  # the default budget holds it whole


def test_page_rank_ooc_equals_page_rank_and_graph_tpu():
    """The driver runs the in-core page_rank's arithmetic: its scores equal
    the port's page_rank bit for bit.  graph_tpu's driver rounds the
    update twice, in numpy: within 1e-6 of it, same iterations."""
    src, dst, _, n = _graph(n=70_000, m=120_000, seed=13)
    scores, it, err = ooc.page_rank_ooc(src, dst, n, max_iterations=5,
                                        tolerance=0.0, n_slabs=2,
                                        device="cpu")
    g = gtt.build_directed(src, dst, node_count=n, device="cpu")
    core = gtt.page_rank(g, gtt.PageRankConfig(max_iterations=5,
                                               tolerance=0.0))
    assert it == core.ran_iterations == 5 and err == core.error
    assert torch.equal(scores, core.scores)
    want, wit, werr = jooc.page_rank_ooc(src, dst, n, max_iterations=5,
                                         tolerance=0.0, n_slabs=2,
                                         interpret=True)
    assert it == wit
    # per node: graph_tpu's page_rank_ooc rounds twice (1.85e-7 relative)
    np.testing.assert_allclose(scores.numpy(), want, rtol=1e-6, atol=0)
    assert err == pytest.approx(werr, rel=1e-4)
    stop = ooc.page_rank_ooc(src, dst, n, max_iterations=50,
                             tolerance=1e-3, n_slabs=2, device="cpu")
    assert stop[1] < 50 and stop[2] < 1e-3


def test_wcc_ooc_equals_graph_tpu():
    """Disjoint rings with random chords inside each."""
    r = np.random.default_rng(17)
    n, parts = 72_000, 4
    size = n // parts
    src_l, dst_l = [], []
    for p in range(parts):
        ids = np.arange(p * size, (p + 1) * size)
        src_l += [ids, ids[: size // 4]]
        dst_l += [np.roll(ids, 1), p * size + r.integers(0, size, size // 4)]
    src = np.concatenate(src_l).astype(np.int64)
    dst = np.concatenate(dst_l).astype(np.int64)
    comp = ooc.wcc_ooc(src, dst, n, n_slabs=2, device="cpu")
    assert comp.dtype == torch.int32
    np.testing.assert_array_equal(comp.numpy(), (np.arange(n) // size) * size)
    np.testing.assert_array_equal(
        comp.numpy(), jooc.wcc_ooc(src, dst, n, n_slabs=2, interpret=True))


def test_sssp_ooc_equals_graph_tpu():
    """A sparse graph (about 0.8 out-edges per node), so that the rounds
    are few, from its node of largest out-degree."""
    src, dst, w, n = _graph(n=70_000, m=56_000, seed=23, weighted=True)
    start = int(np.bincount(src).argmax())
    dist = ooc.sssp_ooc(src, dst, w, n, start_node=start, n_slabs=2,
                        device="cpu")
    want = jooc.sssp_ooc(src, dst, w, n, start_node=start, n_slabs=2,
                         interpret=True)
    np.testing.assert_array_equal(dist.numpy(), want)
    assert dist[start] == 0.0 and 10 < int((dist < INF).sum()) < n


def test_rectangular_plan():
    """n destination rows gathering from n_src sources: K1's window is 0,
    the x check uses n_src, relabel is refused, and sources and
    destinations are checked against their own ranges."""
    src = np.array([0, 5, 9, 9, 3])
    dst = np.array([0, 1, 1, 2, 0])
    plan = build_plan(src, dst, 3, n_src=10, device="cpu")
    assert (plan.n, plan.nx, plan.n_src) == (3, 10, 10)
    eng = EdgeEngine(plan)
    assert eng.window == 0
    x = torch.arange(10, dtype=torch.int32)
    assert eng.smin_int(x).tolist() == [0, 5, 9]
    with pytest.raises(ValueError, match="x must be \\(10,\\)"):
        eng.smin_int(torch.arange(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="exclusive"):
        build_plan(src, dst, 3, n_src=10, relabel="degree", device="cpu")
    with pytest.raises(ValueError, match="endpoints"):
        build_plan(src, dst, 3, n_src=9, device="cpu")
    with pytest.raises(ValueError, match="endpoints"):
        build_plan(src, dst, 2, n_src=10, device="cpu")


def test_rectangular_snapshot_and_format_2(tmp_path):
    plan = build_plan([0, 5, 9], [0, 1, 1], 3, n_src=10, device="cpu")
    path = str(tmp_path / "rect.npz")
    plan.save(path)
    back = EdgePlan.load(path, device="cpu")
    assert back.n_src == 10
    for f in ("indptr", "slot_src"):
        assert torch.equal(getattr(back, f), getattr(plan, f))
    square = build_plan([0, 1, 2], [1, 2, 0], 3, device="cpu")
    np.savez(path, __header__=np.array([3, 3, 2, 0], np.int64),
             indptr=square.indptr.numpy(), slot_src=square.slot_src.numpy(),
             perm=np.zeros(0, np.int32), slot_w=np.zeros(0, np.float32))
    old = EdgePlan.load(path, device="cpu")
    assert old.n_src == 0 and old.nx == 3
    assert torch.equal(old.slot_src, square.slot_src)


@pytest.mark.requires_cuda
def test_ooc_on_card_equals_resident():
    """On a card: pinned slabs, a copy stream and two buffers give the
    resident engine's bits for every op."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src, dst, w, n = _graph(n=200_000, m=600_000, seed=3, weighted=True)
    eng = OocEdgeEngine.build(src, dst, n, values=w, n_slabs=3,
                              device="cuda")
    assert eng.slabs[0].plan.slot_src.is_pinned()
    resident = EdgeEngine.build(src, dst, n, values=w, device="cuda")
    r = np.random.default_rng(4)
    x = torch.from_numpy((r.random(n) * 1e-5).astype(np.float32))
    assert torch.equal(eng.spmv(x), resident.spmv(x.cuda()).cpu())
    assert torch.equal(eng.relax(x * 1e6), resident.relax(x.cuda() * 1e6)
                       .cpu())
    labels = torch.from_numpy(r.integers(0, n, n).astype(np.int32))
    assert torch.equal(eng.smin_int(labels),
                       resident.smin_int(labels.cuda()).cpu())
