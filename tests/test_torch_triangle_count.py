"""The port's triangle count against graph_tpu's, on the same edges.

Counts are integers: equal, no tolerance.  ``graph_tpu`` pads every join
step to ``SLAB`` wedge slots (2**25), which costs seconds on the CPU per
step, so both packages' ``SLAB`` is shrunk here (the port's further, to
take many steps); the count does not depend on it.  The cases are those
of tests/test_triangle_count.py that need no fixture, then random and
RMAT graphs with both semantics
(distinct on DEDUPLICATED, the reference's multiset on SORTED), each also
held to an independent host count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_tpu_torch as gtt
from graph_tpu import global_triangle_count as jax_tc
from graph_tpu.algos import triangle_count as jtc
from graph_tpu.graph.build import build_undirected as jax_build_undirected
from graph_tpu.graph.csr import CsrLayout as JaxLayout
from graph_tpu.graph.ops import make_degree_ordered as jax_degree_ordered
from graph_tpu.native.host_csr import tc_orient_native as jax_orient
from graph_tpu_torch.algos import triangle_count as ttc
from graph_tpu_torch.generate import host_rmat
from graph_tpu_torch.native import host_csr

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def small_slab(monkeypatch):
    monkeypatch.setattr(jtc, "SLAB", 1 << 20)
    monkeypatch.setattr(ttc, "SLAB", 1 << 12)


def _counts(src, dst, n=None, layout="DEDUPLICATED", relabel=False):
    """(port count, graph_tpu count) on the same edges and layout."""
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    jg = jax_build_undirected(jnp.asarray(src.astype(np.int32)),
                              jnp.asarray(dst.astype(np.int32)),
                              node_count=n, layout=getattr(JaxLayout, layout))
    tg = gtt.build_undirected(src, dst, node_count=n, device="cpu",
                              layout=getattr(gtt.CsrLayout, layout))
    if relabel:
        jg, tg = jax_degree_ordered(jg), gtt.make_degree_ordered(tg)
    return gtt.global_triangle_count(tg).triangles, jax_tc(jg).triangles


def _edges(pairs):
    e = np.array(pairs)
    return e[:, 0], e[:, 1]


NAMED = {
    "two_components": ([(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3)], 2),
    "connected_triangles": ([(0, 1), (1, 2), (2, 0), (0, 3), (3, 4),
                             (4, 0)], 2),
    "diamond": ([(0, 1), (1, 2), (2, 0), (1, 3), (3, 2)], 2),
    "k4": ([(i, j) for i in range(4) for j in range(i + 1, 4)], 4),
    "self_loops_and_dups": ([(0, 1), (1, 2), (2, 0), (0, 0), (1, 0),
                             (0, 1)], 1),
}


@pytest.mark.parametrize("name", sorted(NAMED))
def test_named_graphs(name):
    pairs, expected = NAMED[name]
    got, want = _counts(*_edges(pairs))
    assert got == want == expected


def test_rejects_unsorted():
    g = gtt.build_undirected([0], [1], device="cpu")
    with pytest.raises(ValueError, match="SORTED or"):
        gtt.global_triangle_count(g)


def test_sorted_without_dups_equals_deduplicated():
    src, dst = _edges(NAMED["diamond"][0])
    got, want = _counts(src, dst, layout="SORTED")
    assert got == want == 2


def test_small_slab_crosses_block_boundary(monkeypatch):
    """A triangle whose ids straddle 4096, counted with join steps of 16
    wedge slots: the steps cut the rows, the count stays."""
    monkeypatch.setattr(ttc, "SLAB", 16)
    base = 4090
    src, dst = _edges([(base, base + 10), (base + 10, base + 20),
                       (base + 20, base), (base, base + 1),
                       (base + 1, base + 10)])
    got, want = _counts(src, dst, n=base + 32)
    assert got == want == 2


def _host_distinct(src, dst, n):
    """Distinct triangles as trace(A^3) / 6 on the simple graph."""
    a = np.zeros((n, n), np.int64)
    a[src, dst] = a[dst, src] = 1
    np.fill_diagonal(a, 0)
    return int(np.trace(a @ a @ a)) // 6


def _host_multiset(src, dst, n):
    """The reference's multiset count after ``make_degree_ordered``:
    sum over u, v <= u, w <= v of occ(v in N(u)) * occ(w in N(v)) *
    [w in N(u)], with the lists taken from the port's relabeled graph."""
    g = gtt.make_degree_ordered(gtt.build_undirected(
        src, dst, node_count=n, layout=gtt.CsrLayout.SORTED, device="cpu"))
    s, t = g.csr.sources.numpy(), g.csr.targets.numpy()
    occ = np.zeros((n, n), np.int64)
    np.add.at(occ, (s, t), 1)
    lower = np.tril(occ)  # occurrences of v <= u in N(u)
    member = (occ > 0).astype(np.int64)
    return int(((lower @ lower) * member).sum())


def _random(seed, n=200, m=1500):
    g = np.random.default_rng(seed)
    return g.integers(0, n, m), g.integers(0, n, m), n


def _rmat(scale, seed):
    src, dst = host_rmat(scale, seed=seed)
    return src, dst, 1 << scale


def _rmat_clique(scale=10, seed=3, k=70):
    """An RMAT graph with a k-clique on its first nodes: the clique's
    lowest-ranked node has k-1 > 64 forward neighbours, so its list
    splits into chunks whose cross pairs are outer products."""
    src, dst, n = _rmat(scale, seed)
    i, j = np.triu_indices(k, 1)
    return np.concatenate([src, i]), np.concatenate([dst, j]), n


GRAPHS = {"random7": lambda: _random(7), "random8": lambda: _random(8),
          "rmat9": lambda: _rmat(9, 5), "rmat10": lambda: _rmat(10, 3),
          "rmat10_clique": _rmat_clique}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_distinct_counts(graph):
    src, dst, n = GRAPHS[graph]()
    got, want = _counts(src, dst, n)
    assert got == want == _host_distinct(src, dst, n)


@pytest.mark.parametrize("graph", ["random7", "rmat9"])
def test_multiset_counts(graph):
    src, dst, n = GRAPHS[graph]()
    got, want = _counts(src, dst, n, layout="SORTED", relabel=True)
    assert got == want == _host_multiset(src, dst, n)


@pytest.mark.parametrize("graph", ["random8", "rmat10_clique"])
def test_joins_agree(graph):
    """The lookup join counts the wedges graph_tpu's sort join counts, one
    slab at a time and over a whole degree class; a whole count matches
    the host's."""
    src, dst, n = GRAPHS[graph]()
    g = gtt.build_undirected(src, dst, node_count=n, device="cpu",
                             layout=gtt.CsrLayout.DEDUPLICATED)
    mats, cross, a, b = ttc._prepare_distinct(g, {}, CPU)
    assert ttc._run_join(mats, cross, a, b, device=CPU) == _host_distinct(
        src, dst, n)
    v, w = ttc._emit_intra(mats[4], 4)
    ev, ew = jtc._pad_edge_keys(a.numpy(), b.numpy())
    want = int(jtc._join_count(jnp.asarray(v.numpy()), jnp.asarray(w.numpy()),
                               jnp.asarray(ev), jnp.asarray(ew)))
    assert int(ttc._lookup_count(v, w, ttc._edge_keys(a, b, CPU))) == want
    assert ttc._run_join({4: mats[4]}, None, a, b, device=CPU) == want


def test_packing_and_emission_match_graph_tpu():
    src, dst, n = _rmat_clique()
    g = gtt.build_undirected(src, dst, node_count=n, device="cpu",
                             layout=gtt.CsrLayout.DEDUPLICATED)
    mats, cross, a, b = ttc._prepare_distinct(g, {}, CPU)
    jm, jc = jtc._pack_chunks(a.numpy(), b.numpy())
    assert sorted(mats) == sorted(jm) and 64 in mats and cross is not None
    for cap in mats:
        np.testing.assert_array_equal(mats[cap].numpy(), jm[cap])
        v, w = ttc._emit_intra(mats[cap], cap)
        jv, jw = jtc._emit_intra(jnp.asarray(jm[cap]), cap)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    for mine, theirs in zip(cross, jc):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    v, w = ttc._emit_cross(*cross)
    jv, jw = jtc._emit_cross(*(jnp.asarray(m) for m in jc))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def _padded(g):
    """``g`` with a sentinel tail past ``offsets[-1]``, as a padded build
    carries."""
    tail = torch.tensor([0, 1, 2, 3, 0, 1], dtype=g.csr.sources.dtype)
    return type(g)(csr=type(g.csr)(
        offsets=g.csr.offsets,
        sources=torch.cat([g.csr.sources, tail]),
        targets=torch.cat([g.csr.targets, tail.flip(0)])),
        layout=g.layout)


PREPARED = {
    "random8": GRAPHS["random8"], "rmat10_clique": _rmat_clique,
    # a node of 199 forward neighbours: four chunk rows, six cross pairs
    "rmat10_clique200": lambda: _rmat_clique(k=200),
    "one_edge": lambda: (np.array([0]), np.array([1]), 2),
    "rmat9_padded": GRAPHS["rmat9"]}


@pytest.mark.parametrize("name", sorted(PREPARED))
def test_preparation_equals_graph_tpu_orientation_and_packing(name):
    """The preparation's tensors, bit for bit graph_tpu's native
    orientation followed by its host packing."""
    src, dst, n = PREPARED[name]()
    g = gtt.build_undirected(src, dst, node_count=n, device="cpu",
                             layout=gtt.CsrLayout.DEDUPLICATED)
    m = int(g.csr.offsets[-1])
    ja, jb = jax_orient(g.csr.sources.numpy().astype(np.int32),
                        g.csr.targets.numpy().astype(np.int32), n)
    jm, jc = jtc._pack_chunks(ja.astype(np.int64), jb)
    if name.endswith("_padded"):
        g = _padded(g)
        assert g.csr.sources.numel() > m
    phases = {}
    mats, cross, a, b = ttc._prepare_distinct(g, phases, CPU)
    assert a.dtype == torch.int64 and b.dtype == torch.int32
    np.testing.assert_array_equal(a.numpy(), ja)
    np.testing.assert_array_equal(b.numpy(), jb)
    assert list(mats) == list(jm)
    for cap in mats:
        np.testing.assert_array_equal(mats[cap].numpy(), jm[cap])
    assert (cross is None) == (jc is None)
    for mine, theirs in zip(cross or (), jc or ()):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    fdeg = np.bincount(ja)
    assert phases["forward_edges"] == ja.size
    assert phases["wedges"] == int((fdeg * (fdeg - 1) // 2).sum())
    if name == "rmat10_clique200":
        assert fdeg.max() > 2 * ttc.CLASS_CAPS[-1]
    if name == "one_edge":
        assert ja.size == 1 and mats == {} and cross is None


def _numpy_orientation(g):
    """The forward edges (rank(src) < rank(dst), ranked by degree then id)
    sorted by their ranks, in numpy."""
    s = g.csr.sources.numpy().astype(np.int64)
    t = g.csr.targets.numpy().astype(np.int64)
    deg = np.bincount(s, minlength=g.node_count)
    rank = np.empty(g.node_count, np.int64)
    rank[np.argsort(deg, kind="stable")] = np.arange(g.node_count)
    a, b = rank[s], rank[t]
    fwd = a < b
    a, b = a[fwd], b[fwd]
    o = np.lexsort((b, a))
    return a[o], b[o].astype(np.int32)


def test_native_orientation_equals_numpy_and_graph_tpu():
    src, dst, n = _rmat(10, 3)
    g = gtt.build_undirected(src, dst, node_count=n, device="cpu",
                             layout=gtt.CsrLayout.DEDUPLICATED)
    s = g.csr.sources.numpy().astype(np.int32)
    t = g.csr.targets.numpy().astype(np.int32)
    a, b = host_csr.tc_orient_native(s, t, n)
    assert host_csr.load_error() is None
    na, nb = _numpy_orientation(g)
    np.testing.assert_array_equal(a, na)
    np.testing.assert_array_equal(b, nb)
    ja, jb = jax_orient(s, t, n)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    with pytest.raises(ValueError, match="endpoints"):
        host_csr.tc_orient_native(s, t, n - 1)


def test_numpy_orientation_path_counts_the_same():
    src, dst, n = _rmat(9, 5)
    g = gtt.build_undirected(src, dst, node_count=n, device="cpu",
                             layout=gtt.CsrLayout.DEDUPLICATED)
    res = gtt.global_triangle_count(g)
    a, b = _numpy_orientation(g)
    mats, cross, _ = ttc._pack_chunks(torch.from_numpy(a),
                                      torch.from_numpy(b), n)
    phases = {}
    assert ttc._run_join(mats, cross, a, b, device=CPU,
                         phases=phases) == res.triangles
    assert res.phases["forward_edges"] == a.size
    assert phases["slabs"] == res.phases["slabs"] > 0
    assert res.phases["wedges"] > 0


def test_padded_tail_is_trimmed_and_large_graphs_refused(monkeypatch):
    """Edges past ``offsets[-1]`` (a padded build's sentinel tail) are not
    counted; node counts from ``SENT`` up are refused."""
    src, dst = _edges(NAMED["k4"][0])
    g = gtt.build_undirected(src, dst, device="cpu",
                             layout=gtt.CsrLayout.DEDUPLICATED)
    assert gtt.global_triangle_count(_padded(g)).triangles == 4
    monkeypatch.setattr(ttc, "SENT", 4)
    with pytest.raises(ValueError, match="2\\^29"):
        gtt.global_triangle_count(g)


def test_empty_graphs_count_zero():
    g = gtt.build_undirected(np.zeros(0, np.int64), np.zeros(0, np.int64),
                             node_count=5, device="cpu",
                             layout=gtt.CsrLayout.DEDUPLICATED)
    assert gtt.global_triangle_count(g).triangles == 0
    loops = gtt.build_undirected([0, 1], [0, 1], device="cpu",
                                 layout=gtt.CsrLayout.SORTED)
    assert gtt.global_triangle_count(loops).triangles == \
        jax_tc(jax_build_undirected(jnp.asarray([0, 1]), jnp.asarray([0, 1]),
                                    layout=JaxLayout.SORTED)).triangles


@pytest.mark.requires_cuda
def test_counts_on_card_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src, dst, n = _rmat(10, 3)
    for layout in (gtt.CsrLayout.DEDUPLICATED, gtt.CsrLayout.SORTED):
        counts = [gtt.global_triangle_count(gtt.build_undirected(
            src, dst, node_count=n, layout=layout, device=d)).triangles
            for d in ("cuda", "cpu")]
        assert counts[0] == counts[1]
