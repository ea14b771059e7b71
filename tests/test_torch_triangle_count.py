"""The port's triangle count against graph_tpu's, on the same edges.

Counts are integers: equal, no tolerance.  ``graph_tpu`` pads every join
step to ``SLAB`` wedge slots (2**25), which costs seconds on the CPU per
step, so both packages' ``SLAB`` is shrunk here (the port's further, to
take many steps); the count does not depend on it.  The cases are those
of tests/test_triangle_count.py that need no fixture, then random and
RMAT graphs with both semantics
(distinct on DEDUPLICATED, the reference's multiset on SORTED), each also
held to an independent host count.

The join kernel (``csrc/tc_count.cu``) runs only on a card: the tests
marked ``requires_cuda`` hold it to its plain version (held to graph_tpu
here on the CPU) and to scipy's or a closed-form count, and skip without
a card.  The card's machine has no JAX, so there they run alone:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_triangle_count.py
"""

import math

import numpy as np
import pytest
import torch

import graph_tpu_torch as gtt
from benchmark.generators import gap_kron
from graph_tpu_torch.algos import triangle_count as ttc
from graph_tpu_torch.engine import kernels, tc_join
from graph_tpu_torch.generate import host_rmat
from graph_tpu_torch.native import host_csr
from graph_tpu_torch.parallel import tc as ptc

try:
    import jax.numpy as jnp
    from graph_tpu import global_triangle_count as jax_tc
    from graph_tpu.algos import triangle_count as jtc
    from graph_tpu.graph.build import build_undirected as jax_build_undirected
    from graph_tpu.graph.csr import CsrLayout as JaxLayout
    from graph_tpu.graph.ops import make_degree_ordered as jax_degree_ordered
    from graph_tpu.native.host_csr import tc_orient_native as jax_orient
except ImportError:  # the card's machine: only the card tests run there
    jtc = None

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def small_slab(monkeypatch):
    if jtc is not None:
        monkeypatch.setattr(jtc, "SLAB", 1 << 20)
        monkeypatch.setattr(tc_join, "SLAB", 1 << 12)


def _prepared(g, device=CPU):
    """The preparation's forward CSR, and the plain join's pieces from it:
    (forward, chunk matrices, cross-chunk row pairs, heads, targets)."""
    fwd = ttc._prepare_distinct(g, {}, device)
    n = fwd.offsets.numel() - 1
    a = torch.repeat_interleave(torch.arange(n, device=device),
                                torch.diff(fwd.offsets))
    mats, cross, _ = tc_join._pack_chunks(a, fwd.targets, n)
    return fwd, mats, cross, a, fwd.targets


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
    monkeypatch.setattr(tc_join, "SLAB", 16)
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
    _, mats, cross, a, b = _prepared(g)
    assert tc_join._run_join(mats, cross, a, b, device=CPU) == _host_distinct(
        src, dst, n)
    v, w = tc_join._emit_intra(mats[4], 4)
    ev, ew = jtc._pad_edge_keys(a.numpy(), b.numpy())
    want = int(jtc._join_count(jnp.asarray(v.numpy()), jnp.asarray(w.numpy()),
                               jnp.asarray(ev), jnp.asarray(ew)))
    keys = tc_join._edge_keys(a, b, CPU)
    assert int(tc_join._lookup_count(v, w, keys)) == want
    assert tc_join._run_join({4: mats[4]}, None, a, b, device=CPU) == want


def test_packing_and_emission_match_graph_tpu():
    src, dst, n = _rmat_clique()
    g = gtt.build_undirected(src, dst, node_count=n, device="cpu",
                             layout=gtt.CsrLayout.DEDUPLICATED)
    _, mats, cross, a, b = _prepared(g)
    jm, jc = jtc._pack_chunks(a.numpy(), b.numpy())
    assert sorted(mats) == sorted(jm) and 64 in mats and cross is not None
    for cap in mats:
        np.testing.assert_array_equal(mats[cap].numpy(), jm[cap])
        v, w = tc_join._emit_intra(mats[cap], cap)
        jv, jw = jtc._emit_intra(jnp.asarray(jm[cap]), cap)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    for mine, theirs in zip(cross, jc):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    v, w = tc_join._emit_cross(*cross)
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
    fwd = ttc._prepare_distinct(g, phases, CPU)
    _, mats, cross, a, b = _prepared(g)
    assert fwd.offsets.dtype == torch.int64 and b.dtype == torch.int32
    np.testing.assert_array_equal(
        fwd.offsets.numpy(), np.concatenate([[0], np.cumsum(
            np.bincount(ja, minlength=n))]))
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
        assert fdeg.max() > 2 * tc_join.CLASS_CAPS[-1]
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
    mats, cross, _ = tc_join._pack_chunks(torch.from_numpy(a),
                                      torch.from_numpy(b), n)
    phases = {}
    assert tc_join._run_join(mats, cross, a, b, device=CPU,
                         phases=phases) == res.triangles
    assert res.phases["forward_edges"] == a.size
    assert phases["slabs"] > 0 and res.phases["slabs"] == 1
    fdeg = np.bincount(a, minlength=n)
    assert res.phases["wedges"] == res.phases["wedge_slots"] == int(
        (fdeg * (fdeg - 1) // 2).sum()) > 0


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


# ------------------------------------------- the join kernel's scheme (CPU)


KRON = {"edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19}


def _kron(scale, seed=None):
    """GAP's kron graph at ``scale``: (src, dst, n)."""
    gen = torch.Generator("cpu")
    gen.manual_seed(2**31 + scale if seed is None else seed)
    d = gap_kron.make(dict(KRON, scale=scale), gen)
    return d.src.numpy(), d.dst.numpy(), d.n


def _with_clique(src, dst, n, k, first=0):
    """Edges with a k-clique on nodes first .. first + k - 1 added."""
    i, j = np.triu_indices(k, 1)
    return (np.concatenate([src, i + first]),
            np.concatenate([dst, j + first]), n)


FORWARD = {**{f"named_{k}": (lambda k=k: (*_edges(NAMED[k][0]), None))
              for k in NAMED},
           **{f"kron{s}": (lambda s=s: _kron(s)) for s in (8, 9, 10, 11, 12)}}


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_forward_offsets_equal_the_packings_degrees(name):
    """The forward CSR's offsets are the cumsum of the degrees
    ``_pack_chunks`` counts, its schedule the heads of two or more forward
    edges by class; the count, through the plain join, is graph_tpu's."""
    src, dst, n = FORWARD[name]()
    g = gtt.build_undirected(src, dst, node_count=n, device="cpu",
                             layout=gtt.CsrLayout.DEDUPLICATED)
    fwd, _, _, a, b = _prepared(g)
    n = g.node_count
    _, _, deg = tc_join._pack_chunks(a, b, n)
    assert torch.equal(fwd.offsets[1:], torch.cumsum(deg, 0))
    assert int(fwd.offsets[0]) == 0 and fwd.targets is b
    heads = torch.arange(n)
    assert torch.equal(fwd.long_heads.long(), heads[deg > kernels.TC_LONG])
    assert torch.equal(fwd.short_heads.long(),
                       heads[(deg >= 2) & (deg <= kernels.TC_LONG)])
    assert fwd.long_heads.dtype == fwd.short_heads.dtype == torch.int32
    got, want = _counts(src, dst, n)
    assert got == want


def test_cpu_tensors_go_to_the_plain_version(monkeypatch):
    """On the CPU the wrapper runs its plain version (the emission join,
    so a fault planted in ``_lookup_count`` shows) and launches nothing."""
    src, dst, n = _rmat_clique(scale=8)
    g = gtt.build_undirected(src, dst, node_count=n, device="cpu",
                             layout=gtt.CsrLayout.DEDUPLICATED)
    fwd = ttc._prepare_distinct(g, {}, CPU)
    assert fwd.long_heads.numel() > 0
    calls = []
    plain = kernels.tc_count_plain
    monkeypatch.setattr(kernels, "tc_count_plain",
                        lambda *a: calls.append(a[2:]) or plain(*a))
    monkeypatch.setattr(kernels, "_launch", lambda *a: pytest.fail(
        "a CPU count launched a kernel"))
    want = _host_distinct(src, dst, n)
    got = kernels.tc_count(*fwd)
    assert got.dtype == torch.int64 and got.dim() == 0 and int(got) == want
    assert gtt.global_triangle_count(g).triangles == want
    assert calls == [(0, n), (0, n)]
    monkeypatch.setattr(tc_join, "_lookup_count",
                        lambda v, w, keys: torch.zeros((), dtype=torch.int64))
    assert gtt.global_triangle_count(g).triangles == 0


def _scheme(fwd, h0, h1):
    """A model of the kernel's scheme, in numpy: each scheduled head in
    [h0, h1), tile by tile (``TC_TILE`` targets a long head's,
    ``TC_WARP_TILE`` a short one's), each neighbour that may close a wedge
    in the tile read whole and its targets looked up among the tile's.
    Returns (count, bytes read)."""
    off, tg = fwd.offsets.numpy(), fwd.targets.numpy()
    deg = np.diff(off)
    count = nbytes = 0
    for heads, tl in ((fwd.long_heads, kernels.TC_TILE),
                      (fwd.short_heads, kernels.TC_WARP_TILE)):
        for u in heads.tolist():
            if not h0 <= u < h1:
                continue
            beg, d = off[u], deg[u]
            nbytes += 16 + 4 * d
            for t0 in range(0, d, tl):
                t1 = min(t0 + tl, d)
                nb = tg[beg: beg + t1 - 1]  # the neighbours it may close
                lens = deg[nb]
                first = np.repeat(off[nb] - (np.cumsum(lens) - lens), lens)
                read = tg[first + np.arange(lens.sum())]
                nbytes += int((20 + 4 * lens).sum())
                count += int(np.isin(read, tg[beg + t0: beg + t1]).sum())
    return count, nbytes


SCHEME = {
    **{f"kron{s}": (lambda s=s: _kron(s)) for s in (8, 9, 10)},
    # forward lists up to 64 (a warp's whole tile), 65 (the smallest long
    # head), and well past the class bound
    **{f"kron8_clique{k}": (lambda k=k: _with_clique(*_kron(8), k, first=7))
       for k in (65, 66, 150)},
    "kron9_clique300": lambda: _with_clique(*_kron(9), 300, first=100),
    "random8": GRAPHS["random8"], "rmat9": GRAPHS["rmat9"],
    "rmat10_clique": GRAPHS["rmat10_clique"]}


@pytest.mark.parametrize("graph", sorted(SCHEME))
def test_the_kernels_scheme_counts_what_the_plain_join_counts(graph):
    """The kernel's tiles and neighbour ranges, modelled in Python, count
    the plain join's triangles, over the whole graph and over two head
    ranges; its reads are those chip_smoke's ``tc_count_reads`` counts
    for the kernel's bound."""
    import chip_smoke

    src, dst, n = SCHEME[graph]()
    g = gtt.build_undirected(src, dst, node_count=n, device="cpu",
                             layout=gtt.CsrLayout.DEDUPLICATED)
    fwd = ttc._prepare_distinct(g, {}, CPU)
    want = int(kernels.tc_count(*fwd))
    count, nbytes = _scheme(fwd, 0, n)
    assert count == want == _host_distinct(src, dst, n) > 0
    assert nbytes == chip_smoke.tc_count_reads(fwd.offsets, fwd.targets)
    if graph == "kron8_clique150":
        assert int(torch.diff(fwd.offsets).max()) > 2 * kernels.TC_LONG
    cut = n // 3
    parts = [_scheme(fwd, 0, cut)[0], _scheme(fwd, cut, n)[0]]
    assert sum(parts) == want
    assert [int(kernels.tc_count(*fwd, 0, cut)),
            int(kernels.tc_count(*fwd, cut, n))] == parts


def test_head_ranges_split_the_wedges():
    src, dst, n = _kron(11)
    g = gtt.build_undirected(src, dst, node_count=n, device="cpu",
                             layout=gtt.CsrLayout.DEDUPLICATED)
    fwd = ttc._prepare_distinct(g, {}, CPU)
    deg = torch.diff(fwd.offsets)
    wedges = deg * (deg - 1) // 2
    for parts in (1, 2, 3, 8):
        b = ptc.head_ranges(fwd.offsets, parts)
        assert len(b) == parts + 1 and b[0] == 0 and b[-1] == n
        assert b == sorted(b)
        shares = [int(wedges[lo:hi].sum()) for lo, hi in zip(b, b[1:])]
        assert sum(shares) == int(wedges.sum())
        assert max(shares) <= int(wedges.sum()) / parts + int(wedges.max())
        assert sum(int(kernels.tc_count(*fwd, lo, hi))
                   for lo, hi in zip(b, b[1:])) == \
            gtt.global_triangle_count(g).triangles


def test_the_wrapper_checks_its_range():
    g = gtt.build_undirected(*_edges(NAMED["k4"][0]), device="cpu",
                             layout=gtt.CsrLayout.DEDUPLICATED)
    fwd = ttc._prepare_distinct(g, {}, CPU)
    assert int(kernels.tc_count(*fwd)) == 4
    for h0, h1 in ((-1, 4), (3, 2), (0, 5)):
        with pytest.raises(ValueError, match="head range"):
            kernels.tc_count(*fwd, h0, h1)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the join kernel has no CPU mode")
    return torch.device("cuda")


def _scipy_count(src, dst, n):
    """Distinct triangles by scipy: U the adjacency above the diagonal,
    each triangle i < j < k one product U[i,j] U[j,k] under U[i,k]."""
    import scipy.sparse as sp

    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    keep = lo != hi
    u = sp.csr_matrix((np.ones(int(keep.sum()), np.int64),
                       (lo[keep], hi[keep])), shape=(n, n))
    u.data[:] = 1  # repeated pairs count once
    return int((u @ u).multiply(u).sum())


def _star(n=5000):
    """A star: every forward list holds at most one target."""
    return np.zeros(n - 1, np.int64), np.arange(1, n), n


def _clique(k):
    i, j = np.triu_indices(k, 1)
    return i, j, k


CARD = {
    **{f"kron{s}": (lambda s=s: (*_kron(s), None)) for s in range(8, 17)},
    # forward lists up to 64 (a warp's whole tile) and 65 (a block's)
    "clique65": lambda: (*_clique(65), math.comb(65, 3)),
    "clique66": lambda: (*_clique(66), math.comb(66, 3)),
    # a forward list of 1,024 (a block's whole tile), and of 1,025, whose
    # last target is a tile of its own
    "clique1025": lambda: (*_clique(1025), math.comb(1025, 3)),
    "clique1026": lambda: (*_clique(1026), math.comb(1026, 3)),
    # a forward list of 1,099, longer than the longest at kron scale 22
    # and than a block's tile: counted in two tiles
    "clique1100": lambda: (*_clique(1100), math.comb(1100, 3)),
    # 2,099 targets: past twice a block's tile, counted in three
    "clique2100": lambda: (*_clique(2100), math.comb(2100, 3)),
    "star": lambda: (*_star(), 0),
    # lists of 65 to 200 beside kron's: past a warp's tile and class
    "kron12_cliques": lambda: (*_with_clique(*_with_clique(
        *_kron(12), 65, first=11), 200, first=1000), None),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("graph", sorted(CARD))
def test_kernel_counts_on_card(graph, cuda_device):
    """The kernel counts what its plain version, scipy (or the closed
    form) and the count through ``global_triangle_count`` do."""
    src, dst, n, want = CARD[graph]()
    if want is None:
        want = _scipy_count(src, dst, n)
    g = gtt.build_undirected(src, dst, node_count=n, device=cuda_device,
                             layout=gtt.CsrLayout.DEDUPLICATED)
    fwd = ttc._prepare_distinct(g, {}, cuda_device)
    before = kernels.LAUNCHES["tc_count"]
    got = kernels.tc_count(*fwd)
    assert got.device == fwd.offsets.device and got.dtype == torch.int64
    assert kernels.LAUNCHES["tc_count"] == before + 1
    plain = kernels.tc_count_plain(fwd.offsets, fwd.targets, 0, n)
    res = gtt.global_triangle_count(g)
    assert int(got) == int(plain) == res.triangles == want
    assert res.phases["slabs"] == 1
    if graph == "clique2100":
        assert int(torch.diff(fwd.offsets).max()) > 2 * kernels.TC_TILE
    if graph == "star":
        assert fwd.long_heads.numel() == fwd.short_heads.numel() == 0


@pytest.mark.requires_cuda
def test_kernel_head_ranges_add_up_on_card(cuda_device):
    """Two head ranges add up to the whole, at several cuts (both
    classes' bounds among them); one launch a range."""
    src, dst, n, _ = CARD["kron12_cliques"]()
    g = gtt.build_undirected(src, dst, node_count=n, device=cuda_device,
                             layout=gtt.CsrLayout.DEDUPLICATED)
    fwd = ttc._prepare_distinct(g, {}, cuda_device)
    whole = int(kernels.tc_count(*fwd))
    cuts = [0, 1, n // 3, int(fwd.long_heads[0]), int(fwd.short_heads[-1]),
            n]
    for cut in cuts:
        before = kernels.LAUNCHES["tc_count"]
        parts = [int(kernels.tc_count(*fwd, 0, cut)),
                 int(kernels.tc_count(*fwd, cut, n))]
        assert kernels.LAUNCHES["tc_count"] == before + 2
        assert sum(parts) == whole, cut
        assert parts[0] == int(kernels.tc_count_plain(
            fwd.offsets, fwd.targets, 0, cut))
    assert sum(int(kernels.tc_count(*fwd, lo, hi)) for lo, hi in zip(
        ptc.head_ranges(fwd.offsets, 4), ptc.head_ranges(fwd.offsets, 4)[1:])
    ) == whole


@pytest.mark.requires_cuda
def test_kernel_empty_graph_on_card(cuda_device):
    """No forward edge at all: 0, in one launch; and the empty graph
    through the entry point."""
    dev = cuda_device
    offsets = torch.zeros(6, dtype=torch.int64, device=dev)
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    before = kernels.LAUNCHES["tc_count"]
    assert int(kernels.tc_count(offsets, empty, empty, empty)) == 0
    assert kernels.LAUNCHES["tc_count"] == before + 1
    g = gtt.build_undirected(np.zeros(0, np.int64), np.zeros(0, np.int64),
                             node_count=5, device=dev,
                             layout=gtt.CsrLayout.DEDUPLICATED)
    assert gtt.global_triangle_count(g).triangles == 0


@pytest.mark.requires_cuda
def test_kernel_wrapper_raises_on_card(cuda_device):
    """A wrong dtype, a tensor on another device or a strided one raise;
    nothing falls back to the plain version."""
    src, dst, n = _kron(8)
    g = gtt.build_undirected(src, dst, node_count=n, device=cuda_device,
                             layout=gtt.CsrLayout.DEDUPLICATED)
    off, tg, lh, sh = ttc._prepare_distinct(g, {}, cuda_device)
    with pytest.raises(TypeError, match="offsets"):
        kernels.tc_count(off.int(), tg, lh, sh)
    with pytest.raises(TypeError, match="targets"):
        kernels.tc_count(off, tg.long(), lh, sh)
    with pytest.raises(ValueError, match="targets is on cpu"):
        kernels.tc_count(off, tg.cpu(), lh, sh)
    with pytest.raises(ValueError, match="short_heads must be a contiguous"):
        kernels.tc_count(off, tg, lh, torch.stack([sh, sh], 1)[:, 0])
