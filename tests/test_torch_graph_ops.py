"""The port's host build, graph transforms and adjacency-list graphs
against graph_tpu's, on the same seeded inputs, exactly."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_tpu_torch as gtt
from graph_tpu.errors import GraphError as JaxGraphError
from graph_tpu.errors import InvalidPartitioning as JaxInvalidPartitioning
from graph_tpu.graph import adj as jax_adj
from graph_tpu.graph import ops as jax_ops
from graph_tpu.graph.build import build_directed as jax_build_directed
from graph_tpu.graph.build import build_undirected as jax_build_undirected
from graph_tpu.graph.build import \
    build_undirected_host as jax_build_undirected_host
from graph_tpu.graph.csr import CsrLayout as JaxLayout
from graph_tpu_torch.graph import adj, ops
from graph_tpu_torch.native import host_csr

LAYOUTS = ["UNSORTED", "SORTED", "DEDUPLICATED"]


def _edges(seed=6, n=60, m=400):
    """Duplicates, self-loops and isolated nodes included."""
    g = np.random.default_rng(seed)
    src = g.integers(0, n - 10, m).astype(np.int32)
    dst = g.integers(0, n - 10, m).astype(np.int32)
    src[:40], dst[:40] = src[40:80], dst[40:80]
    dst[80:100] = src[80:100]
    vals = g.random(m).astype(np.float32)
    nv = g.random(n).astype(np.float32)
    return src, dst, vals, nv, n


def _same(got, want):
    if want is None:
        assert got is None
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _same_undirected(got, want):
    assert got.layout.name == want.layout.name
    assert (got.node_count, got.edge_count) == (want.node_count,
                                                want.edge_count)
    for f in ("offsets", "sources", "targets", "values"):
        _same(getattr(got.csr, f), getattr(want.csr, f))
    _same(got.node_values, want.node_values)


@pytest.fixture(params=["native", "numpy"])
def host_builder(request, monkeypatch):
    """build_undirected_host through the radix builder, or with the
    native library taken away (the numpy path)."""
    if request.param == "numpy":
        monkeypatch.setattr(host_csr, "build_undirected_native",
                            lambda *a: None)
    return request.param


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("weighted", [False, True])
def test_build_undirected_host_matches_graph_tpu(host_builder, layout,
                                                 weighted):
    src, dst, vals, nv, n = _edges()
    vals = vals if weighted else None
    got = gtt.build_undirected_host(src, dst, vals, node_count=n,
                                    layout=gtt.CsrLayout[layout],
                                    node_values=nv)
    want = jax_build_undirected_host(src, dst, vals, node_count=n,
                                     layout=JaxLayout[layout],
                                     node_values=nv)
    assert got.host and got.device.type == "cpu"
    _same_undirected(got, want)
    # and the same graph as the port's device build
    dev = gtt.build_undirected(src, dst, vals, node_count=n,
                               layout=gtt.CsrLayout[layout], node_values=nv,
                               device="cpu")
    assert not dev.host
    for f in ("offsets", "sources", "targets", "values"):
        a, b = getattr(got.csr, f), getattr(dev.csr, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), f


def test_build_undirected_host_native_ran():
    src, dst, _, _, n = _edges(seed=3)
    assert host_csr.build_undirected_native(src, dst, None, n, 1) is not None
    assert host_csr.load_error() is None


@pytest.mark.parametrize("layout", LAYOUTS)
def test_build_undirected_host_int64_ids(layout):
    """int64 ids take the numpy path; it equals the device build."""
    src, dst, vals, _, n = _edges(seed=4)
    got = gtt.build_undirected_host(src, dst, vals, node_count=n,
                                    layout=gtt.CsrLayout[layout],
                                    id_dtype=np.int64)
    want = gtt.build_undirected(src, dst, vals, node_count=n,
                                layout=gtt.CsrLayout[layout],
                                id_dtype=np.int64, device="cpu")
    for f in ("offsets", "sources", "targets", "values"):
        a, b = getattr(got.csr, f), getattr(want.csr, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert got.csr.targets.dtype == torch.int64


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_degree_order_permutation_matches_graph_tpu(seed):
    deg = np.random.default_rng(seed).integers(0, 4, 200)  # many ties
    want = jax_ops.degree_order_permutation(deg)
    _same(gtt.degree_order_permutation(deg), want)
    old_id = ops._degree_order(torch.from_numpy(deg))
    new_id = np.empty(deg.size, np.int64)
    new_id[old_id.numpy()] = np.arange(deg.size)
    np.testing.assert_array_equal(new_id, want)


def test_degree_order_ties_in_descending_old_id():
    assert gtt.degree_order_permutation(np.array([2, 5, 2, 7])).tolist() \
        == [3, 1, 2, 0]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("branch", ["host", "device"])
def test_make_degree_ordered_matches_graph_tpu(branch, layout):
    src, dst, vals, nv, n = _edges(seed=5)
    lay, jlay = gtt.CsrLayout[layout], JaxLayout[layout]
    if branch == "host":
        g = gtt.build_undirected_host(src, dst, vals, node_count=n,
                                      layout=lay, node_values=nv)
        jg = jax_build_undirected_host(src, dst, vals, node_count=n,
                                       layout=jlay, node_values=nv)
    else:
        g = gtt.build_undirected(src, dst, vals, node_count=n, layout=lay,
                                 node_values=nv, device="cpu")
        jg = jax_build_undirected(jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(vals), node_count=n,
                                  layout=jlay, node_values=nv)
    got, want = gtt.make_degree_ordered(g), jax_ops.make_degree_ordered(jg)
    _same_undirected(got, want)
    assert got.host == (branch == "host")
    deg = got.degrees()
    assert bool((deg[1:] <= deg[:-1]).all())


def test_make_degree_ordered_keeps_node_values_with_their_nodes():
    g = gtt.build_undirected([3, 3, 3, 0], [0, 1, 2, 1], node_count=4,
                             node_values=np.array([10, 11, 12, 13]),
                             device="cpu")
    r = gtt.make_degree_ordered(g)
    assert r.degrees().tolist() == [3, 2, 2, 1]
    # new 0 is old 3 (the hub); old 1 and 0 tie at 2, higher id first
    assert r.node_values.tolist() == [13, 11, 10, 12]


@pytest.mark.parametrize("layout", [None, *LAYOUTS])
@pytest.mark.parametrize("weighted", [False, True])
def test_to_undirected_matches_graph_tpu(layout, weighted):
    src, dst, vals, _, n = _edges(seed=8)
    vals = vals if weighted else None
    g = gtt.build_directed(src, dst, vals, node_count=n, device="cpu")
    jg = jax_build_directed(jnp.asarray(src), jnp.asarray(dst),
                            None if vals is None else jnp.asarray(vals),
                            node_count=n)
    got = gtt.to_undirected(g, None if layout is None
                            else gtt.CsrLayout[layout])
    want = jax_ops.to_undirected(jg, None if layout is None
                                 else JaxLayout[layout])
    _same_undirected(got, want)


@pytest.mark.parametrize("concurrency", [1, 2, 3, 7, 64])
def test_degree_partition_matches_graph_tpu(concurrency):
    deg = np.random.default_rng(concurrency).integers(0, 50, 97)
    deg[10] = 2000  # a hub
    want = jax_ops.degree_partition(deg, concurrency)
    assert gtt.degree_partition(deg, concurrency) == want
    assert gtt.degree_partition(torch.from_numpy(deg), concurrency) == want


@pytest.mark.parametrize("args", [([1, 2, 3], 0), ([1, -2, 3], 2)])
def test_degree_partition_errors_match_graph_tpu(args):
    with pytest.raises(gtt.InvalidPartitioning):
        gtt.degree_partition(*args)
    with pytest.raises(JaxInvalidPartitioning):
        jax_ops.degree_partition(*args)


def _mutate(g, weighted, edges):
    for s, t in edges:
        if weighted:
            g.add_edge_with_value(s, t, s + t / 8)
        else:
            g.add_edge(s, t)


@pytest.mark.parametrize("kind", ["Directed", "Undirected"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("weighted", [False, True])
def test_al_graph_snapshots_match_graph_tpu(kind, layout, weighted):
    n = 12
    edges = np.random.default_rng(2).integers(0, n, (30, 2)).tolist()
    g = getattr(adj, f"{kind}ALGraph")(n, edges=edges[:10] if not weighted
                                       else None,
                                       layout=gtt.CsrLayout[layout],
                                       device="cpu")
    jg = getattr(jax_adj, f"{kind}ALGraph")(n, edges=edges[:10]
                                            if not weighted else None,
                                            layout=JaxLayout[layout])
    for part in (edges[10:20], edges[20:]):
        _mutate(g, weighted, part if not weighted else edges[:10] + part)
        _mutate(jg, weighted, part if not weighted else edges[:10] + part)
        s, js = g.snapshot(), jg.snapshot()
        csrs = (("csr_out", "csr_in") if kind == "Directed" else ("csr",))
        for c in csrs:
            for f in ("offsets", "sources", "targets", "values"):
                _same(getattr(getattr(s, c), f), getattr(getattr(js, c), f))
        assert g.edge_count == jg.edge_count
        _same(g.degrees(), jg.degrees())
        for v in range(n):
            _same(g.neighbors(v), jg.neighbors(v))


def test_al_graph_missing_node_and_weight_errors():
    g = adj.DirectedALGraph(2, device="cpu")
    jg = jax_adj.DirectedALGraph(2)
    for graph, missing, error in ((g, adj.MissingNode, gtt.GraphError),
                                  (jg, jax_adj.MissingNode, JaxGraphError)):
        for s, t in ((0, 5), (7, 0), (-1, 0)):
            with pytest.raises(missing, match="does not exist"):
                graph.add_edge(s, t)
        with pytest.raises(missing):
            graph.neighbors(2)
        graph.add_edge_with_value(0, 1, 0.5)
        with pytest.raises(error):
            graph.add_edge(1, 0)  # unweighted insert into weighted graph
    u = adj.UndirectedALGraph(2, edges=[(0, 1)], device="cpu")
    with pytest.raises(gtt.GraphError, match="unweighted"):
        u.add_edge_with_value(1, 0, 1.0)


def test_al_graph_snapshot_cached_until_mutation():
    g = adj.DirectedALGraph(3, edges=[(0, 1)], device="cpu")
    s1 = g.snapshot()
    assert g.snapshot() is s1
    g.add_edge(1, 2)
    s2 = g.snapshot()
    assert s2 is not s1 and s2.edge_count == 2 and g.snapshot() is s2
    assert s2.device.type == "cpu"


def test_al_graph_parallel_mutation_is_safe():
    g = adj.DirectedALGraph(64, device="cpu")
    per_thread = 2000
    barrier = threading.Barrier(2)

    def adder(base):
        barrier.wait(timeout=30)
        for i in range(per_thread):
            g.add_edge(base, (base + i) % 64)

    threads = [threading.Thread(target=adder, args=(b,)) for b in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert g.edge_count == 2 * per_thread
    src = g.snapshot().csr_out.sources.numpy()
    dst = g.snapshot().csr_out.targets.numpy()
    for b in (1, 2):
        np.testing.assert_array_equal(
            np.sort(dst[src == b]), np.sort((b + np.arange(per_thread)) % 64))
