"""GraphBuilder against graph_tpu's, end to end, and the device rule.

Each input form builds the same CSR arrays in both packages; the errors
are of the same kinds; the wiki-graph PageRank and the GDL SSSP golden
run through the builder in both and agree (PageRank within 1e-6 with the
same iteration count, and within 1e-4 of graph_tpu's Gauss-Seidel
``page_rank_reference``, as tests/test_pagerank.py holds graph_tpu;
SSSP distances exactly).
"""

import numpy as np
import pytest
import torch

import graph_tpu_torch as gtt
from graph_tpu import DeltaSteppingConfig as JaxSsspConfig
from graph_tpu import GraphBuilder as JaxBuilder
from graph_tpu import PageRankConfig as JaxConfig
from graph_tpu import delta_stepping as jax_delta_stepping
from graph_tpu import page_rank as jax_page_rank
from graph_tpu.algos.pagerank import page_rank_reference
from graph_tpu.engine import engine as jax_engine_mod
from graph_tpu.engine.engine import EdgeEngine as JaxEngine
from graph_tpu.graph.csr import CsrLayout as JaxLayout
from graph_tpu.io.binary import BinaryInput as JaxBinaryInput
from graph_tpu.io.binary import save_graph as jax_save_graph

WIKI_EDGES = [
    (1, 2), (2, 1), (4, 0), (4, 1), (5, 4), (5, 1), (5, 6), (6, 1),
    (6, 5), (7, 1), (7, 5), (8, 1), (8, 5), (9, 1), (9, 5), (10, 1),
    (10, 5), (11, 5), (12, 5),
]
SSSP_GDL = """(a:A)
              (b:B)
              (c:C)
              (d:D)
              (e:E)
              (f:F)
              (a)-[{cost:  4.0 }]->(b)
              (a)-[{cost:  2.0 }]->(c)
              (b)-[{cost:  5.0 }]->(c)
              (b)-[{cost: 10.0 }]->(d)
              (c)-[{cost:  3.0 }]->(e)
              (d)-[{cost: 11.0 }]->(f)
              (e)-[{cost:  4.0 }]->(d)"""
LAYOUTS = ["UNSORTED", "SORTED", "DEDUPLICATED"]


def _same(got, want):
    if want is None:
        assert got is None
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _same_graph(got, want):
    assert type(got).__name__ == type(want).__name__
    assert (got.node_count, got.edge_count, got.layout.name) == (
        want.node_count, want.edge_count, want.layout.name)
    csrs = ("csr_out", "csr_in") if hasattr(want, "csr_out") else ("csr",)
    for c in csrs:
        for f in ("offsets", "sources", "targets", "values"):
            _same(getattr(getattr(got, c), f), getattr(getattr(want, c), f))
    _same(got.node_values, want.node_values)


def _inputs():
    g = np.random.default_rng(12)
    src = g.integers(0, 30, 120)
    dst = g.integers(0, 30, 120)
    w = g.random(120).astype(np.float32)
    return {
        "edges": lambda b: b.edges(list(zip(src.tolist(), dst.tolist()))),
        "edges_array": lambda b: b.edges(np.stack([src, dst], 1)),
        "edges_with_values": lambda b: b.edges_with_values(
            list(zip(src.tolist(), dst.tolist(), w.tolist()))),
        "coo": lambda b: b.coo(src, dst, w),
        "node_values": lambda b: b.coo(src, dst).node_count(32).node_values(
            np.arange(32, dtype=np.float32)),
        "gdl": lambda b: b.gdl(SSSP_GDL),
    }


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("what", list(_inputs()))
@pytest.mark.parametrize("kind", ["directed", "undirected", "host"])
def test_builder_matches_graph_tpu(what, layout, kind):
    feed = _inputs()[what]
    b = feed(gtt.GraphBuilder(device="cpu").csr_layout(
        gtt.CsrLayout[layout]))
    jb = feed(JaxBuilder().csr_layout(JaxLayout[layout]))
    if kind == "directed":
        got, want = b.build_directed(), jb.build_directed()
    else:
        host = kind == "host"
        got, want = b.build_undirected(host=host), jb.build_undirected(
            host=host)
        assert got.host == host
    _same_graph(got, want)


def test_build_picks_the_graph_type():
    b = gtt.GraphBuilder(device="cpu").edges([(0, 1), (1, 2)])
    assert isinstance(b.build(), gtt.DirectedCsrGraph)
    assert isinstance(b.build(gtt.DirectedCsrGraph), gtt.DirectedCsrGraph)
    assert isinstance(b.build(gtt.UndirectedCsrGraph),
                      gtt.UndirectedCsrGraph)
    with pytest.raises(gtt.GraphError, match="unknown graph type"):
        b.build(int)


def _error_cases(tmp_path):
    g = JaxBuilder().edges([(0, 1), (1, 2)]).build_directed()
    snap = str(tmp_path / "directed.bin")
    jax_save_graph(snap, g)
    return {
        "node_values": (lambda B: B.edges([(0, 1), (1, 2)])
                        .node_values([1.0, 2.0]).build_directed(),
                        "InvalidNodeValues"),
        "no_input": (lambda B: B.build_directed(), "GraphError"),
        "bad_edges": (lambda B: B.edges([(0, 1, 2)]), "GraphError"),
        "snapshot_kind": (lambda B: B.file_format(
            B.binary()).path(snap).build_undirected(), "GraphError"),
        "snapshot_id_dtype": (lambda B: B.file_format(
            B.binary(np.int64)).path(snap), "InvalidIdType"),
    }


class _Port(gtt.GraphBuilder):
    binary = staticmethod(gtt.BinaryInput)

    def __init__(self):
        super().__init__(device="cpu")


class _Jax(JaxBuilder):
    binary = staticmethod(JaxBinaryInput)


@pytest.mark.parametrize("case", ["node_values", "no_input", "bad_edges",
                                  "snapshot_kind", "snapshot_id_dtype"])
def test_builder_errors_match_graph_tpu(tmp_path, case):
    call, name = _error_cases(tmp_path)[case]
    raised = []
    for B in (_Port, _Jax):
        with pytest.raises(Exception) as info:
            call(B())
        raised.append(type(info.value).__name__)
    assert raised == [name, name]
    assert issubclass(getattr(gtt, name), gtt.GraphError)


def test_builder_reads_snapshots_written_by_graph_tpu(tmp_path):
    jg = JaxBuilder().csr_layout(JaxLayout.SORTED).edges_with_values(
        [(0, 1, 0.25), (1, 0, 1.5), (2, 1, 3.0)]).build_directed()
    p = str(tmp_path / "g.bin")
    jax_save_graph(p, jg)
    got = gtt.GraphBuilder(device="cpu").file_format(gtt.BinaryInput()) \
        .path(p).build_directed()
    _same_graph(got, JaxBuilder().file_format(JaxBinaryInput()).path(p)
                .build_directed())


def _jax_page_rank(g, cfg):
    """graph_tpu's plan-engine PageRank, its Pallas kernels interpreted."""
    eng = JaxEngine.build(np.asarray(g.csr_out.sources),
                          np.asarray(g.csr_out.targets), g.node_count,
                          interpret=True, relabel="degree")
    jax_engine_mod._GRAPH_ENGINES[(id(g), "fwd")] = eng
    return jax_page_rank(g, JaxConfig(engine="plan", **cfg))


def test_builder_page_rank_matches_graph_tpu():
    cfg = {"max_iterations": 200, "tolerance": 1e-6}
    got = gtt.page_rank(gtt.GraphBuilder(device="cpu").edges(WIKI_EDGES)
                        .build_directed(), gtt.PageRankConfig(**cfg))
    want = _jax_page_rank(JaxBuilder().edges(WIKI_EDGES).build_directed(),
                          cfg)
    assert got.ran_iterations == want.ran_iterations
    np.testing.assert_array_equal(got.scores_np(), want.scores_np())
    out_nbrs = [[] for _ in range(13)]
    for s, t in WIKI_EDGES:
        out_nbrs[s].append(t)
    ref, _, _ = page_rank_reference(out_nbrs, 13, JaxConfig(**cfg))
    np.testing.assert_allclose(got.scores_np(), ref, atol=1e-4)
    assert got.error < 1e-6


@pytest.mark.parametrize("layout", LAYOUTS)
def test_builder_gdl_sssp_matches_graph_tpu(layout):
    got = gtt.delta_stepping(
        gtt.GraphBuilder(device="cpu").csr_layout(gtt.CsrLayout[layout])
        .gdl(SSSP_GDL).build_directed(), gtt.DeltaSteppingConfig(0, 3.0))
    want = jax_delta_stepping(
        JaxBuilder().csr_layout(JaxLayout[layout]).gdl(SSSP_GDL)
        .build_directed(), JaxSsspConfig(start_node=0, delta=3.0))
    _same(got.distances_np(), want.distances_np())
    assert got.distances_np().tolist() == [0.0, 4.0, 2.0, 9.0, 5.0, 20.0]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_builder_device_rule(no_card, tmp_path):
    """Without a card and without a device the builds raise; a host build
    needs no device, but PageRank and WCC on it raise until the caller
    asks for the CPU."""
    from graph_tpu_torch.graph.adj import DirectedALGraph

    edges = [(0, 1), (1, 2), (3, 4)]
    snap = str(tmp_path / "g.bin")
    gtt.save_graph(snap, gtt.build_directed([0], [1], device="cpu"))
    (tmp_path / "graph-500-22").mkdir()
    (tmp_path / "graph-500-22" / "graph500-22.e").write_text("0 1\n")
    for build in (lambda: gtt.GraphBuilder().edges(edges).build_directed(),
                  lambda: gtt.GraphBuilder().edges(edges).build_undirected(),
                  lambda: gtt.GraphBuilder().file_format(gtt.BinaryInput())
                  .path(snap),
                  lambda: gtt.load_graph500(22, str(tmp_path)),
                  lambda: DirectedALGraph(3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()

    host = gtt.GraphBuilder().edges(edges).build_undirected(host=True)
    relabeled = gtt.make_degree_ordered(host)  # on the host, no device
    assert host.host and relabeled.host and host.device.type == "cpu"
    for run in (lambda d: gtt.wcc(host, device=d),
                lambda d: gtt.wcc_components(host, device=d),
                lambda d: gtt.wcc(relabeled, device=d)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(None)
        run("cpu")
    assert gtt.wcc(host, device="cpu").components_np().tolist() == \
        [0, 0, 0, 3, 3]

    directed = gtt.GraphBuilder(device="cpu").edges(edges).build_directed()
    assert gtt.page_rank(directed).scores.device.type == "cpu"
    weighted = gtt.GraphBuilder(device="cpu").gdl(SSSP_GDL).build_directed()
    assert gtt.delta_stepping(weighted, gtt.DeltaSteppingConfig(0, 3.0)) \
        .distances.device.type == "cpu"


def test_host_graph_runs_where_asked(no_card):
    """A host graph's engine is built on the device the caller names, and
    cached per device."""
    from graph_tpu_torch.algos.wcc import _sym_engine

    host = gtt.build_undirected_host([0, 1], [1, 2], node_count=4)
    eng = _sym_engine(host, "cpu")
    assert eng.device.type == "cpu" and _sym_engine(host, "cpu") is eng
    res = gtt.wcc(host, device="cpu")
    assert res.components.device.type == "cpu"
    assert res.components_np().tolist() == [0, 0, 0, 3]


@pytest.mark.parametrize("modname", [
    "graph_tpu_torch.builder",
    "graph_tpu_torch.graph.ops",
    "graph_tpu_torch.io.binary",
    "graph_tpu_torch.algos.wcc",
])
def test_port_module_doctests(modname):
    import doctest
    import importlib

    res = doctest.testmod(importlib.import_module(modname),
                          optionflags=doctest.ELLIPSIS)
    assert res.attempted > 0 and res.failed == 0, modname
