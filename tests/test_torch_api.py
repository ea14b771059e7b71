"""graph_tpu_torch.api against graph_tpu.api, on the same files and arrays.

Mirrors tests/test_api.py test for test, with inputs made here from
seeds instead of fixture files: a scale-8 RMAT (``host_rmat(8, 16, 42)``,
written as Graph500 by the port's ``write_graph500``), and a 64-node
edge list with and without f32 weights.  Every case runs both packages'
API, the port's with ``device="cpu"``, and compares them: node and edge
counts, degrees, neighbor arrays, WCC components, triangle counts and
SSSP distances exactly; PageRank with the same iteration count and
scores within 1e-6 (graph_tpu's CPU engine is ``cumsum``, the port's
``auto`` is the plan engine).
"""

import doctest

import numpy as np
import pytest
import torch

import graph_tpu
import graph_tpu_torch
from graph_tpu.algos import triangle_count as jtc
from graph_tpu.api import DiGraph as JaxDiGraph
from graph_tpu.api import FileFormat as JaxFileFormat
from graph_tpu.api import Graph as JaxGraph
from graph_tpu.api import Layout as JaxLayout
from graph_tpu_torch import api
from graph_tpu_torch.api import DiGraph, FileFormat, Graph, Layout
from graph_tpu_torch.engine import tc_join
from graph_tpu_torch.generate import host_rmat
from graph_tpu_torch.io.graph500 import write_graph500

SCALE = 8
#: PageRank scores: the port's plan engine against graph_tpu's cumsum.
PR_ATOL = 1e-6


def write_inputs(root):
    """The seeded inputs: (graph500 path, .el path, .wel path)."""
    src, dst = host_rmat(SCALE, 16, 42)
    g500 = str(root / f"rmat_s{SCALE}.graph500")
    write_graph500(g500, src, dst)
    rng = np.random.default_rng(64)
    s, t = rng.integers(0, 64, 256), rng.integers(0, 64, 256)
    el, wel = str(root / "g64.el"), str(root / "g64.wel")
    np.savetxt(el, np.stack([s, t], 1), fmt="%d")
    w = (rng.random(256) * 4).astype(np.float32)
    with open(wel, "w") as f:
        f.writelines(f"{a} {b} {c:.6f}\n" for a, b, c in zip(s, t, w))
    return g500, el, wel


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("api"))


@pytest.fixture(autouse=True)
def small_slab(monkeypatch):
    """graph_tpu pads each triangle join step to SLAB wedge slots (2**25),
    seconds on the CPU per step; the count does not depend on it."""
    monkeypatch.setattr(jtc, "SLAB", 1 << 20)
    monkeypatch.setattr(tc_join, "SLAB", 1 << 12)


def load_both(cls, path, **kw):
    """(port graph on the CPU, graph_tpu graph) of one file."""
    jcls = {Graph: JaxGraph, DiGraph: JaxDiGraph}[cls]
    jkw = dict(kw)
    if "layout" in kw:
        jkw["layout"] = getattr(JaxLayout, kw["layout"])
        kw["layout"] = getattr(Layout, kw["layout"])
    if "file_format" in kw:
        jkw["file_format"] = getattr(JaxFileFormat, kw["file_format"])
        kw["file_format"] = getattr(FileFormat, kw["file_format"])
    return cls.load(path, device="cpu", **kw), jcls.load(path, **jkw)


@pytest.fixture(scope="module")
def g(paths):
    return load_both(DiGraph, paths[0], layout="Sorted")


@pytest.fixture(scope="module")
def el_g(paths):
    return load_both(DiGraph, paths[1], layout="Sorted",
                     file_format="EdgeList")


@pytest.fixture(scope="module")
def el_ug(paths):
    return load_both(Graph, paths[1], layout="Sorted",
                     file_format="EdgeList")


def same_directed(dg, jg):
    assert (dg.node_count(), dg.edge_count()) == (jg.node_count(),
                                                  jg.edge_count())
    for n in range(dg.node_count()):
        assert dg.out_degree(n) == jg.out_degree(n)
        assert dg.in_degree(n) == jg.in_degree(n)
        np.testing.assert_array_equal(dg.out_neighbors(n),
                                      jg.out_neighbors(n))
        np.testing.assert_array_equal(dg.in_neighbors(n), jg.in_neighbors(n))


def same_undirected(ug, jg):
    assert (ug.node_count(), ug.edge_count()) == (jg.node_count(),
                                                  jg.edge_count())
    for n in range(ug.node_count()):
        assert ug.degree(n) == jg.degree(n)
        np.testing.assert_array_equal(ug.neighbors(n), jg.neighbors(n))


# -- graph_test.py analogs -------------------------------------------------


def test_load_graph(g):
    dg, jg = g
    assert (dg.node_count(), dg.edge_count()) == (1 << SCALE, 16 << SCALE)
    same_directed(dg, jg)
    assert dg.device.type == "cpu"


def test_to_undirected(g, paths):
    (dg, jg), (ug, jug) = g, load_both(Graph, paths[0], layout="Sorted")
    same_undirected(ug, jug)
    undirected, jundirected = dg.to_undirected(), jg.to_undirected()
    same_undirected(undirected, jundirected)
    for n in range(undirected.node_count()):
        assert set(undirected.copy_neighbors(n)) == set(ug.copy_neighbors(n))


def test_to_undirected_with_layout():
    edges = np.array([[0, 1], [0, 1], [0, 2], [1, 2], [2, 1], [0, 3]],
                     dtype=np.uint32)
    dg, jg = DiGraph.from_numpy(edges, device="cpu"), JaxDiGraph.from_numpy(
        edges)
    same_undirected(dg.to_undirected(), jg.to_undirected())
    want = {"Sorted": [[1, 1, 2, 3], [0, 0, 2, 2], [0, 1, 1], [0]],
            "Deduplicated": [[1, 2, 3], [0, 2], [0, 1], [0]]}
    for layout, lists in want.items():
        u = dg.to_undirected(getattr(Layout, layout))
        same_undirected(u, jg.to_undirected(getattr(JaxLayout, layout)))
        assert [u.copy_neighbors(n) for n in range(4)] == lists


def test_reorder(paths):
    ug, jug = load_both(Graph, paths[0], layout="Sorted")
    degrees = sorted((ug.degree(n) for n in range(ug.node_count())),
                     reverse=True)
    before = ug.neighbors(0)
    ug.make_degree_ordered()
    jug.make_degree_ordered()
    assert [ug.degree(n) for n in range(ug.node_count())] == degrees
    same_undirected(ug, jug)
    assert not np.shares_memory(ug.neighbors(0), before)  # cache cleared


# -- ds_test.py analogs ----------------------------------------------------


def test_numpy_graph():
    el = np.array([[0, 1], [2, 3], [4, 1]], dtype=np.uint32)
    gr = Graph.from_numpy(el, layout=Layout.Sorted, device="cpu")
    same_undirected(gr, JaxGraph.from_numpy(el, layout=JaxLayout.Sorted))
    assert (gr.node_count(), gr.edge_count()) == (5, 3)
    assert np.array_equal(gr.neighbors(1), np.array([0, 4]))
    assert np.array_equal(gr.neighbors(3), np.array([2]))


def test_pandas_graph():
    import pandas as pd

    df = pd.DataFrame({"source": [0, 2, 4], "target": [1, 3, 1]})
    gr = Graph.from_pandas(df, layout=Layout.Sorted, device="cpu")
    same_undirected(gr, JaxGraph.from_pandas(df, layout=JaxLayout.Sorted))
    assert gr.node_count() == 5
    assert np.array_equal(gr.neighbors(1), np.array([0, 4]))
    dg = DiGraph.from_pandas(df, device="cpu")
    same_directed(dg, JaxDiGraph.from_pandas(df))


@pytest.mark.parametrize("cls", [Graph, DiGraph])
def test_from_numpy_bad_shape(cls):
    jcls = {Graph: JaxGraph, DiGraph: JaxDiGraph}[cls]
    for bad in (np.zeros((3, 3), np.uint32), np.zeros(4, np.uint32)):
        with pytest.raises(ValueError):
            jcls.from_numpy(bad)
        with pytest.raises(ValueError, match=r"\(m, 2\)"):
            cls.from_numpy(bad, device="cpu")


# -- numpy_neighbors_test.py analogs ---------------------------------------


def test_out_neighbors_zero_copy(g):
    dg, jg = g
    base = dg.out_neighbors(0).base
    for n in range(0, dg.node_count(), 17):
        nb = dg.out_neighbors(n)
        assert len(nb) == dg.out_degree(n)
        assert nb.base is base  # a view of the one cached host copy
        assert nb.tolist() == dg.copy_out_neighbors(n)
        assert dg.copy_out_neighbors(n) == jg.copy_out_neighbors(n)
        assert dg.copy_in_neighbors(n) == jg.copy_in_neighbors(n)


def test_neighbors_not_writeable(g):
    dg, _ = g
    for nb in (dg.out_neighbors(0), dg.in_neighbors(0),
               dg.out_neighbors(0).base):
        with pytest.raises(ValueError):
            nb[0] = 1


def test_neighbors_keep_alive(paths):
    gg = DiGraph.load(paths[0], layout=Layout.Sorted, device="cpu")
    jg = JaxDiGraph.load(paths[0], layout=JaxLayout.Sorted)
    node = int(np.argmax([gg.in_degree(n) for n in range(gg.node_count())]))
    degree = gg.in_degree(node)
    nb = gg.in_neighbors(node)
    del gg
    assert len(nb) == degree
    assert np.all((nb >= 0) & (nb < (1 << SCALE)))
    np.testing.assert_array_equal(nb, jg.in_neighbors(node))


# -- graph_edgelist_test.py analogs -----------------------------------------


def test_load_edge_list(el_g):
    dg, jg = el_g
    assert dg.node_count() == 64 and dg.edge_count() == 256
    same_directed(dg, jg)


def test_load_undirected_edge_list(el_ug):
    ug, jug = el_ug
    assert ug.node_count() == 64 and ug.edge_count() == 256
    same_undirected(ug, jug)


# -- page_rank_test.py analogs ----------------------------------------------


def same_page_rank(pr, jpr):
    assert pr.ran_iterations == jpr.ran_iterations
    scores = pr.scores()
    assert scores.dtype == np.float32 and scores is pr.scores()  # cached
    np.testing.assert_allclose(scores, jpr.scores(), rtol=0, atol=PR_ATOL)
    np.testing.assert_allclose(pr.error, jpr.error, rtol=1e-4)


def test_page_rank(g):
    dg, jg = g
    pr = dg.page_rank()
    same_page_rank(pr, jg.page_rank())
    assert pr.ran_iterations >= 1 and pr.error < 1.0 and pr.micros > 0
    scores = pr.scores()
    assert len(scores) == 1 << SCALE
    assert (scores > 0.0).all()


def test_pr_max_iterations(g):
    dg, jg = g
    pr = dg.page_rank(max_iterations=1)
    assert pr.ran_iterations == 1
    same_page_rank(pr, jg.page_rank(max_iterations=1))


def test_pr_damping_factor(g):
    dg, jg = g
    pr = dg.page_rank(damping_factor=0)
    assert pr.ran_iterations == 1
    np.testing.assert_allclose(pr.scores(), 1 / (1 << SCALE))
    same_page_rank(pr, jg.page_rank(damping_factor=0))


def test_config_must_be_kwargs(g, el_ug):
    for graph in (g[0], g[1], el_ug[0]):
        if hasattr(graph, "page_rank"):
            with pytest.raises(TypeError):
                graph.page_rank(42, 1.0, 0.1)
        with pytest.raises(TypeError):
            graph.wcc(42, 1.0, 0.1)
    with pytest.raises(TypeError):
        g[0].delta_stepping(0, 1.0)


# -- wcc_test.py analogs ----------------------------------------------------


def test_wcc(g, el_ug):
    for graph, jgraph in (g, el_ug):
        w = graph.wcc()
        assert w.micros > 0
        components = w.components()
        assert components is w.components()  # copied once
        assert len(components) == graph.node_count()
        assert ((components >= 0)
                & (components < graph.node_count())).all()
        np.testing.assert_array_equal(components,
                                      jgraph.wcc().components())


# -- triangle_count_test.py analogs ------------------------------------------


def test_triangle_count_golden(paths):
    # the mate flow: Sorted + make_degree_ordered -> the multiset count;
    # Deduplicated -> the distinct count
    u, ju = load_both(Graph, paths[0], layout="Sorted")
    u.make_degree_ordered()
    ju.make_degree_ordered()
    tc = u.global_triangle_count()
    assert tc.triangles == ju.global_triangle_count().triangles > 0
    assert tc.micros > 0
    d, jd = load_both(Graph, paths[0], layout="Deduplicated")
    distinct = d.global_triangle_count().triangles
    assert distinct == jd.global_triangle_count().triangles
    assert 0 < distinct < tc.triangles


def test_tc_two_components_numpy():
    edges = np.array([[0, 1], [1, 2], [2, 0], [3, 4], [4, 5], [5, 3]],
                     dtype=np.uint32)
    u = Graph.from_numpy(edges, layout=Layout.Deduplicated, device="cpu")
    ju = JaxGraph.from_numpy(edges, layout=JaxLayout.Deduplicated)
    assert (u.global_triangle_count().triangles
            == ju.global_triangle_count().triangles == 2)


# -- sssp (server-level parity; mate has no sssp) ----------------------------


def test_delta_stepping_api(paths):
    d, jd = load_both(DiGraph, paths[2], file_format="EdgeList")
    for start, delta in ((0, 2.0), (5, 0.5)):
        res = d.delta_stepping(start_node=start, delta=delta)
        dist = res.distances()
        assert dist.dtype == np.float32 and dist[start] == 0.0
        np.testing.assert_array_equal(
            dist, jd.delta_stepping(start_node=start, delta=delta).distances())


# -- the port's own: doctest, device rule, top-level names -------------------


def test_module_doctest():
    res = doctest.testmod(api, verbose=False, optionflags=doctest.ELLIPSIS)
    assert res.attempted > 0 and res.failed == 0


def test_no_device_and_no_card_raises(monkeypatch, paths):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges = np.array([[0, 1]], dtype=np.uint32)
    calls = [lambda: DiGraph.from_numpy(edges), lambda: Graph.from_numpy(edges),
             lambda: Graph.load(paths[0]), lambda: DiGraph.load(paths[0])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_top_level_names():
    assert set(graph_tpu.__all__) <= set(graph_tpu_torch.__all__)
    from graph_tpu_torch.engine.plan import build_plan

    assert graph_tpu_torch.build_plan is build_plan
