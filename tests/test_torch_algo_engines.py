"""The port's segment-op engines against graph_tpu's, on the same inputs.

PageRank ``"cumsum"`` and ``"scatter"``, WCC ``"xla"`` and SSSP ``"xla"``
and ``"frontier"`` run in ``graph_tpu`` on the CPU (XLA, no Pallas
kernel) and in the port on the CPU.  Expected agreement:

* PageRank ``"cumsum"``: the int32 quanta make the sums exact, and both
  packages apply ``base + d*y`` with one rounding (XLA contracts it to a
  fused multiply-add; the port asks for one): scores bit-equal, to
  ``graph_tpu``'s and to the port's plan path; iterations equal; the L1
  error (an f32 sum in each library's order) within 1e-6.
* PageRank ``"scatter"``: f32 sums in each library's order: 1e-6.
* WCC labels and rounds, and SSSP distances: equal.
"""

import importlib
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_tpu_torch as gtt
from graph_tpu import PageRankConfig as JaxPrConfig
from graph_tpu import page_rank as jax_page_rank
from graph_tpu.algos import pagerank as jpr
from graph_tpu.algos.sssp import DeltaSteppingConfig as JaxSsspConfig
from graph_tpu.algos.sssp import delta_stepping as jax_delta_stepping
from graph_tpu.algos.wcc import WccConfig as JaxWccConfig
from graph_tpu.algos.wcc import wcc as jax_wcc
from graph_tpu.graph.build import build_directed as jax_build_directed
from graph_tpu.graph.build import build_undirected as jax_build_undirected
from graph_tpu_torch.algos import pagerank, sssp
from graph_tpu_torch.generate import host_rmat

# the package rebinds the name ``wcc`` to the function
wcc = importlib.import_module("graph_tpu_torch.algos.wcc")

WIKI_EDGES = [
    (1, 2), (2, 1), (4, 0), (4, 1), (5, 4), (5, 1), (5, 6), (6, 1),
    (6, 5), (7, 1), (7, 5), (8, 1), (8, 5), (9, 1), (9, 5), (10, 1),
    (10, 5), (11, 5), (12, 5),
]
#: The reference README's wiki graph after 10 Gauss-Seidel iterations
#: (tests/test_pagerank.py): the golden page_rank_reference reproduces.
WIKI_EXPECTED = np.array(
    [0.024064068, 0.3145448, 0.27890152, 0.01153846, 0.029471997,
     0.06329483, 0.029471997, 0.01153846, 0.01153846, 0.01153846,
     0.01153846, 0.01153846, 0.01153846], dtype=np.float32)
SSSP_GOLDEN = [0.0, 4.0, 2.0, 9.0, 5.0, 20.0]


def _wiki():
    e = np.array(WIKI_EDGES)
    return e[:, 0], e[:, 1], 13


def _rmat(scale, seed):
    src, dst = host_rmat(scale, seed=seed)
    return src, dst, 1 << scale


def _multigraph():
    """Duplicate edges, self-loops, dangling and isolated nodes."""
    g = np.random.default_rng(4)
    src, dst = g.integers(0, 150, 600), g.integers(0, 150, 600)
    src = np.concatenate([src, src[:100], np.arange(0, 150, 3)])
    dst = np.concatenate([dst, dst[:100], np.arange(0, 150, 3)])
    return src, dst, 200


GRAPHS = {"wiki": _wiki, "rmat10": lambda: _rmat(10, 3),
          "multigraph": _multigraph}


def _pair(src, dst, n, values=None):
    """The same directed graph in both packages."""
    jg = jax_build_directed(
        jnp.asarray(src.astype(np.int32)), jnp.asarray(dst.astype(np.int32)),
        values=None if values is None else jnp.asarray(values),
        node_count=n)
    tg = gtt.build_directed(src, dst, values, node_count=n, device="cpu")
    return jg, tg


# --------------------------------------------------------------- PageRank


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("cfg", [{"tolerance": 0.0}, {},
                                 {"max_iterations": 100, "tolerance": 1e-6,
                                  "damping_factor": 0.6}],
                         ids=["tol0", "default", "converge"])
def test_cumsum_bit_equal_to_graph_tpu_and_plan(graph, cfg):
    jg, tg = _pair(*GRAPHS[graph]())
    want = jax_page_rank(jg, JaxPrConfig(engine="cumsum", **cfg))
    got = gtt.page_rank(tg, gtt.PageRankConfig(engine="cumsum", **cfg))
    plan = gtt.page_rank(tg, gtt.PageRankConfig(engine="plan", **cfg))
    assert got.ran_iterations == want.ran_iterations == plan.ran_iterations
    np.testing.assert_array_equal(got.scores_np(), want.scores_np())
    np.testing.assert_array_equal(got.scores_np(), plan.scores_np())
    assert abs(got.error - want.error) <= 1e-6
    assert got.host_reads == (1 if cfg.get("tolerance", 1e-4) <= 0
                              else got.ran_iterations)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_scatter_within_1e6_of_graph_tpu(graph):
    jg, tg = _pair(*GRAPHS[graph]())
    cfg = {"max_iterations": 30, "tolerance": 1e-6}
    want = jax_page_rank(jg, JaxPrConfig(engine="scatter", **cfg))
    got = gtt.page_rank(tg, gtt.PageRankConfig(engine="scatter", **cfg))
    assert got.ran_iterations == want.ran_iterations
    # on the CPU both add in index order: the same bits
    np.testing.assert_array_equal(got.scores_np(), want.scores_np())


def test_page_rank_device_entry_matches_graph_tpu():
    """``_page_rank_device`` on bare in-CSR arrays, as graph_tpu's."""
    jg, tg = _pair(*_rmat(9, 7))
    arrays = [np.array(a) for a in (jg.csr_in.sources, jg.csr_in.targets,
                                    jg.csr_in.offsets, jg.out_degrees())]
    for engine in ("cumsum", "scatter"):
        js, jit, jerr = jpr._page_rank_device(
            *[jnp.asarray(a) for a in arrays], max_iterations=12,
            tolerance=jnp.float32(1e-9), damping_factor=jnp.float32(0.85),
            engine=engine)
        ts, tit, terr, reads = pagerank._page_rank_device(
            *[torch.from_numpy(a) for a in arrays], max_iterations=12,
            tolerance=1e-9, damping_factor=0.85, engine=engine)
        assert tit == int(jit) == reads
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="cumsum"):
        pagerank._page_rank_device(
            *[torch.from_numpy(a) for a in arrays], max_iterations=1,
            tolerance=0.0, damping_factor=0.85, engine="plan")


def test_page_rank_reference_matches_graph_tpu_and_golden():
    src, dst, n = _wiki()
    out = [[] for _ in range(n)]
    for s, t in zip(src, dst):
        out[s].append(t)
    cfg = gtt.PageRankConfig(max_iterations=10)
    scores, iters, err = gtt.page_rank_reference(out, n, cfg)
    np.testing.assert_array_equal(scores, WIKI_EXPECTED)
    want = jpr.page_rank_reference(out, n, JaxPrConfig(max_iterations=10))
    np.testing.assert_array_equal(scores, want[0])
    assert (iters, err) == (want[1], want[2]) and iters == 10
    src, dst, n = _multigraph()
    out = [[] for _ in range(n)]
    for s, t in zip(src, dst):
        out[s].append(t)
    cfg = gtt.PageRankConfig(max_iterations=50, tolerance=1e-6)
    got = gtt.page_rank_reference(out, n, cfg)
    want = jpr.page_rank_reference(
        out, n, JaxPrConfig(max_iterations=50, tolerance=1e-6))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("engine", ["plan", "cumsum", "scatter"])
def test_log_progress_scores_and_lines(engine, caplog):
    """``log_progress`` logs one line per iteration, worded as graph_tpu
    words it, reads the residual each iteration, and keeps the scores."""
    _, tg = _pair(*GRAPHS["rmat10"]())
    cfg = {"max_iterations": 7, "tolerance": 0.0, "engine": engine}
    quiet = gtt.page_rank(tg, gtt.PageRankConfig(**cfg))
    with caplog.at_level(logging.INFO, logger=pagerank.__name__):
        logged = gtt.page_rank(tg, gtt.PageRankConfig(log_progress=True,
                                                      **cfg))
    np.testing.assert_array_equal(logged.scores_np(), quiet.scores_np())
    assert logged.ran_iterations == 7 and logged.host_reads == 7
    assert quiet.host_reads == 1
    lines = [r.getMessage() for r in caplog.records
             if r.name == pagerank.__name__]
    assert len(lines) == 7
    for i, line in enumerate(lines, 1):
        assert line.startswith(f"PageRank iteration {i} finished with an "
                               "error of ")
    assert f"{logged.error:.3e}" in lines[-1]


def test_auto_engine_choices(monkeypatch):
    """``"auto"``, as the card's timings decided it (PERF.md): the plan
    engine for PageRank, WCC and SSSP on every graph, small or large."""
    calls = []
    real_run = pagerank._run
    monkeypatch.setattr(pagerank, "_run", lambda g, c, engine, log: (
        calls.append(f"page_rank_{engine}"), real_run(g, c, engine, log))[1])
    for mod, name in ((wcc, "_wcc_plan"), (wcc, "_wcc_xla"),
                      (sssp, "_sssp_plan")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    for make in (_wiki, lambda: _rmat(10, 3), lambda: _rmat(13, 3)):
        src, dst, n = make()
        w = np.ones(src.size, np.float32)
        g = gtt.build_directed(src, dst, w, node_count=n, device="cpu")
        gtt.page_rank(g)
        gtt.wcc(g)
        gtt.delta_stepping(g, gtt.DeltaSteppingConfig(int(src[0]), 1.0))
    assert calls == ["page_rank_plan", "_wcc_plan", "_sssp_plan"] * 3


# -------------------------------------------------------------------- WCC


def _chain():
    """A path whose labels need several pointer-jump rounds."""
    n = 300
    perm = np.random.default_rng(2).permutation(n)
    return perm[:-1], perm[1:], n


def _sparse():
    g = np.random.default_rng(21)
    return g.integers(0, 1000, 200), g.integers(0, 1000, 200), 1000


WCC_GRAPHS = {"rmat10": lambda: _rmat(10, 5), "chain": _chain,
              "sparse": _sparse}


@pytest.mark.parametrize("graph", sorted(WCC_GRAPHS))
@pytest.mark.parametrize("undirected", [False, True],
                         ids=["directed", "undirected"])
def test_wcc_xla_matches_graph_tpu(graph, undirected):
    src, dst, n = WCC_GRAPHS[graph]()
    if undirected:
        jg = jax_build_undirected(jnp.asarray(src), jnp.asarray(dst),
                                  node_count=n)
        tg = gtt.build_undirected(src, dst, node_count=n, device="cpu")
    else:
        jg, tg = _pair(src, dst, n)
    want = jax_wcc(jg, JaxWccConfig(engine="xla"))
    got = gtt.wcc(tg, gtt.WccConfig(engine="xla"))
    labels = got.components_np()
    assert labels.dtype == np.asarray(want.components).dtype
    np.testing.assert_array_equal(labels, np.asarray(want.components))
    assert got.ran_iterations == want.ran_iterations == got.host_reads
    plan = gtt.wcc(tg, gtt.WccConfig(engine="plan"))
    np.testing.assert_array_equal(labels, plan.components_np())
    assert plan.ran_iterations == want.ran_iterations


def test_wcc_xla_runs_a_host_graph_where_asked():
    src, dst, n = _sparse()
    hg = gtt.build_undirected_host(src, dst, node_count=n)
    got = gtt.wcc(hg, gtt.WccConfig(engine="xla"), device="cpu")
    assert got.components.device.type == "cpu"
    want = gtt.wcc(gtt.build_undirected(src, dst, node_count=n,
                                        device="cpu"))
    np.testing.assert_array_equal(got.components_np(), want.components_np())


# ------------------------------------------------------------------- SSSP


def _golden():
    e = np.array([(0, 1, 4.0), (0, 2, 2.0), (1, 2, 5.0), (1, 3, 10.0),
                  (2, 4, 3.0), (3, 5, 11.0), (4, 3, 4.0)])
    return (e[:, 0].astype(np.int64), e[:, 1].astype(np.int64),
            e[:, 2].astype(np.float32), 6)


def _grid(side=64):
    """bench.py's grid (side 1024 there): 4-neighbour, both directions,
    weights uniform in [0.1, 4.0) from default_rng(9)."""
    gn = side * side
    ii = np.arange(gn, dtype=np.int64)
    right = ii[ii % side != side - 1]
    down = ii[ii < gn - side]
    src = np.concatenate([right, right + 1, down, down + side])
    dst = np.concatenate([right + 1, right, down + side, down])
    w = np.random.default_rng(9).uniform(0.1, 4.0, src.size).astype(
        np.float32)
    return src, dst, w, gn


def _rmat_weighted():
    src, dst, n = _rmat(10, 5)
    return src, dst, (np.random.default_rng(3).random(src.size) * 4).astype(
        np.float32), n


SSSP_GRAPHS = {"golden": (_golden, 0, 3.0), "grid64": (_grid, 0, 2.0),
               "rmat10": (_rmat_weighted, "hub", 3.0),
               "rmat10_small_delta": (_rmat_weighted, "hub", 0.25)}


@pytest.mark.parametrize("graph", sorted(SSSP_GRAPHS))
@pytest.mark.parametrize("engine", ["xla", "frontier"])
def test_sssp_engines_bit_equal_to_graph_tpu(graph, engine):
    make, start, delta = SSSP_GRAPHS[graph]
    src, dst, w, n = make()
    if start == "hub":
        start = int(np.bincount(src).argmax())
    jg, tg = _pair(src, dst, n, w)
    want = jax_delta_stepping(jg, JaxSsspConfig(start, delta, engine=engine))
    got = gtt.delta_stepping(tg, gtt.DeltaSteppingConfig(start, delta,
                                                         engine=engine))
    d = got.distances_np()
    assert d.dtype == np.float32
    np.testing.assert_array_equal(d, np.asarray(want.distances))
    plan = gtt.delta_stepping(tg, gtt.DeltaSteppingConfig(start, delta,
                                                          engine="plan"))
    np.testing.assert_array_equal(d, plan.distances_np())
    if graph == "golden":
        assert d.tolist() == SSSP_GOLDEN
    assert got.ran_iterations >= 1
    assert got.host_reads > got.ran_iterations


def test_frontier_cap_and_degree_guard(monkeypatch):
    """A frontier larger than the cap is taken in several steps, with the
    same distances; a padded adjacency past 2**31 slots is refused."""
    src, dst, w, n = _grid(32)
    g = gtt.build_directed(src, dst, w, node_count=n, device="cpu")
    cfg = gtt.DeltaSteppingConfig(0, 1000.0, engine="frontier")
    wide = gtt.delta_stepping(g, cfg)
    monkeypatch.setattr(sssp, "_FRONTIER_CAP", 7)
    narrow = gtt.delta_stepping(g, cfg)
    np.testing.assert_array_equal(narrow.distances_np(), wide.distances_np())
    assert narrow.ran_iterations > wide.ran_iterations
    g2 = gtt.build_directed(src, dst, w, node_count=n, device="cpu")
    monkeypatch.setattr(sssp, "_max_out_degree", lambda g: 1 << 30)
    with pytest.raises(ValueError, match="2\\^31"):
        gtt.delta_stepping(g2, cfg)


def test_sssp_errors():
    src, dst, w, n = _golden()
    g = gtt.build_directed(src, dst, w, node_count=n, device="cpu")
    for engine in ("xla", "frontier", "plan"):
        with pytest.raises(ValueError, match="start_node"):
            gtt.delta_stepping(g, gtt.DeltaSteppingConfig(6, 1.0,
                                                          engine=engine))
    with pytest.raises(ValueError, match="unknown SSSP engine"):
        gtt.delta_stepping(g, gtt.DeltaSteppingConfig(0, 1.0, engine="bf"))
