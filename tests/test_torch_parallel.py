"""The port's multi-device paths against graph_tpu's, on CPU meshes.

``graph_tpu`` runs on its 8-device virtual CPU mesh (tests/conftest.py),
its row-block engines' Pallas kernels in interpret mode; the port runs
on ``Mesh([torch.device("cpu")] * 8)`` (``* 4`` where graph_tpu's test
uses ``make_mesh(4)``), one process driving a list of per-shard tensors.
Each test of tests/test_distributed.py has a counterpart here.

Tolerances: the collectives, the halo, the sharded engines' ops and the
WCC, SSSP and triangle results are held exactly; PageRank to the same
iteration count and 1e-6 (its residual is an f32 psum); the ring to the
blocking exchange bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import graph_tpu as jgt
from graph_tpu.engine.shard import RowBlockEdgeEngine as JaxRowBlock
from graph_tpu.engine.shard import ShardedEdgeEngine as JaxSharded
from graph_tpu.graph.build import build_directed as jax_build_directed
from graph_tpu.graph.build import build_undirected as jax_build_undirected
from graph_tpu.parallel import halo as jax_halo
from graph_tpu.parallel import pagerank as jpp
from graph_tpu.parallel import sssp as jps
from graph_tpu.parallel import tc as jptc
from graph_tpu.parallel import wcc as jpw
from graph_tpu.parallel.mesh import make_mesh as jax_make_mesh

import graph_tpu_torch as gtt
from graph_tpu_torch.engine import engine as engine_mod
from graph_tpu_torch.engine.engine import EdgeEngine
from graph_tpu_torch.engine.shard import RowBlockEdgeEngine, ShardedEdgeEngine
from graph_tpu_torch.generate import host_rmat, uniform_edge_list
from graph_tpu_torch.parallel import collectives as coll
from graph_tpu_torch.parallel import halo as tpu_halo
from graph_tpu_torch.parallel import mesh as tmesh
from graph_tpu_torch.parallel import pagerank as tpp
from graph_tpu_torch.parallel import sssp as tps
from graph_tpu_torch.parallel import tc as tptc
from graph_tpu_torch.parallel import wcc as tpw
from graph_tpu_torch.parallel.mesh import Mesh, mesh_key, use_mesh

CPU = torch.device("cpu")


def cpu_mesh(k):
    return Mesh([CPU] * k)


@pytest.fixture(scope="module")
def meshes():
    return {"jax8": jax_make_mesh(8), "jax4": jax_make_mesh(4)}


def _pair(src, dst, n, w=None):
    """The same edges as a graph_tpu graph and a port graph (CPU)."""
    jw = None if w is None else jnp.asarray(w)
    jg = jax_build_directed(jnp.asarray(src), jnp.asarray(dst), jw,
                            node_count=n)
    tg = gtt.build_directed(src, dst, w, node_count=n, device="cpu")
    return jg, tg


@pytest.fixture(scope="module")
def graph():
    """tests/test_distributed.py's graph: 500 nodes, 5000 uniform edges."""
    src, dst = uniform_edge_list(500, 5000, seed=3)
    return _pair(src, dst, 500)


def _weighted(seed, n, m, scale):
    g = np.random.default_rng(seed)
    src = g.integers(0, n, m)
    dst = g.integers(0, n, m)
    w = (g.random(m) * scale).astype(np.float32)
    return _pair(src, dst, n, w)


# ---------------------------------------------------------------------------
# mesh and collectives


def test_mesh_and_make_mesh_without_card(monkeypatch):
    m = cpu_mesh(3)
    assert m.size == 3 and m.shape == {"nodes": 3}
    assert m.axis_names == ("nodes",) and m.devices == (CPU,) * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="none is available"):
        tmesh.make_mesh(1)


def _jax_collective(fn, x, mesh):
    """``fn`` of each shard's block under shard_map, blocks stacked."""
    return np.asarray(jax.jit(shard_map(
        lambda b: fn(b[0])[None], mesh=mesh, in_specs=P("nodes"),
        out_specs=P("nodes"), check_vma=False))(jnp.asarray(x)))


COLLECTIVES = {
    "psum": (lambda b: jax.lax.psum(b, "nodes"), coll.psum),
    "pmin": (lambda b: jax.lax.pmin(b, "nodes"), coll.pmin),
    "all_gather": (lambda b: jax.lax.all_gather(b, "nodes", tiled=True),
                   coll.all_gather),
    "all_to_all": (lambda b: jax.lax.all_to_all(
        b, "nodes", split_axis=0, concat_axis=0, tiled=True),
        lambda xs: coll.all_to_all(xs, 0, 0, tiled=True)),
    "ppermute_ring": (lambda b: jax.lax.ppermute(
        b, "nodes", [(p, (p + 3) % 8) for p in range(8)]),
        lambda xs: coll.ppermute(xs, [(p, (p + 3) % 8) for p in range(8)])),
    "ppermute_partial": (lambda b: jax.lax.ppermute(
        b, "nodes", [(0, 5), (5, 2), (7, 0)]),
        lambda xs: coll.ppermute(xs, [(0, 5), (5, 2), (7, 0)])),
}


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_matches_jax_lax(name, dtype, meshes):
    rng = np.random.default_rng(sorted(COLLECTIVES).index(name))
    if dtype == "int32":
        x = rng.integers(-2**30, 2**30, (8, 16, 3)).astype(np.int32)
    else:
        x = (rng.standard_normal((8, 16, 3)) * 10.0 ** rng.integers(
            -6, 6, (8, 16, 3))).astype(np.float32)
    jfn, tfn = COLLECTIVES[name]
    want = _jax_collective(jfn, x, meshes["jax8"])
    got = np.stack([o.numpy() for o in tfn(
        [torch.from_numpy(b) for b in x])])
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_collectives_refuse_what_they_do_not_model():
    with pytest.raises(ValueError, match="tiled"):
        coll.all_to_all([torch.zeros(2)] * 2, tiled=False)
    with pytest.raises(ValueError, match="tiled"):
        coll.all_gather([torch.zeros(2)] * 2, tiled=False)
    with pytest.raises(ValueError, match="split"):
        coll.all_to_all([torch.zeros(3)] * 2)
    with pytest.raises(ValueError, match="twice"):
        coll.ppermute([torch.zeros(2)] * 2, [(0, 1), (1, 1)])


# ---------------------------------------------------------------------------
# the halo


def _halo_input(seed, P_, rows_per, m, dtype):
    g = np.random.default_rng(seed)
    counts = g.integers(0, m, P_)
    counts[seed % P_] = 0  # a shard without edges
    tgt = np.zeros((P_, max(int(counts.max()), 1)), dtype)
    for p in range(P_):
        # skewed sources: most from low ids, some from every owner
        tgt[p, : counts[p]] = np.minimum(
            (g.pareto(1.5, counts[p]) * rows_per).astype(np.int64),
            P_ * rows_per - 1)
    return tgt, counts


@pytest.mark.parametrize("P_,rows_per,m,dtype", [
    (8, 63, 400, np.int32), (4, 250, 3000, np.int64), (3, 1, 10, np.int32)])
def test_build_halo_matches_graph_tpu(P_, rows_per, m, dtype):
    tgt, counts = _halo_input(P_ + m, P_, rows_per, m, dtype)
    want = jax_halo.build_halo(tgt, counts, rows_per)
    got = tpu_halo.build_halo(torch.from_numpy(tgt), counts, rows_per)
    assert got.H == want.H
    assert (got.halo_bytes, got.gather_bytes) == (want.halo_bytes,
                                                  want.gather_bytes)
    for name in ("send_idx", "tgt_remap"):
        a, b = getattr(got, name).numpy(), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_halo_volume_below_all_gather():
    """tests/test_distributed.py's partition-unfriendly random graph: the
    ragged halo moves fewer padded bytes than the all_gather."""
    n, m = 1 << 13, 1 << 15
    g = np.random.default_rng(9)
    src, dst = g.integers(0, n, m), g.integers(0, n, m)
    jg, tg = _pair(src, dst, n)
    sg = tpp.shard_graph(tg, cpu_mesh(8))
    jsg = jpp.shard_graph(jg, jax_make_mesh(8))
    assert (sg.halo_bytes, sg.gather_bytes) == (jsg.halo_bytes,
                                                jsg.gather_bytes)
    assert sg.halo_bytes < sg.gather_bytes, (sg.halo_bytes, sg.gather_bytes)


# ---------------------------------------------------------------------------
# the sharded engines


@pytest.fixture(scope="module")
def engine_edges():
    g = np.random.default_rng(31)
    n, m = 700, 4200
    src, dst = g.integers(0, n, m), g.integers(0, n, m)
    w = (g.random(m) * 4).astype(np.float32)
    # spmv inputs whose row sums stay below 2**-6: every f32 partial and
    # sum is then exact, so an edge split adds up to the single engine's
    x = (g.random(n) * 1e-4).astype(np.float32)
    labels = g.permutation(n).astype(np.int32)
    dist = (g.random(n) * 8).astype(np.float32)
    dist[g.random(n) < 0.2] = 3.0e38
    return src, dst, w, n, x, labels, dist


def _single(src, dst, n, w):
    return EdgeEngine.build(src, dst, n, values=w, device="cpu")


def test_sharded_edge_engine_matches_graph_tpu(engine_edges, meshes):
    src, dst, w, n, x, labels, dist = engine_edges
    jse = JaxSharded.build(src, dst, n, meshes["jax4"], values=w,
                           axis="nodes", interpret=True)
    tse = ShardedEdgeEngine.build(src, dst, n, cpu_mesh(4), values=w)
    one = _single(src, dst, n, w)
    for op, v in (("spmv", x), ("smin", dist), ("relax", dist)):
        want = np.asarray(getattr(jse, op)(jnp.asarray(v)))
        got = getattr(tse, op)(torch.from_numpy(v))
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32)), op
        assert torch.equal(got, getattr(one, op)(torch.from_numpy(v))), op


def test_rowblock_engine_matches_graph_tpu(engine_edges, meshes):
    src, dst, w, n, x, labels, dist = engine_edges
    jrb = JaxRowBlock.build(src, dst, n, meshes["jax8"], values=w,
                            axis="nodes", interpret=True)
    trb = RowBlockEdgeEngine.build(src, dst, n, cpu_mesh(8), values=w)
    assert (trb.rows_per, trb.halo_bytes, trb.gather_bytes) == (
        jrb.rows_per, jrb.halo_bytes, jrb.gather_bytes)
    one = _single(src, dst, n, w)
    for op, v in (("spmv", x), ("smin", dist), ("relax", dist),
                  ("smin_int", labels)):
        want = np.array(getattr(jrb, op)(jnp.asarray(v)))
        got = getattr(trb, op)(torch.from_numpy(v))
        assert got.dtype == torch.from_numpy(want).dtype, op
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32)), op
        assert torch.equal(got, getattr(one, op)(torch.from_numpy(v))), op
    # each shard's engine is a rectangular plan on its halo buffer
    for p, e in enumerate(trb.engines):
        assert e.plan.n == trb.rows_per and e.plan.n_src == 8 * (
            trb.halo_bytes // 32) and trb.local_dev(p) is e


# ---------------------------------------------------------------------------
# the sharded drivers (counterparts of tests/test_distributed.py)


@pytest.fixture(scope="module")
def pr_runs(graph, meshes):
    """graph_tpu's sharded PageRank on the fixture graph, computed once."""
    jg, _ = graph
    cfg = jgt.PageRankConfig(max_iterations=30, tolerance=1e-6)
    jsg = jpp.shard_graph(jg, meshes["jax8"])
    return {"single": jgt.page_rank(jg, cfg),
            "ring": jpp.page_rank_sharded(jsg, meshes["jax8"], cfg),
            "jsg": jsg}


def test_sharded_pagerank_matches_single(graph, pr_runs):
    _, tg = graph
    cfg = gtt.PageRankConfig(max_iterations=30, tolerance=1e-6)
    mesh = cpu_mesh(8)
    sg = tpp.shard_graph(tg, mesh)
    res = tpp.page_rank_sharded(sg, mesh, cfg)
    want = pr_runs["ring"]
    assert res.ran_iterations == want.ran_iterations
    np.testing.assert_allclose(res.scores_np(), want.scores_np(), atol=1e-6)
    single = gtt.page_rank(tg, cfg)
    assert res.ran_iterations == single.ran_iterations
    np.testing.assert_allclose(res.scores_np(), single.scores_np(),
                               atol=1e-6)
    np.testing.assert_allclose(res.scores_np(),
                               pr_runs["single"].scores_np(), atol=1e-6)
    # the shard layout is graph_tpu's, array for array (real prefixes)
    jsg = pr_runs["jsg"]
    for p in range(8):
        k = sg.in_targets[p].numel()
        assert np.array_equal(sg.in_targets[p].numpy(),
                              np.asarray(jsg.in_targets)[p, :k])
        for name in ("in_offsets", "send_idx", "ring_offsets", "ring_send"):
            assert np.array_equal(getattr(sg, name)[p].numpy(),
                                  np.asarray(getattr(jsg, name))[p]), name
        assert np.array_equal(sg.out_degrees[p].numpy(),
                              np.asarray(jsg.out_degrees)[p])
        for t in range(8):
            k = sg.ring_targets[p][t].numel()
            assert np.array_equal(sg.ring_targets[p][t].numpy(),
                                  np.asarray(jsg.ring_targets)[p, t, :k])


def test_sharded_pagerank_uneven_rows(meshes):
    # n = 501 is not divisible by 8: the padding path
    src, dst = uniform_edge_list(501, 3000, seed=5)
    jg, tg = _pair(src, dst, 501)
    jcfg = jgt.PageRankConfig(max_iterations=10, tolerance=0.0)
    cfg = gtt.PageRankConfig(max_iterations=10, tolerance=0.0)
    want = jpp.page_rank_sharded(jpp.shard_graph(jg, meshes["jax8"]),
                                 meshes["jax8"], jcfg)
    mesh = cpu_mesh(8)
    sg = tpp.shard_graph(tg, mesh)
    assert sg.rows_per_shard == 63 and sg.num_shards == 8
    res = tpp.page_rank_sharded(sg, mesh, cfg)
    assert res.scores.shape == (501,)
    assert res.ran_iterations == want.ran_iterations == 10
    np.testing.assert_allclose(res.scores_np(), want.scores_np(), atol=1e-6)
    np.testing.assert_allclose(res.scores_np(),
                               gtt.page_rank(tg, cfg).scores_np(), atol=1e-6)


def test_sharded_wcc_matches_single(graph, meshes):
    jg, tg = graph
    want = jpw.wcc_sharded(jpw.shard_hook_graph(jg, meshes["jax8"]),
                           meshes["jax8"])
    mesh = cpu_mesh(8)
    res = tpw.wcc_sharded(tpw.shard_hook_graph(tg, mesh), mesh)
    assert res.ran_iterations == want.ran_iterations
    np.testing.assert_array_equal(res.components_np(),
                                  want.components_np())
    np.testing.assert_array_equal(res.components_np(),
                                  gtt.wcc(tg).components_np())


def test_sharded_wcc_two_components(meshes):
    edges = np.array([(0, 1), (2, 3)])
    jg = jgt.GraphBuilder().edges([(0, 1), (2, 3)]).node_count(
        9).build_directed()
    tg = gtt.build_directed(edges[:, 0], edges[:, 1], node_count=9,
                            device="cpu")
    mesh = cpu_mesh(8)
    c = tpw.wcc_sharded(tpw.shard_hook_graph(tg, mesh), mesh).components_np()
    assert c[0] == c[1] and c[2] == c[3] and c[1] != c[2]
    want = jpw.wcc_sharded(jpw.shard_hook_graph(jg, meshes["jax8"]),
                           meshes["jax8"])
    np.testing.assert_array_equal(c, want.components_np())


def test_sssp_sharded_matches_single_device(meshes):
    jg, tg = _weighted(11, 600, 4000, 5)
    want = jps.sssp_sharded(jps.shard_weighted_graph(jg, meshes["jax4"]),
                            meshes["jax4"], jgt.DeltaSteppingConfig(0, 2.0))
    mesh = cpu_mesh(4)
    res = tps.sssp_sharded(tps.shard_weighted_graph(tg, mesh), mesh,
                           gtt.DeltaSteppingConfig(0, 2.0))
    assert np.array_equal(res.distances_np(), want.distances_np())
    single = gtt.delta_stepping(tg, gtt.DeltaSteppingConfig(
        0, 2.0, engine="xla"))
    assert np.array_equal(res.distances_np(), single.distances_np())
    with pytest.raises(ValueError, match="weighted"):
        tps.shard_weighted_graph(gtt.build_directed(
            [0], [1], node_count=2, device="cpu"), mesh)


@pytest.fixture(scope="module")
def route_graphs():
    """tests/test_distributed.py's default-mesh graph, and a DEDUPLICATED
    undirected graph for the triangle route."""
    jg, tg = _weighted(13, 500, 3000, 3)
    src, dst = host_rmat(8, seed=8)
    jug = jax_build_undirected(jnp.asarray(src), jnp.asarray(dst),
                               node_count=256,
                               layout=jgt.CsrLayout.DEDUPLICATED)
    tug = gtt.build_undirected(src, dst, node_count=256, device="cpu",
                               layout=gtt.CsrLayout.DEDUPLICATED)
    return jg, tg, jug, tug


def test_default_mesh_routes_algorithms(route_graphs, meshes):
    """page_rank/wcc/delta_stepping/global_triangle_count route through
    the sharded paths under a default mesh and match graph_tpu's routes
    and the port's single-device results."""
    jg, tg, jug, tug = route_graphs
    pr0 = gtt.page_rank(tg, gtt.PageRankConfig(engine="cumsum"))
    wc0 = gtt.wcc(tg)
    ss0 = gtt.delta_stepping(tg, gtt.DeltaSteppingConfig(0, 2.0,
                                                         engine="xla"))
    tc0 = gtt.global_triangle_count(tug)
    with jgt.parallel.use_mesh(meshes["jax4"]):
        jpr = jgt.page_rank(jg)
        jwc = jgt.wcc(jg)
        jss = jgt.delta_stepping(jg, jgt.DeltaSteppingConfig(0, 2.0))
        jtc = jgt.global_triangle_count(jug)
    with use_mesh(cpu_mesh(4)):
        pr1 = gtt.page_rank(tg)
        wc1 = gtt.wcc(tg)
        ss1 = gtt.delta_stepping(tg, gtt.DeltaSteppingConfig(0, 2.0))
        tc1 = gtt.global_triangle_count(tug)
    assert pr1.ran_iterations == jpr.ran_iterations
    np.testing.assert_allclose(pr1.scores_np(), jpr.scores_np(), atol=1e-6)
    np.testing.assert_allclose(pr0.scores_np(), pr1.scores_np(), atol=2e-7)
    assert wc1.components.dtype == wc0.components.dtype
    assert np.array_equal(wc1.components_np(), jwc.components_np())
    assert np.array_equal(wc0.components_np(), wc1.components_np())
    assert np.array_equal(ss1.distances_np(), jss.distances_np())
    assert np.array_equal(ss0.distances_np(), ss1.distances_np())
    assert tc1.triangles == int(jtc.triangles) == tc0.triangles > 0
    assert tc1.phases["shards"] == 4
    # the CPU mesh takes the segment-op shards, as graph_tpu's CPU tests
    assert not tmesh._rowblock_route(tg, cpu_mesh(4))


def test_api_reaches_the_mesh_routes(route_graphs, meshes):
    """The API's DiGraph runs the default-mesh routes through the
    algorithms, as graph_tpu's API does."""
    from graph_tpu import api as jax_api
    from graph_tpu_torch import api

    src, dst = uniform_edge_list(300, 2400, seed=17)
    arr = np.stack([src, dst], 1)
    with jgt.parallel.use_mesh(meshes["jax4"]):
        jd = jax_api.DiGraph.from_numpy(arr)
        want_pr, want_wcc = jd.page_rank(), jd.wcc()
    with use_mesh(cpu_mesh(4)):
        dg = api.DiGraph.from_numpy(arr, device="cpu")
        pr, wc = dg.page_rank(), dg.wcc()
    assert pr.ran_iterations == want_pr.ran_iterations
    np.testing.assert_allclose(pr.scores(), want_pr.scores(), atol=1e-6)
    np.testing.assert_array_equal(wc.components(), want_wcc.components())
    kinds = {k[1][0] for k in engine_mod._GRAPH_ENGINES
             if k[0] == id(dg._g) and isinstance(k[1], tuple)}
    assert kinds == {"sharded-pull", "sharded-hook"}


def test_rowblock_route_on_a_mesh_of_cards(route_graphs, monkeypatch):
    """Where the route picks the row-block engine (a mesh of cards from
    2**21 edges; forced here on the CPU mesh), the three algorithms run
    it, cached per (graph, mesh), with the single-device results."""
    _, tg, _, _ = route_graphs
    monkeypatch.setattr(tmesh, "_rowblock_route", lambda g, m: True)
    mesh = cpu_mesh(4)
    with use_mesh(mesh):
        pr = gtt.page_rank(tg, gtt.PageRankConfig(max_iterations=12,
                                                  tolerance=0.0))
        wc = gtt.wcc(tg)
        ss = gtt.delta_stepping(tg, gtt.DeltaSteppingConfig(0, 2.0))
    kinds = {k[1][0] for k in engine_mod._GRAPH_ENGINES
             if k[0] == id(tg) and isinstance(k[1], tuple)}
    assert {"rowblock", "rowblock-sym", "rowblock-w"} <= kinds
    single = gtt.page_rank(tg, gtt.PageRankConfig(
        engine="plan", max_iterations=12, tolerance=0.0))
    assert pr.ran_iterations == 12 and pr.host_reads == 1
    np.testing.assert_array_equal(pr.scores_np(), single.scores_np())
    np.testing.assert_array_equal(wc.components_np(),
                                  gtt.wcc(tg).components_np())
    np.testing.assert_array_equal(ss.distances_np(), gtt.delta_stepping(
        tg, gtt.DeltaSteppingConfig(0, 2.0)).distances_np())


def test_sharded_caches_are_reused(graph):
    """The counterpart of graph_tpu's memoized shard_map objects: under
    one mesh, a second run reuses each graph's shards (no new cache
    entry), and SSSP from two sources reuses one shard set."""
    _, tg = graph
    mesh = cpu_mesh(8)
    with use_mesh(mesh):
        gtt.page_rank(tg, gtt.PageRankConfig(max_iterations=5))
        gtt.wcc(tg)
        entries = dict(engine_mod._GRAPH_ENGINES)
        gtt.page_rank(tg, gtt.PageRankConfig(max_iterations=5))
        gtt.wcc(tg)
    assert engine_mod._GRAPH_ENGINES == entries
    _, wg = _weighted(5, 400, 2400, 3)
    with use_mesh(mesh):
        d0 = gtt.delta_stepping(wg, gtt.DeltaSteppingConfig(0, 2.0))
        n_entries = len(engine_mod._GRAPH_ENGINES)
        d7 = gtt.delta_stepping(wg, gtt.DeltaSteppingConfig(7, 2.0))
    assert len(engine_mod._GRAPH_ENGINES) == n_entries
    for s, d in ((0, d0), (7, d7)):
        assert np.array_equal(d.distances_np(), gtt.delta_stepping(
            wg, gtt.DeltaSteppingConfig(s, 2.0)).distances_np())


def test_engine_pin_skips_default_mesh(graph, monkeypatch):
    """An explicit engine (or device) wins over the installed mesh."""
    _, tg = graph

    def boom(*a, **k):
        raise AssertionError("meshed path taken despite engine pin")

    for name in ("page_rank_sharded", "page_rank_rowblock"):
        monkeypatch.setattr(tpp, name, boom)
    monkeypatch.setattr(tpw, "wcc_sharded", boom)
    monkeypatch.setattr(tps, "sssp_sharded", boom)
    monkeypatch.setattr(tptc, "triangle_count_sharded", boom)
    _, wg = _weighted(5, 400, 2400, 3)
    ug = gtt.build_undirected([0, 1, 2], [1, 2, 0], device="cpu",
                              layout=gtt.CsrLayout.DEDUPLICATED)
    with use_mesh(cpu_mesh(8)):
        res = gtt.page_rank(tg, gtt.PageRankConfig(engine="cumsum",
                                                   max_iterations=5))
        assert res.ran_iterations == 5
        gtt.wcc(tg, gtt.WccConfig(engine="xla"))
        gtt.wcc(tg, device="cpu")
        gtt.delta_stepping(wg, gtt.DeltaSteppingConfig(0, 2.0,
                                                       engine="plan"))
        assert gtt.global_triangle_count(ug, device="cpu").triangles == 1
        with pytest.raises(AssertionError, match="meshed"):
            gtt.page_rank(tg, gtt.PageRankConfig(max_iterations=5))
        with pytest.raises(AssertionError, match="meshed"):
            gtt.global_triangle_count(ug)
    # a one-shard mesh is no mesh
    with use_mesh(cpu_mesh(1)):
        assert gtt.page_rank(tg).host_reads >= 1


def test_mesh_key_stable_across_objects(graph):
    """Equal meshes share the per-graph shards even when the Mesh objects
    differ; a mesh of another size gets its own."""
    _, tg = graph
    m1, m2 = cpu_mesh(4), cpu_mesh(4)
    assert m1 is not m2 and mesh_key(m1) == mesh_key(m2)
    assert mesh_key(cpu_mesh(2)) != mesh_key(m1)
    with use_mesh(m1):
        gtt.page_rank(tg, gtt.PageRankConfig(max_iterations=3))
    n_entries = len(engine_mod._GRAPH_ENGINES)
    with use_mesh(m2):
        gtt.page_rank(tg, gtt.PageRankConfig(max_iterations=3))
    assert len(engine_mod._GRAPH_ENGINES) == n_entries
    with use_mesh(cpu_mesh(2)):
        gtt.page_rank(tg, gtt.PageRankConfig(max_iterations=3))
    assert len(engine_mod._GRAPH_ENGINES) == n_entries + 1


def test_rowblock_pagerank_matches_single(graph, meshes):
    """K1 and K2 on every shard behind the ragged halo: the same scores
    as the single-device plan engine, every iteration, and graph_tpu's
    row-block run within 1e-6."""
    jg, tg = graph
    jcfg = jgt.PageRankConfig(max_iterations=30, tolerance=1e-6)
    cfg = gtt.PageRankConfig(max_iterations=30, tolerance=1e-6)
    want = jpp.page_rank_rowblock(jpp.shard_graph_plan(
        jg, meshes["jax8"], interpret=True), jcfg)
    rbe = tpp.shard_graph_plan(tg, cpu_mesh(8))
    res = tpp.page_rank_rowblock(rbe, cfg)
    single = gtt.page_rank(tg, gtt.PageRankConfig(
        engine="plan", max_iterations=30, tolerance=1e-6))
    assert res.ran_iterations == want.ran_iterations == single.ran_iterations
    np.testing.assert_allclose(res.scores_np(), want.scores_np(), atol=1e-6)
    np.testing.assert_array_equal(res.scores_np(), single.scores_np())
    # the run's constants are kept per max_iterations
    again = tpp.page_rank_rowblock(rbe, cfg)
    assert rbe._pr_runs and len(rbe._pr_runs) == 1
    np.testing.assert_array_equal(again.scores_np(), res.scores_np())


def test_rowblock_wcc_sssp_match_single(meshes):
    jg, tg = _weighted(21, 700, 4200, 4)
    mesh = cpu_mesh(8)
    want_w = jpw.wcc_rowblock(jpw.shard_hook_graph_plan(
        jg, meshes["jax8"], interpret=True))
    res_w = tpw.wcc_rowblock(tpw.shard_hook_graph_plan(tg, mesh))
    assert res_w.ran_iterations == want_w.ran_iterations
    np.testing.assert_array_equal(res_w.components_np(),
                                  want_w.components_np())
    np.testing.assert_array_equal(res_w.components_np(),
                                  gtt.wcc(tg).components_np())
    cfg = gtt.DeltaSteppingConfig(0, 2.0)
    want_s = jps.sssp_rowblock(jps.shard_weighted_graph_plan(
        jg, meshes["jax8"], interpret=True), jgt.DeltaSteppingConfig(0, 2.0))
    res_s = tps.sssp_rowblock(tps.shard_weighted_graph_plan(tg, mesh), cfg)
    np.testing.assert_array_equal(res_s.distances_np(),
                                  want_s.distances_np())
    single = gtt.delta_stepping(tg, cfg)
    np.testing.assert_array_equal(res_s.distances_np(),
                                  single.distances_np())
    assert res_s.ran_iterations == single.ran_iterations


def test_ring_halo_bitmatches_blocking_exchange(graph):
    """The ppermute ring (per-owner-group partial sums in int32 quanta)
    gives the blocking exchange's bits, and both stay within 1e-6 of the
    single-device result."""
    _, tg = graph
    cfg = gtt.PageRankConfig(max_iterations=12, tolerance=1e-7)
    mesh = cpu_mesh(8)
    sg = tpp.shard_graph(tg, mesh)
    assert sg.ring_targets is not None
    ring = tpp.page_rank_sharded(sg, mesh, cfg, ring=True)
    blocking = tpp.page_rank_sharded(sg, mesh, cfg, ring=False)
    np.testing.assert_array_equal(ring.scores_np(), blocking.scores_np())
    assert ring.ran_iterations == blocking.ran_iterations
    assert ring.error == blocking.error
    np.testing.assert_allclose(ring.scores_np(),
                               gtt.page_rank(tg, cfg).scores_np(), atol=1e-6)


def test_wcc_jump_every_matches(graph, meshes):
    """Amortized pointer jumping converges to the same components in
    graph_tpu's round counts, on both sharded WCCs."""
    jg, tg = graph
    mesh = cpu_mesh(8)
    hg = tpw.shard_hook_graph(tg, mesh)
    jhg = jpw.shard_hook_graph(jg, meshes["jax8"])
    every = tpw.wcc_sharded(hg, mesh)
    amortized = tpw.wcc_sharded(hg, mesh, jump_every=3)
    want = jpw.wcc_sharded(jhg, meshes["jax8"], jump_every=3)
    np.testing.assert_array_equal(amortized.components_np(),
                                  every.components_np())
    assert amortized.ran_iterations == want.ran_iterations
    assert amortized.ran_iterations >= every.ran_iterations
    rb = tpw.wcc_rowblock(tpw.shard_hook_graph_plan(tg, mesh), jump_every=3)
    np.testing.assert_array_equal(rb.components_np(), every.components_np())


@pytest.mark.parametrize("layout", ["SORTED", "DEDUPLICATED"])
def test_sharded_triangle_count_matches_single(layout, meshes):
    """Row blocks of the wedge chunks on 8 shards count what one device
    and graph_tpu's sharded count do, on a scale-8 RMAT graph built in
    the test (the scale-8 fixture file is missing); SORTED is the
    reference's multiset, relabeled by degree as its golden test does."""
    src, dst = host_rmat(8, seed=42)
    jlay = getattr(jgt.CsrLayout, layout)
    jug = jax_build_undirected(jnp.asarray(src), jnp.asarray(dst),
                               node_count=256, layout=jlay)
    tug = gtt.build_undirected(src, dst, node_count=256, device="cpu",
                               layout=getattr(gtt.CsrLayout, layout))
    if layout == "SORTED":
        from graph_tpu.graph.ops import make_degree_ordered

        jug, tug = make_degree_ordered(jug), gtt.make_degree_ordered(tug)
    want = jptc.triangle_count_sharded(jug, meshes["jax8"]).triangles
    res = tptc.triangle_count_sharded(tug, cpu_mesh(8))
    single = gtt.global_triangle_count(tug).triangles
    assert res.triangles == int(want) == single > 0
    assert res.phases["shards"] == 8 and res.phases["slabs"] >= 8
    with use_mesh(cpu_mesh(8)):
        assert gtt.global_triangle_count(tug).triangles == single
    with pytest.raises(ValueError, match="SORTED"):
        tptc.triangle_count_sharded(gtt.build_undirected(
            src, dst, node_count=256, device="cpu"), cpu_mesh(2))


def test_graft_entry_dry_run():
    """``__graft_entry__.dryrun_multichip``'s sequence through the port's
    names, on an 8-shard CPU mesh."""
    mesh = cpu_mesh(8)
    n = 1 << 8
    src, dst = uniform_edge_list(n, 16 * n, seed=7)
    g = gtt.build_directed(src, dst, node_count=n, device="cpu")

    sg = tpp.shard_graph(g, mesh)
    res = tpp.page_rank_sharded(sg, mesh, gtt.PageRankConfig(
        max_iterations=3))
    assert res.scores.shape == (n,) and res.ran_iterations >= 1
    np.testing.assert_allclose(float(res.scores.sum()), 1.0, atol=0.2)
    assert sg.halo_bytes <= sg.gather_bytes
    w = tpw.wcc_sharded(tpw.shard_hook_graph(g, mesh), mesh)
    assert w.components.shape == (n,)

    ws, wd = uniform_edge_list(n, 8 * n, seed=3)
    wv = np.random.default_rng(4).random(8 * n).astype(np.float32) * 3
    gw = gtt.build_directed(ws, wd, wv, node_count=n, device="cpu")
    sd = tps.sssp_sharded(tps.shard_weighted_graph(gw, mesh), mesh,
                          gtt.DeltaSteppingConfig(0, 2.0))
    assert sd.distances.shape == (n,)

    with use_mesh(mesh):
        r2 = gtt.page_rank(g, gtt.PageRankConfig(max_iterations=3))
    np.testing.assert_allclose(r2.scores_np(), res.scores_np(), atol=1e-7)

    rng = np.random.default_rng(0)
    n2, m2 = 1500, 6000
    s2, d2 = rng.integers(0, n2, m2), rng.integers(0, n2, m2)
    se = ShardedEdgeEngine.build(s2, d2, n2, mesh, axis=mesh.axis_names[0])
    x = rng.random(n2).astype(np.float32) * 1e-4
    y = se.spmv(torch.from_numpy(x)).numpy()
    y_exp = np.zeros(n2)
    np.add.at(y_exp, d2, x[s2].astype(np.float64))
    np.testing.assert_allclose(y, y_exp, atol=1e-6)

    rb = tpp.page_rank_rowblock(tpp.shard_graph_plan(g, mesh),
                                gtt.PageRankConfig(max_iterations=3))
    np.testing.assert_allclose(rb.scores_np(), res.scores_np(), atol=1e-6)
    wr = tpw.wcc_rowblock(tpw.shard_hook_graph_plan(g, mesh))
    np.testing.assert_array_equal(wr.components_np(), w.components_np())
    sr = tps.sssp_rowblock(tps.shard_weighted_graph_plan(gw, mesh),
                           gtt.DeltaSteppingConfig(0, 2.0))
    np.testing.assert_array_equal(sr.distances_np(), sd.distances_np())

    tn = 1 << 8
    ts, td = uniform_edge_list(tn, 8 * tn, seed=5)
    ug = gtt.build_undirected(ts, td, node_count=tn, device="cpu",
                              layout=gtt.CsrLayout.DEDUPLICATED)
    assert tptc.triangle_count_sharded(ug, mesh).triangles == \
        gtt.global_triangle_count(ug).triangles
