"""The port's PageRank against graph_tpu's plan-engine PageRank.

Both run the plan path on the same edges: graph_tpu with an interpret-
mode EdgeEngine placed in its per-graph engine cache (as
tests/test_pagerank.py does), the port on the CPU.  spmv agrees bit for
bit, and the port computes the score update as XLA compiles
``graph_tpu``'s (one rounding for ``base + d*y``; ``(1-d)/n`` as a
product with the reciprocal of n), so the scores and the iteration count
are equal; the L1 error, an f32 sum in each library's order, is held to
1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import graph_tpu_torch as gtt
from graph_tpu import PageRankConfig as JaxConfig
from graph_tpu import page_rank as jax_page_rank
from graph_tpu.engine import engine as jax_engine_mod
from graph_tpu.engine.engine import EdgeEngine as JaxEngine
from graph_tpu.graph.build import build_directed as jax_build_directed
from graph_tpu_torch.generate import host_rmat

WIKI_EDGES = [
    (1, 2), (2, 1), (4, 0), (4, 1), (5, 4), (5, 1), (5, 6), (6, 1),
    (6, 5), (7, 1), (7, 5), (8, 1), (8, 5), (9, 1), (9, 5), (10, 1),
    (10, 5), (11, 5), (12, 5),
]


def _edges(name):
    if name == "wiki":
        e = np.array(WIKI_EDGES)
        return e[:, 0], e[:, 1], 13
    src, dst = host_rmat(10, seed=3)
    return src, dst, 1 << 10


def _jax_page_rank(src, dst, n, **cfg):
    g = jax_build_directed(jnp.asarray(src.astype(np.int32)),
                           jnp.asarray(dst.astype(np.int32)), node_count=n)
    eng = JaxEngine.build(np.asarray(g.csr_out.sources),
                          np.asarray(g.csr_out.targets), n,
                          interpret=True, relabel="degree")
    jax_engine_mod._GRAPH_ENGINES[(id(g), "fwd")] = eng
    return jax_page_rank(g, JaxConfig(engine="plan", **cfg))


@pytest.mark.parametrize("graph", ["wiki", "rmat10"])
@pytest.mark.parametrize("cfg", [
    {},
    {"tolerance": 0.0},
    {"max_iterations": 100, "tolerance": 1e-6, "damping_factor": 0.6},
], ids=["default", "tol0", "converge"])
def test_page_rank_matches_graph_tpu(graph, cfg):
    src, dst, n = _edges(graph)
    want = _jax_page_rank(src, dst, n, **cfg)
    g = gtt.build_directed(src, dst, node_count=n, device="cpu")
    got = gtt.page_rank(g, gtt.PageRankConfig(engine="plan", **cfg))
    assert got.ran_iterations == want.ran_iterations
    assert abs(got.error - want.error) <= 1e-6
    np.testing.assert_array_equal(got.scores_np(), want.scores_np())
    assert got.scores_np().dtype == np.float32


def test_auto_engine_is_the_plan_path():
    src, dst, n = _edges("wiki")
    g = gtt.build_directed(src, dst, node_count=n, device="cpu")
    auto = gtt.page_rank(g, gtt.PageRankConfig())
    plan = gtt.page_rank(g, gtt.PageRankConfig(engine="plan"))
    np.testing.assert_array_equal(auto.scores_np(), plan.scores_np())


@pytest.mark.parametrize("cfg", [{"engine": "cumsum"}, {"engine": "scatter"},
                                 {"log_progress": True}])
def test_unported_paths_name_the_roadmap(cfg):
    """The paths the roadmap's queue 1 item 8 named are ported: each runs
    the plan path's iterations, "cumsum" and the logged plan path with
    its scores bit for bit, "scatter" (f32 sums) within 1e-6."""
    src, dst, n = _edges("rmat10")
    g = gtt.build_directed(src, dst, node_count=n, device="cpu")
    plan = gtt.page_rank(g, gtt.PageRankConfig(engine="plan"))
    got = gtt.page_rank(g, gtt.PageRankConfig(**cfg))
    assert got.ran_iterations == plan.ran_iterations
    np.testing.assert_allclose(got.scores_np(), plan.scores_np(), rtol=0,
                               atol=0 if cfg != {"engine": "scatter"}
                               else 1e-6)
    with pytest.raises(ValueError, match="engine"):
        gtt.page_rank(g, gtt.PageRankConfig(engine="pallas"))
