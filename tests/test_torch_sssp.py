"""The port's SSSP against graph_tpu's plan-engine SSSP, exactly.

``graph_tpu``'s ``delta_stepping(graph, DeltaSteppingConfig(...,
engine="plan"))`` runs with an interpret-mode weighted EdgeEngine
(``relabel="degree"``) injected into its per-graph cache under
``"fwd_weighted"`` (as tests/test_sssp.py does); the port runs on the
CPU.  Distances are f32 path sums and must be equal, f32::MAX included.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from graph_tpu.algos.sssp import DeltaSteppingConfig as JaxConfig
from graph_tpu.algos.sssp import delta_stepping as jax_delta_stepping
from graph_tpu.engine import engine as jax_engine_mod
from graph_tpu.engine.engine import EdgeEngine as JaxEngine
from graph_tpu.graph.build import build_directed as jax_build_directed
from graph_tpu_torch import (
    CsrLayout, DeltaSteppingConfig, build_directed, delta_stepping)
from graph_tpu_torch.algos.sssp import INF
from graph_tpu_torch.generate import host_rmat

GOLDEN = np.array([0.0, 4.0, 2.0, 9.0, 5.0, 20.0], np.float32)


def _golden_graph():
    """The reference's golden graph (tests/test_sssp.py): a..f = 0..5."""
    e = np.array([(0, 1, 4.0), (0, 2, 2.0), (1, 2, 5.0), (1, 3, 10.0),
                  (2, 4, 3.0), (3, 5, 11.0), (4, 3, 4.0)])
    return build_directed(e[:, 0].astype(np.int64), e[:, 1].astype(np.int64),
                          e[:, 2].astype(np.float32), node_count=6,
                          layout=CsrLayout.DEDUPLICATED, device="cpu")


def _rmat(scale, seed):
    src, dst = host_rmat(scale, seed=seed)
    w = np.random.default_rng(3).random(src.size).astype(np.float32) * 4
    return src, dst, w, 1 << scale


def _uniform():
    g = np.random.default_rng(17)
    n, m = 2000, 9000
    return (g.integers(0, n, m), g.integers(0, n, m),
            (g.random(m) * 5 + 0.01).astype(np.float32), n)


def _hub(src):
    return int(np.bincount(src).argmax())


@pytest.mark.parametrize("graph,start", [
    ("rmat10", "hub"), ("rmat8", 0), ("rmat8", "hub"), ("uniform", 0),
    ("uniform", 1234)])
def test_sssp_matches_graph_tpu(graph, start):
    src, dst, w, n = {"rmat10": lambda: _rmat(10, 5),
                      "rmat8": lambda: _rmat(8, 9),
                      "uniform": _uniform}[graph]()
    start = _hub(src) if start == "hub" else start
    jgraph = jax_build_directed(jnp.asarray(src), jnp.asarray(dst),
                                values=jnp.asarray(w), node_count=n)
    jeng = JaxEngine.build(src, dst, n, values=w, interpret=True,
                           relabel="degree")
    jax_engine_mod._GRAPH_ENGINES[(id(jgraph), "fwd_weighted")] = jeng
    want = jax_delta_stepping(jgraph, JaxConfig(start, 3.0, engine="plan"))
    got = delta_stepping(build_directed(src, dst, w, node_count=n,
                                        device="cpu"),
                         DeltaSteppingConfig(start, 3.0))
    d = got.distances_np()
    assert d.dtype == np.float32
    np.testing.assert_array_equal(d, want.distances_np())
    assert d[start] == 0.0 and 1 < (d < INF).sum() < n
    assert got.ran_iterations >= 2


def test_golden():
    g = _golden_graph()
    for delta in (0.5, 3.0, 100.0):
        res = delta_stepping(g, DeltaSteppingConfig(start_node=0, delta=delta))
        np.testing.assert_array_equal(res.distances_np(), GOLDEN)
    res = delta_stepping(g, DeltaSteppingConfig(0, 3.0, engine="plan"))
    np.testing.assert_array_equal(res.distances_np(), GOLDEN)


def test_other_start_and_unreached_are_f32_max():
    d = delta_stepping(_golden_graph(), DeltaSteppingConfig(1, 3.0)
                       ).distances_np()
    assert d.tolist() == [INF, 0.0, 5.0, 10.0, 8.0, 21.0]
    g = build_directed(np.array([0]), np.array([1]),
                       np.array([1.0], np.float32), node_count=3,
                       device="cpu")
    d = delta_stepping(g, DeltaSteppingConfig(0, 1.0)).distances_np()
    assert d.tolist() == [0.0, 1.0, INF]
    assert d[2] == np.finfo(np.float32).max


def test_errors():
    g = build_directed(np.array([0, 1]), np.array([1, 2]), device="cpu")
    with pytest.raises(ValueError, match="edge weights"):
        delta_stepping(g, DeltaSteppingConfig(0, 1.0))
    gw = _golden_graph()
    for engine in ("xla", "frontier"):  # ported: the golden, exactly
        np.testing.assert_array_equal(delta_stepping(
            gw, DeltaSteppingConfig(0, 1.0, engine=engine)).distances_np(),
            GOLDEN)
    with pytest.raises(ValueError, match="start_node"):
        delta_stepping(gw, DeltaSteppingConfig(6, 1.0))
