"""The port's WCC against graph_tpu's plan-engine WCC, exactly.

``graph_tpu``'s ``wcc(graph, WccConfig(engine="plan"))`` runs with an
interpret-mode symmetrized EdgeEngine injected into its per-graph cache
(as tests/test_wcc.py does); the port runs on the CPU.  Labels, their
dtype and the number of rounds must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from graph_tpu.algos.wcc import WccConfig as JaxWccConfig
from graph_tpu.algos.wcc import wcc as jax_wcc
from graph_tpu.engine import engine as jax_engine_mod
from graph_tpu.engine.engine import EdgeEngine as JaxEngine
from graph_tpu.graph.build import build_directed as jax_build_directed
from graph_tpu.graph.build import build_undirected as jax_build_undirected
from graph_tpu_torch import (
    WccConfig, build_directed, build_undirected, wcc, wcc_afforest,
    wcc_afforest_dss, wcc_baseline, wcc_components)
from graph_tpu_torch.generate import host_rmat


def _rmat(scale, seed):
    src, dst = host_rmat(scale, seed=seed)
    return src, dst, 1 << scale


def _sparse():
    """Many small components and isolated nodes (200 edges, 1000 nodes)."""
    g = np.random.default_rng(21)
    return g.integers(0, 1000, 200), g.integers(0, 1000, 200), 1000


def _chain():
    """A path whose labels need several pointer-jump rounds."""
    n = 300
    perm = np.random.default_rng(2).permutation(n)
    return perm[:-1], perm[1:], n


GRAPHS = {"rmat10": lambda: _rmat(10, 5), "rmat8": lambda: _rmat(8, 9),
          "sparse": _sparse, "chain": _chain}


def _jax_wcc(src, dst, n, undirected):
    if undirected:
        graph = jax_build_undirected(jnp.asarray(src), jnp.asarray(dst),
                                     node_count=n)
        sym_src = np.asarray(graph.csr.sources)
        sym_dst = np.asarray(graph.csr.targets)
    else:
        graph = jax_build_directed(jnp.asarray(src), jnp.asarray(dst),
                                   node_count=n)
        sym_src, sym_dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    sym = JaxEngine.build(sym_src, sym_dst, n, interpret=True)
    jax_engine_mod._GRAPH_ENGINES[(id(graph), "sym")] = sym
    return jax_wcc(graph, JaxWccConfig(engine="plan"))


@pytest.mark.parametrize("undirected", [False, True],
                         ids=["directed", "undirected"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_wcc_matches_graph_tpu(graph, undirected):
    src, dst, n = GRAPHS[graph]()
    want = _jax_wcc(src, dst, n, undirected)
    build = build_undirected if undirected else build_directed
    got = wcc(build(src, dst, node_count=n, device="cpu"),
              WccConfig(engine="plan"))
    labels = got.components_np()
    assert labels.dtype == np.asarray(want.components).dtype
    np.testing.assert_array_equal(labels, np.asarray(want.components))
    assert got.ran_iterations == want.ran_iterations
    assert (labels <= np.arange(n)).all()  # the component's least id


def test_isolated_nodes_are_singletons():
    g = build_directed([0], [1], node_count=4, device="cpu")
    assert wcc(g).components_np().tolist() == [0, 0, 2, 3]


def test_variants_and_engines():
    src, dst, n = GRAPHS["sparse"]()
    g = build_directed(src, dst, node_count=n, device="cpu")
    base = wcc_baseline(g).components_np()
    for fn in (wcc, wcc_afforest, wcc_afforest_dss):
        np.testing.assert_array_equal(fn(g).components_np(), base)
    np.testing.assert_array_equal(
        wcc(g, WccConfig(engine="plan")).components_np(), base)
    np.testing.assert_array_equal(wcc_components(g).numpy(), base)
    assert wcc(g).component(int(src[0])) == base[src[0]]
    np.testing.assert_array_equal(
        wcc(g, WccConfig(engine="xla")).components_np(), base)
    with pytest.raises(ValueError):
        wcc(g, WccConfig(engine="pallas"))
