"""The port's CSR build and RMAT generator against graph_tpu's."""

import jax.numpy as jnp
import numpy as np
import pytest

import bench
from graph_tpu.graph.build import build_directed as jax_build_directed
from graph_tpu.graph.build import build_undirected as jax_build_undirected
from graph_tpu.graph.build import csr_from_coo as jax_csr_from_coo
from graph_tpu.graph.csr import CsrLayout as JaxLayout
from graph_tpu_torch.generate import cached_rmat, host_rmat
from graph_tpu_torch.graph import (
    CsrLayout, UndirectedCsrGraph, build_directed, build_undirected,
    csr_from_coo)

LAYOUTS = ["UNSORTED", "SORTED", "DEDUPLICATED"]


def _edges(seed=6, n=60, m=400):
    """Duplicates, self-loops and isolated nodes included."""
    g = np.random.default_rng(seed)
    src = g.integers(0, n - 10, m).astype(np.int32)
    dst = g.integers(0, n - 10, m).astype(np.int32)
    src[:40], dst[:40] = src[40:80], dst[40:80]   # duplicates
    dst[80:100] = src[80:100]                     # self-loops
    vals = g.random(m).astype(np.float32)
    return src, dst, vals, n


def _assert_csr_equal(got, want):
    for f in ("offsets", "sources", "targets", "values"):
        w = getattr(want, f)
        g = getattr(got, f)
        if w is None:
            assert g is None, f
            continue
        g = g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f)
        assert g.dtype == np.asarray(w).dtype, f


@pytest.mark.parametrize("layout", LAYOUTS)
def test_build_directed_matches_graph_tpu(layout):
    src, dst, vals, n = _edges()
    want = jax_build_directed(jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(vals), node_count=n,
                              layout=JaxLayout[layout])
    got = build_directed(src, dst, vals, node_count=n,
                         layout=CsrLayout[layout], device="cpu")
    assert (got.node_count, got.edge_count) == (want.node_count,
                                                want.edge_count)
    _assert_csr_equal(got.csr_out, want.csr_out)
    _assert_csr_equal(got.csr_in, want.csr_in)
    np.testing.assert_array_equal(got.out_degrees().numpy(),
                                  np.asarray(want.out_degrees()))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_csr_from_coo_matches_graph_tpu(layout):
    src, dst, _, n = _edges(seed=8)
    want = jax_csr_from_coo(src, dst, node_count=n, layout=JaxLayout[layout])
    got = csr_from_coo(src, dst, node_count=n, layout=CsrLayout[layout],
                       device="cpu")
    _assert_csr_equal(got, want)
    assert got.neighbors_np(3).tolist() == want.neighbors_np(3).tolist()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_build_undirected_matches_graph_tpu(layout):
    src, dst, vals, n = _edges(seed=7)
    want = jax_build_undirected(jnp.asarray(src), jnp.asarray(dst),
                                jnp.asarray(vals), node_count=n,
                                layout=JaxLayout[layout])
    got = build_undirected(src, dst, vals, node_count=n,
                           layout=CsrLayout[layout], device="cpu")
    assert isinstance(got, UndirectedCsrGraph) and got.layout.name == layout
    assert (got.node_count, got.edge_count) == (want.node_count,
                                                want.edge_count)
    _assert_csr_equal(got.csr, want.csr)
    np.testing.assert_array_equal(got.degrees().numpy(),
                                  np.asarray(want.degrees()))


def test_build_directed_infers_node_count():
    src, dst = np.array([0, 4, 2]), np.array([1, 1, 7])
    g = build_directed(src, dst, device="cpu")
    assert g.node_count == 8 and g.edge_count == 3


@pytest.mark.parametrize("scale,edge_factor,seed", [(6, 16, 1), (10, 16, 42),
                                                    (9, 8, 5)])
def test_host_rmat_matches_bench(scale, edge_factor, seed):
    want = bench.host_rmat(scale, edge_factor, seed)
    got = host_rmat(scale, edge_factor, seed)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_cached_rmat_reads_back_what_it_wrote(tmp_path):
    first = cached_rmat(6, str(tmp_path), seed=2)
    assert len(list(tmp_path.iterdir())) == 1
    second = cached_rmat(6, str(tmp_path), seed=2)
    for a, b, c in zip(first, second, host_rmat(6, seed=2)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
