"""The port's whole EdgeEngine surface against graph_tpu's, bit for bit.

Every (combine, reduce) pair, ``smin``, ``smin_int`` and ``relax`` go
through ``graph_tpu``'s EdgeEngine (Pallas kernels in interpret mode on
the CPU) and through ``graph_tpu_torch``'s (the kernels' plain versions)
on the same numpy inputs and edge weights.  Sums are int32 fixed point
and mins compare integers, so the comparison is exact: no tolerance.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_tpu.engine.pair as pairmod
from graph_tpu.engine.engine import EdgeEngine as JaxEngine
from graph_tpu.engine.plan import build_plan as jax_build_plan
from graph_tpu_torch.engine import EdgeEngine, plan_from_numpy
from graph_tpu_torch.engine.kernels import INF, INF_BITS, IMAX
from graph_tpu_torch.engine.plan import build_plan
from test_torch_engine import GRAPHS

CASES = [("rmat10", None), ("rmat10", "degree"), ("multigraph", None),
         ("multigraph", "degree")]
PAIRS = [("none", "sum"), ("mul", "sum"), ("add", "sum"), ("none", "min"),
         ("add", "min"), ("mul", "min")]


def _weights(m, seed=7):
    """Edge weights small enough that every per-slot quantum fits int32."""
    return (np.random.default_rng(seed).random(m) * 1e-3).astype(np.float32)


def _x(n, reduce, seed=3):
    """Sum inputs in [0, 1e-3); min inputs nonnegative, in [0, 1)."""
    x = np.random.default_rng(seed).random(n).astype(np.float32)
    return x * np.float32(1e-3) if reduce == "sum" else x


def _labels(n, seed=4):
    return np.random.default_rng(seed).integers(0, 1 << 30, n).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _engines(graph, relabel):
    src, dst, n = GRAPHS[graph]()
    w = _weights(src.size)
    jeng = JaxEngine(jax_build_plan(src, dst, n, values=w, relabel=relabel),
                     interpret=True)
    eng = EdgeEngine.build(src, dst, n, values=w, relabel=relabel,
                           device="cpu")
    return jeng, eng, n


@pytest.mark.parametrize("op", PAIRS + ["smin_int"],
                         ids=lambda o: "_".join(o) if isinstance(o, tuple)
                         else o)
@pytest.mark.parametrize("graph,relabel", CASES)
def test_op_bit_exact_vs_graph_tpu(graph, relabel, op):
    jeng, eng, n = _engines(graph, relabel)
    if op == "smin_int":
        xi = _labels(n)
        want = np.asarray(jeng.smin_int(jnp.asarray(xi)))
        got = eng.smin_int(torch.from_numpy(xi)).numpy()
        if graph == "multigraph":  # isolated nodes: empty rows
            assert (want == IMAX).any()
    else:
        combine, reduce = op
        x = _x(n, reduce)
        want = np.asarray(jeng.apply(jnp.asarray(x), combine=combine,
                                     reduce=reduce))
        got = eng.apply(torch.from_numpy(x), combine=combine,
                        reduce=reduce).numpy()
        named = {("none", "sum"): eng.spmv, ("none", "min"): eng.smin,
                 ("add", "min"): eng.relax}.get(op)
        if named is not None:
            np.testing.assert_array_equal(named(torch.from_numpy(x)).numpy(),
                                          want)
        if reduce == "sum":
            assert (want != 0).any()
        elif graph == "multigraph":  # empty rows hold 3e38, the +inf
            assert (want == np.float32(INF)).any()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_internal_order_on_graph_tpu_perm():
    """plan_from_numpy(values=) carries graph_tpu's internal order and
    weights across: internal-order ops agree bit for bit."""
    src, dst, n = GRAPHS["rmat10"]()
    w = _weights(src.size)
    jeng = JaxEngine(jax_build_plan(src, dst, n, values=w, relabel="degree"),
                     interpret=True)
    eng = EdgeEngine(plan_from_numpy(src, dst, n, perm=jeng.plan.perm,
                                     values=w, device="cpu"))
    for combine, reduce in (("add", "min"), ("mul", "sum")):
        x = _x(n, reduce)
        want = np.asarray(jeng.apply_dev(jeng.dev, jnp.asarray(x),
                                         combine=combine, reduce=reduce,
                                         internal=True))
        got = eng.apply(torch.from_numpy(x), combine=combine, reduce=reduce,
                        internal=True)
        np.testing.assert_array_equal(got.numpy(), want)
    xi = _labels(n)
    want = np.asarray(jeng.smin_int_dev(jeng.dev, jnp.asarray(xi),
                                        internal=True))
    got = eng.smin_int(torch.from_numpy(xi), internal=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bound_passes_the_operation_through():
    """apply(combine="mul", bound=) rescales the weighted sum, not a
    plain spmv: row sums above 2 but below 2 * bound, bit-exact."""
    src, dst, n = GRAPHS["bounded"]()
    g = np.random.default_rng(9)
    w = (0.75 + g.random(src.size) * 0.5).astype(np.float32)
    x = (g.random(n) * 0.5).astype(np.float32)
    jeng = JaxEngine(jax_build_plan(src, dst, n, values=w), interpret=True)
    want = np.asarray(jeng.apply(jnp.asarray(x), combine="mul", bound=4.0))
    eng = EdgeEngine.build(src, dst, n, values=w, device="cpu")
    got = eng.apply(torch.from_numpy(x), combine="mul", bound=4.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert 2.0 < want.max() < 8.0
    plain = eng.spmv(torch.from_numpy(x), bound=4.0).numpy()
    assert not np.array_equal(got, plain)


@pytest.mark.parametrize("combine,reduce", [("none", "min"), ("add", "min"),
                                            ("mul", "min"), ("add", "sum")])
def test_bound_rejects_nonlinear_reductions(combine, reduce):
    src, dst, n = GRAPHS["multigraph"]()
    w = _weights(src.size)
    x = _x(n, reduce)
    jeng = JaxEngine(jax_build_plan(src, dst, n, values=w), interpret=True)
    eng = EdgeEngine.build(src, dst, n, values=w, device="cpu")
    with pytest.raises(ValueError, match="bound"):
        jeng.apply(jnp.asarray(x), combine=combine, reduce=reduce, bound=4.0)
    with pytest.raises(ValueError, match="bound"):
        eng.apply(torch.from_numpy(x), combine=combine, reduce=reduce,
                  bound=4.0)


def test_errors_match_graph_tpu():
    src, dst, n = GRAPHS["multigraph"]()
    x = _x(n, "min")
    jeng = JaxEngine(jax_build_plan(src, dst, n), interpret=True)
    eng = EdgeEngine.build(src, dst, n, device="cpu")
    for combine in ("add", "mul"):  # a plan without values
        with pytest.raises(ValueError, match="edge values"):
            jeng.apply(jnp.asarray(x), combine=combine)
        with pytest.raises(ValueError, match="edge values"):
            eng.apply(torch.from_numpy(x), combine=combine)
    with pytest.raises(ValueError, match="edge values"):
        eng.relax(torch.from_numpy(x))
    for kw in ({"combine": "max"}, {"reduce": "max"}):
        with pytest.raises(ValueError):
            jeng.apply(jnp.asarray(x), **kw)
        with pytest.raises(ValueError):
            eng.apply(torch.from_numpy(x), **kw)
    with pytest.raises(ValueError, match="int32"):
        eng.smin_int(torch.from_numpy(x))
    with pytest.raises(ValueError, match="float32"):
        eng.smin(torch.from_numpy(x[:-1]))


def test_duplicate_edges_keep_their_own_weights():
    """Slots follow the (dst, src) sort with their weights: duplicates
    of one edge with different weights stay distinct."""
    src, dst = np.array([2, 0, 0, 1, 0]), np.array([1, 1, 1, 0, 0])
    w = np.array([0.5, 3.0, 1.0, 0.25, 2.0], np.float32)
    plan = build_plan(src, dst, 3, values=w, device="cpu")
    np.testing.assert_array_equal(plan.slot_src.numpy(), [0, 1, 0, 0, 2])
    np.testing.assert_array_equal(plan.slot_w.numpy(),
                                  [2.0, 0.25, 3.0, 1.0, 0.5])
    eng = EdgeEngine(plan)
    x = torch.tensor([1.0, 0.0, 0.75])
    assert eng.relax(x).tolist() == [0.25, 1.25, float(np.float32(INF))]
    xs = x * 0.125
    assert eng.apply(xs, combine="mul").tolist() == [0.25, 0.546875, 0.0]
    assert int(torch.tensor([INF]).view(torch.int32)) == INF_BITS


def _quad_graph():
    """A hub-heavy graph whose graph_tpu plan gets pair and quad blocks
    (the graph of tests/test_engine.py's quad-plan test)."""
    r = np.random.default_rng(41)
    n, m = 3000, 30000
    src = (r.zipf(1.25, m) % n).astype(np.int64)
    dst = r.integers(0, n, m).astype(np.int64)
    return src, dst, n


def test_pair_and_quad_slots_match_one_source_slots(monkeypatch):
    """graph_tpu's K1 sums or mins 2 or 4 sources per pair/quad slot; the
    port's plan holds one source per slot, and K2 gives the same bits."""
    monkeypatch.setattr(pairmod, "MIN_PAIRS", 4)
    monkeypatch.setattr(pairmod, "MIN_QUADS", 4)
    src, dst, n = _quad_graph()
    jplan = jax_build_plan(src, dst, n, relabel="degree", pair=True)
    assert jplan.pm is not None and jplan.pm.any()
    assert jplan.qm is not None and jplan.qm.any()
    jeng = JaxEngine(jplan, interpret=True)
    modes = {mode for _, mode in jeng.k1_cls}
    assert {"pair", "quad"} <= modes
    eng = EdgeEngine.build(src, dst, n, relabel="degree", device="cpu")
    np.testing.assert_array_equal(eng.plan.perm.numpy(), jplan.perm)
    x = _x(n, "sum")
    np.testing.assert_array_equal(
        eng.spmv(torch.from_numpy(x)).numpy(),
        np.asarray(jeng.spmv(jnp.asarray(x))))
    xm = _x(n, "min")
    np.testing.assert_array_equal(
        eng.smin(torch.from_numpy(xm)).numpy(),
        np.asarray(jeng.smin(jnp.asarray(xm))))
    xi = _labels(n)
    np.testing.assert_array_equal(
        eng.smin_int(torch.from_numpy(xi)).numpy(),
        np.asarray(jeng.smin_int(jnp.asarray(xi))))
