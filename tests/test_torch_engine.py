"""The port's EdgeEngine against graph_tpu's, bit for bit.

The same numpy inputs go through ``graph_tpu``'s EdgeEngine (Pallas
kernels in interpret mode on the CPU) and through ``graph_tpu_torch``'s
on the CPU (the kernels' plain versions).  The engines' int32 fixed
point makes the comparison exact: no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_tpu.engine.engine import EdgeEngine as JaxEngine
from graph_tpu.engine.kernels import FIXED_BITS as JAX_FIXED_BITS, MID
from graph_tpu.engine.plan import build_plan as jax_build_plan
from graph_tpu_torch.engine import EdgeEngine, EdgePlan, plan_from_numpy
from graph_tpu_torch.engine.kernels import FIXED_BITS, k1_gather, k2_reduce
from graph_tpu_torch.engine.plan import build_plan, load_or_build_plan
from graph_tpu_torch.generate import host_rmat


def _rmat(scale):
    src, dst = host_rmat(scale, seed=5)
    return src, dst, 1 << scale


def _two_mids():
    n, m = MID + 100, 4000  # the JAX plan gets a second, nearly empty mid
    g = np.random.default_rng(11)
    src, dst = g.integers(0, n, m), g.integers(0, n, m)
    dst[-10:] = MID + 50
    return src, dst, n


def _multigraph():
    """Duplicate edges, self-loops and isolated nodes (150..199)."""
    g = np.random.default_rng(4)
    src, dst = g.integers(0, 150, 600), g.integers(0, 150, 600)
    src = np.concatenate([src, src[:100], np.arange(0, 150, 3)])
    dst = np.concatenate([dst, dst[:100], np.arange(0, 150, 3)])
    return src, dst, 200


def _bounded():
    """Row sums above 2 (int32 fixed point's range) but below 8."""
    g = np.random.default_rng(9)
    src, dst = g.integers(0, 300, 900), g.integers(0, 300, 900)
    return src, dst, 300


GRAPHS = {"rmat10": lambda: _rmat(10), "rmat12": lambda: _rmat(12),
          "two_mids": _two_mids, "multigraph": _multigraph,
          "bounded": _bounded}


def _gate_x(n):
    """The benchmark exactness gate's input: x in [0, 1e-5)."""
    return (np.random.default_rng(1).random(n) * 1e-5).astype(np.float32)


@pytest.mark.parametrize("graph,relabel,bound", [
    ("rmat10", None, 1.0),
    ("rmat10", "degree", 1.0),
    ("rmat12", None, 1.0),
    ("rmat12", "degree", 1.0),
    ("two_mids", None, 1.0),
    ("multigraph", "degree", 1.0),
    ("bounded", None, 4.0),
])
def test_spmv_bit_exact_vs_graph_tpu(graph, relabel, bound):
    src, dst, n = GRAPHS[graph]()
    if bound == 1.0:
        x = _gate_x(n)
    else:
        x = (np.random.default_rng(2).random(n) * 0.5).astype(np.float32)
    jplan = jax_build_plan(src, dst, n, relabel=relabel)
    want = np.asarray(JaxEngine(jplan, interpret=True).spmv(
        jnp.asarray(x), bound=bound))
    eng = EdgeEngine.build(src, dst, n, relabel=relabel, device="cpu")
    got = eng.spmv(torch.from_numpy(x), bound=bound).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if relabel is not None:
        np.testing.assert_array_equal(eng.plan.perm.numpy(), jplan.perm)
    if bound != 1.0:  # the case exercises the rescale
        assert 2.0 < want.max() < 2 * bound


def test_spmv_internal_order_on_graph_tpu_perm():
    """plan_from_numpy carries graph_tpu's internal order across: the
    internal-order spmv agrees bit for bit too."""
    src, dst, n = _rmat(12)
    jeng = JaxEngine(jax_build_plan(src, dst, n, relabel="degree"),
                     interpret=True)
    x = _gate_x(n)
    want = np.asarray(jeng.spmv_dev(jeng.dev, jnp.asarray(x), internal=True))
    eng = EdgeEngine(plan_from_numpy(src, dst, n, perm=jeng.plan.perm,
                                     device="cpu"))
    got = eng.spmv(torch.from_numpy(x), internal=True).numpy()
    np.testing.assert_array_equal(got, want)


def test_degree_perm_ties_by_id():
    src, dst = np.array([3, 3, 1, 0, 0, 2]), np.array([1, 2, 0, 1, 3, 2])
    plan = build_plan(src, dst, 5, relabel="degree", device="cpu")
    want = np.asarray(jax_build_plan(src, dst, 5, relabel="degree").perm)
    np.testing.assert_array_equal(plan.perm.numpy(), want)
    np.testing.assert_array_equal(plan.perm.numpy(), [0, 2, 3, 1, 4])


def test_plan_layout():
    src, dst, n = _multigraph()
    plan = build_plan(src, dst, n, device="cpu")
    indptr, slot_src = plan.indptr.numpy(), plan.slot_src.numpy()
    assert indptr.dtype == np.int64 and slot_src.dtype == np.int32
    np.testing.assert_array_equal(np.diff(indptr), np.bincount(dst, minlength=n))
    order = np.lexsort((src, dst))  # (dst, src) order
    np.testing.assert_array_equal(slot_src, src[order])


def test_plan_rejects_out_of_range_edges():
    with pytest.raises(ValueError, match="endpoints"):
        build_plan(np.array([0, 5]), np.array([1, 1]), 5, device="cpu")
    with pytest.raises(ValueError, match="permutation"):
        plan_from_numpy(np.array([0]), np.array([1]), 2,
                        perm=np.array([0, 0]), device="cpu")


def test_k2_plain_wraps_like_int64_mod_2_32():
    g = np.random.default_rng(5)
    counts = g.integers(0, 9, 400)
    counts[::7] = 0                     # empty rows
    counts[3] = 5000                    # a long row
    indptr = np.concatenate([[0], np.cumsum(counts)])
    contrib = g.integers(-2**31, 2**31, indptr[-1]).astype(np.int32)
    rows = np.repeat(np.arange(counts.size), counts)
    acc = np.zeros(counts.size, np.int64)
    np.add.at(acc, rows, contrib.astype(np.int64))
    assert (np.abs(acc) >= 2**31).any()  # the case exercises the wrap
    want = ((acc + 2**31) % 2**32 - 2**31).astype(np.int32)
    got = k2_reduce(torch.from_numpy(contrib), torch.from_numpy(indptr))
    np.testing.assert_array_equal(got.numpy(), want)
    xq = torch.from_numpy(contrib[:50].copy())
    idx = torch.from_numpy(g.integers(0, 50, 300).astype(np.int32))
    np.testing.assert_array_equal(k1_gather(xq, idx).numpy(),
                                  contrib[:50][idx.numpy()])


def test_plan_save_load_and_cache(tmp_path):
    src, dst, n = _rmat(10)
    plan = build_plan(src, dst, n, relabel="degree", device="cpu")
    path = str(tmp_path / "plan.npz")
    plan.save(path)
    back = EdgePlan.load(path, device="cpu")
    assert (back.n, back.m) == (plan.n, plan.m)
    for f in ("indptr", "slot_src", "perm"):
        assert torch.equal(getattr(back, f), getattr(plan, f))

    cache = str(tmp_path / "cache")
    first = load_or_build_plan(src, dst, n, cache_dir=cache,
                               relabel="degree", device="cpu")
    files = list((tmp_path / "cache").iterdir())
    assert len(files) == 1
    second = load_or_build_plan(src, dst, n, cache_dir=cache,
                                relabel="degree", device="cpu")
    assert torch.equal(first.slot_src, second.slot_src)
    assert torch.equal(second.perm, plan.perm)

    z = dict(np.load(path))
    z["__header__"] = z["__header__"].copy()
    z["__header__"][2] += 1
    np.savez(path, **z)
    with pytest.raises(ValueError, match="format"):
        EdgePlan.load(path, device="cpu")


def test_plan_values_snapshot_and_cache_key(tmp_path):
    """Snapshots carry slot_w; the cache key includes the values, so a
    changed weight misses; a format-1 snapshot asks for a rebuild."""
    src, dst, n = _multigraph()
    w = np.random.default_rng(3).random(src.size).astype(np.float32)
    plan = build_plan(src, dst, n, values=w, relabel="degree", device="cpu")
    path = str(tmp_path / "plan.npz")
    plan.save(path)
    back = EdgePlan.load(path, device="cpu")
    assert back.slot_w.dtype == torch.float32
    for f in ("indptr", "slot_src", "perm", "slot_w"):
        assert torch.equal(getattr(back, f), getattr(plan, f))
    build_plan(src, dst, n, device="cpu").save(path)
    assert EdgePlan.load(path, device="cpu").slot_w is None

    cache = tmp_path / "cache"
    first = load_or_build_plan(src, dst, n, cache_dir=str(cache),
                               values=w, device="cpu")
    w2 = w.copy()
    w2[17] += 1.0
    second = load_or_build_plan(src, dst, n, cache_dir=str(cache),
                                values=w2, device="cpu")
    unweighted = load_or_build_plan(src, dst, n, cache_dir=str(cache),
                                    device="cpu")
    assert len(list(cache.iterdir())) == 3
    assert unweighted.slot_w is None
    assert torch.equal(first.slot_src, second.slot_src)
    assert not torch.equal(first.slot_w, second.slot_w)
    again = load_or_build_plan(src, dst, n, cache_dir=str(cache),
                               values=w2, device="cpu")
    assert torch.equal(again.slot_w, second.slot_w)
    assert len(list(cache.iterdir())) == 3

    # a format-1 snapshot: a 3-field header, no slot_w
    np.savez(path, __header__=np.array([n, src.size, 1], np.int64),
             indptr=plan.indptr.numpy(), slot_src=plan.slot_src.numpy(),
             perm=plan.perm.numpy())
    with pytest.raises(ValueError, match="rebuild"):
        EdgePlan.load(path, device="cpu")


def test_fixed_point_constant_matches_graph_tpu():
    assert FIXED_BITS == JAX_FIXED_BITS
