"""The Jacobi tails of PageRank's plan engine (``jacobi_quantize``,
``jacobi_update``) and the body that runs them, on the CPU.

Each wrapper runs its plain version for CPU tensors; these tests hold the
plain versions to the op chain the plan engine's body ran before them
(``EdgeEngine.spmv``'s quantize and rescale, ``_update``, the residual),
bit for bit, and the body that uses them to the op-chain body.  The
kernels themselves are held to the plain versions on the card
(``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

import graph_tpu_torch as gtt
from graph_tpu_torch.algos import pagerank
from graph_tpu_torch.algos.pagerank import (
    _graph_engine, _inv_outdeg, _jacobi, _scalars, _update)
from graph_tpu_torch.engine.kernels import (
    FIXED_BITS, JACOBI_MAX_BLOCKS, JACOBI_THREADS, jacobi_blocks,
    jacobi_quantize, jacobi_update)
from graph_tpu_torch.generate import host_rmat

#: Nodes a block of the tail kernels takes in one step (vectors of four).
BLOCK = 4 * JACOBI_THREADS


def _inputs(n, seed):
    """Scores near 1/n, 1/out-degree with zeros (no out-edge), and the
    first nodes' products on rounding halfway points: (2k+1) / 2**31 with
    inv = 1 is k + 1/2 quanta, k even and odd."""
    g = np.random.default_rng(seed)
    scores = (g.random(n) * 2.0 / max(n, 1)).astype(np.float32)
    deg = g.integers(0, 50, n)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0).astype(np.float32)
    half = min(n, 64)
    scores[:half] = (2 * np.arange(half) + 1) / np.float32(2**31)
    inv[:half] = 1.0
    return torch.from_numpy(scores), torch.from_numpy(inv)


@pytest.mark.parametrize("n", [0, 1, 3, BLOCK + 1, 4 * BLOCK + 5])
def test_jacobi_quantize_matches_the_op_chain(n):
    scores, inv = _inputs(n, n)
    got = jacobi_quantize(scores, inv)
    # the plan body's out-scores, then EdgeEngine.apply's quantize
    x = scores * inv
    want = torch.round(x * float(1 << FIXED_BITS)).to(torch.int32)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    # round half to even, in numpy: the halfway points go to even quanta
    ref = np.rint(x.numpy() * np.float32(1 << FIXED_BITS)).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), ref)
    if n:
        half = min(n, 64)
        assert (got[:half].numpy() == 2 * (np.arange(half) // 2 + (
            np.arange(half) % 2))).all()
        assert (got[inv == 0] == 0).all()


@pytest.mark.parametrize("n", [0, 1, 3, BLOCK + 1, 4 * BLOCK + 5])
@pytest.mark.parametrize("into", [False, True])
def test_jacobi_update_matches_the_op_chain(n, into):
    g = np.random.default_rng(n + 7)
    acc = g.integers(-2**31, 2**31, n).astype(np.int32)
    acc[: min(n, 4)] = [2**31 - 1, -2**31, (1 << 24) + 1, 0][: min(n, 4)]
    acc = torch.from_numpy(acc)
    scores, _ = _inputs(n, n + 1)
    init, base, d = _scalars(max(n, 1), 0.85)
    out = torch.empty(n) if into else None
    err = torch.empty(()) if into else None
    new, e = jacobi_update(acc, scores, base, d, out, err)
    # EdgeEngine.apply's rescale, then the body's update and residual
    y = acc.to(torch.float32) / float(1 << FIXED_BITS)
    want = _update(y, base, d)
    assert torch.equal(new, want)
    assert torch.equal(e, torch.sum(torch.abs(want - scores)))
    if into:
        assert new is out and e is err


def test_jacobi_blocks_follow_n_alone():
    assert jacobi_blocks(0) == jacobi_blocks(1) == 1
    assert jacobi_blocks(BLOCK) == 1 and jacobi_blocks(BLOCK + 1) == 2
    assert jacobi_blocks(1 << 22) == JACOBI_MAX_BLOCKS
    assert jacobi_blocks(1 << 26) == JACOBI_MAX_BLOCKS


def _graph(name):
    """wiki (13 nodes), RMAT 10, and a graph whose last 100 nodes have no
    out-edge and the first 50 no in-edge."""
    if name == "wiki":
        e = np.array([(1, 2), (2, 1), (4, 0), (4, 1), (5, 4), (5, 1), (5, 6),
                      (6, 1), (6, 5), (7, 1), (7, 5), (8, 1), (8, 5), (9, 1),
                      (9, 5), (10, 1), (10, 5), (11, 5), (12, 5)])
        return e[:, 0], e[:, 1], 13
    if name == "rmat10":
        src, dst = host_rmat(10, seed=3)
        return src, dst, 1 << 10
    g = np.random.default_rng(11)
    src = g.integers(0, 900, 8000)
    dst = g.integers(50, 1000, 8000)
    return src, dst, 1000


@pytest.mark.parametrize("graph", ["wiki", "rmat10", "sinks"])
@pytest.mark.parametrize("cfg", [(20, 1e-4, 0.85), (20, 0.0, 0.85),
                                 (100, 1e-6, 0.6)],
                         ids=["default", "tol0", "converge"])
def test_tails_body_matches_the_op_chain_body(graph, cfg):
    """The plan engine's tails body against ``_jacobi``'s op-chain body
    over the same spmv: the same scores bit for bit, the same iterations,
    the residual within 1e-6."""
    src, dst, n = _graph(graph)
    g = gtt.build_directed(src, dst, node_count=n, device="cpu")
    eng = _graph_engine(g)
    inv = eng.to_internal(_inv_outdeg(g.out_degrees()))
    want = _jacobi(lambda x: eng.spmv(x, internal=True), inv, *cfg)
    got = _jacobi(lambda x: eng.spmv(x, internal=True), inv, *cfg,
                  quanta=eng.sum_quanta)
    assert torch.equal(got[0], want[0])
    assert got[1] == want[1] >= 1
    assert abs(got[2] - want[2]) <= 1e-6


def test_sum_quanta_is_spmv_without_quantize_and_rescale():
    src, dst, n = _graph("rmat10")
    g = gtt.build_directed(src, dst, node_count=n, device="cpu")
    eng = _graph_engine(g)
    x = torch.from_numpy(np.random.default_rng(2).random(n).astype(
        np.float32)) / n
    xq = torch.round(x * float(1 << FIXED_BITS)).to(torch.int32)
    y = eng.sum_quanta(xq).to(torch.float32) / float(1 << FIXED_BITS)
    assert torch.equal(y, eng.spmv(x, internal=True))
    with pytest.raises(ValueError):
        eng.sum_quanta(x)


@pytest.mark.parametrize("cfg,bodies", [
    ({"engine": "plan"}, True), ({"engine": "auto"}, True),
    ({"engine": "plan", "log_progress": True}, False),
    ({"engine": "cumsum"}, False), ({"engine": "scatter"}, False)])
def test_only_the_plan_engine_runs_the_tails_kernels(cfg, bodies,
                                                     monkeypatch):
    """page_rank's plan engine calls ``jacobi_quantize`` and
    ``jacobi_update`` once an iteration; logging, ``cumsum`` and
    ``scatter`` keep the op-chain body."""
    calls = {"quantize": 0, "update": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(pagerank, "jacobi_quantize",
                        counted("quantize", pagerank.jacobi_quantize))
    monkeypatch.setattr(pagerank, "jacobi_update",
                        counted("update", pagerank.jacobi_update))
    src, dst, n = _graph("rmat10")
    g = gtt.build_directed(src, dst, node_count=n, device="cpu")
    res = gtt.page_rank(g, gtt.PageRankConfig(**cfg))
    it = res.ran_iterations if bodies else 0
    assert calls == {"quantize": it, "update": it}
