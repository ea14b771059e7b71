"""Delta-stepping's near/far queues (``csrc/sssp_frontier.cu``) on the
CPU: ``auto``'s choice of engine by device, and the plain versions of the
three kernels (``kernels.sssp_frontier_reset``, ``_relax``, ``_advance``)
run by the card path's own function (``sssp._sssp_near_far``) under the
host loop.  They are a model of the kernels' schedule over the same
state: the queues with their arc scans and tile entries, the stamps, the
far pile and its filter.  The model reaches the reference's distances,
bit for bit the plan engine's and ``graph_tpu``'s on the card tests'
cases; the card tests hold the kernels to the plan engine and to this
model on those cases."""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.generators import graph500_kronecker, rgg
from benchmark.reference import sssp_worklist
from benchmark.tests.conftest import REPO
from graph_tpu_torch import profile
from graph_tpu_torch.algos import sssp
from graph_tpu_torch.engine import kernels
from graph_tpu_torch.engine.loop import Flag, While, host_while
from graph_tpu.algos import sssp as jax_sssp
from graph_tpu.algos.sssp import DeltaSteppingConfig as JaxSsspConfig
from graph_tpu.algos.sssp import delta_stepping as jax_delta_stepping
from graph_tpu.graph.build import build_directed as jax_build_directed
from graph_tpu_torch.graph.build import build_directed
from test_torch_kernels import NEAR_FAR_CASES, _near_far_case

RGG = json.loads(
    (REPO / "benchmark" / "configs" / "dimacs10-rgg-s22.json").read_text())


def _gen(seed):
    g = torch.Generator("cpu")
    g.manual_seed(seed)
    return g


def _case(name):
    """(data, graph on the CPU, source, delta): rgg at a scale with delta
    one radius in its weights' units (the rgg cell's delta at scale 22),
    or a Kronecker graph (weights in [0, 1)) from its hub at delta 0.1."""
    kind, scale = name[:-2], int(name[-2:])
    if kind == "rgg":
        conf = dict(RGG, n=1 << scale)
        data = rgg.make(conf, _gen(2**33 + scale))
        source = rgg.sources(data, 1, _gen(11))[0]
        delta = float(round(rgg.radius(conf) * 1e6))
    else:
        data = graph500_kronecker.make(
            {"scale": scale, "edgefactor": 16, "A": 0.57, "B": 0.19,
             "C": 0.19, "weights": {"low": 0.0, "high": 1.0}},
            _gen(2**35 + scale))
        source = int(torch.bincount(data.src).argmax())
        delta = 0.1
    g = build_directed(data.src, data.dst, data.weights, node_count=data.n,
                       device="cpu")
    return data, g, source, delta


def _run(g, source, delta):
    """The near/far run's result and its ``sssp.run`` counters."""
    profile.spans(clear=True)
    with profile.record():
        res = sssp._sssp_near_far(g, sssp.DeltaSteppingConfig(source, delta))
    run, = [s for s in profile.spans(clear=True) if s["name"] == "sssp.run"]
    return res, run["counters"]


def test_auto_runs_plan_on_the_cpu_and_the_near_far_queues_on_the_card(
        monkeypatch):
    """``auto`` (and ``frontier``) by the graph's device, through stubs:
    no card is needed to see the choice."""
    calls = []
    for name in ("_sssp_plan", "_sssp_near_far", "_sssp_frontier"):
        monkeypatch.setattr(sssp, name, lambda g, c, _n=name: calls.append(
            (_n, c.engine)))
    cpu = build_directed(np.array([0, 1]), np.array([1, 2]),
                         np.array([1.0, 2.0], np.float32), device="cpu")
    card = types.SimpleNamespace(
        csr_in=cpu.csr_in, node_count=3, edge_count=2,
        device=torch.device("cuda"))
    for g in (cpu, card):
        for engine in ("auto", "frontier"):
            sssp.delta_stepping(g, sssp.DeltaSteppingConfig(0, 1.0, engine))
    assert calls == [("_sssp_plan", "auto"), ("_sssp_frontier", "frontier"),
                     ("_sssp_near_far", "auto"),
                     ("_sssp_near_far", "frontier")]
    assert sssp._auto_engine(cpu) == "plan"
    assert sssp._auto_engine(card) == "frontier"
    card.edge_count = kernels.NEAR_FAR_MAX_ARCS
    assert sssp._auto_engine(card) == "plan"


@pytest.mark.parametrize("name", ["rgg09", "rgg10", "rgg11", "kron08",
                                  "kron09", "kron10"])
def test_the_near_far_model_reaches_the_reference(name):
    """The plain kernels under the host loop: the reference's float32
    distances (unreached nodes included), bit for bit the plan engine's;
    about one sweep of the graph on rgg, where the plan engine takes
    dozens."""
    data, g, source, delta = _case(name)
    res, c = _run(g, source, delta)
    want = sssp_worklist.bellman_ford(data.src, data.dst, data.weights,
                                      data.n, source, dtype=torch.float32
                                      ).numpy().astype(np.float64)
    got = res.distances_np().astype(np.float64)
    got[~(res.distances_np() < sssp.INF)] = np.inf
    np.testing.assert_array_equal(got, want)
    plan = sssp.delta_stepping(g, sssp.DeltaSteppingConfig(
        source, delta, engine="plan"))
    assert torch.equal(res.distances, plan.distances)
    reached = res.distances < float(sssp.INF)
    arcs = int(g.out_degrees()[reached].sum())
    assert c["rounds"] == res.ran_iterations >= c["buckets"] >= 1
    assert arcs <= c["relaxed"] <= 4 * arcs
    if name.startswith("rgg"):
        assert np.isinf(want).any()  # other components: unreached
        assert c["relaxed"] <= 1.2 * g.edge_count < plan.ran_iterations * \
            g.edge_count / 20
    assert res.host_reads == c["rounds"] + 2 * c["buckets"] + 2


@pytest.mark.parametrize("case", NEAR_FAR_CASES)
def test_the_near_far_model_bit_equal_to_graph_tpu(case):
    """On each case of the card tests, from the same two starts: the
    model's distances bit for bit ``graph_tpu``'s delta-stepping on the
    same arcs (its compacted-frontier engine where a settle step gathers
    at most 2**20 slots of its padded adjacency, else its dense-mask
    engine)."""
    g, start, delta = _near_far_case(case, "cpu")
    out_deg = g.out_degrees()
    src = torch.repeat_interleave(torch.arange(g.node_count), out_deg)
    jg = jax_build_directed(
        jnp.asarray(src.numpy().astype(np.int32)),
        jnp.asarray(g.csr_out.targets.numpy().astype(np.int32)),
        values=jnp.asarray(g.csr_out.values.numpy()),
        node_count=g.node_count)
    slots = jax_sssp._FRONTIER_CAP * max(1, int(out_deg.max()))
    engine = "frontier" if slots <= 1 << 20 else "xla"
    for s in (start, int(out_deg.argmax())):
        res, _ = _run(g, s, delta)
        want = jax_delta_stepping(jg, JaxSsspConfig(s, delta, engine=engine))
        np.testing.assert_array_equal(res.distances_np(),
                                      np.asarray(want.distances))


@pytest.mark.parametrize("tile", [kernels.NEAR_FAR_TILE, 3])
def test_each_step_keeps_the_queues_stamps_and_far_pile(tile, monkeypatch):
    """Step by step on a Kronecker graph whose hub spans many tiles: the
    current near queue holds distinct nodes with out-arcs in the bucket,
    stamped with the step where a relax step made the queue; its arc places are the scan of their
    out-degrees, their first arcs their offsets, and each tile points at
    the entry of its first arc.  The far pile holds distinct marked nodes,
    and its least bucket bounds its pending entries'."""
    monkeypatch.setattr(kernels, "NEAR_FAR_TILE", tile)
    _, g, source, delta = _case("kron09")
    st = kernels.near_far_state(g.csr_out.offsets, g.csr_out.targets,
                                g.csr_out.values)
    c, q = st.ctrl, st.queues
    seen = {"entries": 0, "tiles": 0, "far": 0, "relaxed": False}

    def check_queue():
        cur, head = int(c[kernels.CUR]), int(c[kernels.HEAD + int(c[
            kernels.CUR])])
        count, arcs = head >> 32, head & 0xFFFFFFFF
        nodes = q[cur, :count].long()
        deg = st.offsets[nodes + 1] - st.offsets[nodes]
        assert nodes.unique().numel() == count and bool((deg > 0).all())
        assert torch.equal(q[2 + cur, :count].long(), st.offsets[nodes])
        offs = torch.cumsum(deg, 0) - deg
        assert torch.equal(q[4 + cur, :count].long(), offs)
        assert int(deg.sum()) == arcs
        starts = torch.arange(0, arcs, tile)
        assert torch.equal(st.tiles[cur, :starts.numel()].long(),
                           torch.searchsorted(offs, starts, right=True) - 1)
        b = int(c[kernels.BUCKET])
        buckets = kernels.bucket_of(st.dist[nodes], delta)
        assert bool((buckets == b).all())
        if seen["relaxed"]:  # else the reset or an advance made it
            step = int(c[kernels.STEP])
            assert bool((st.marks[0, nodes] == step).all())
        fc = int(c[kernels.FC])
        far = q[6 + fc, :int(c[kernels.FAR_COUNT + fc])].long()
        assert far.unique().numel() == far.numel()
        assert bool((st.marks[1, far] == 1).all())
        pending = far[kernels.bucket_of(st.dist[far], delta) > b]
        if pending.numel():
            assert int(c[kernels.FAR_MIN + fc]) <= int(
                kernels.bucket_of(st.dist[pending], delta).min())
        seen["entries"] = max(seen["entries"], count)
        seen["tiles"] = max(seen["tiles"], starts.numel())
        seen["far"] = max(seen["far"], far.numel())

    def relax(state):
        check_queue()
        kernels.sssp_frontier_relax(st, delta, state[0])
        seen["relaxed"] = True
        return state

    def advance(state):
        kernels.sssp_frontier_advance(st, delta, state[0], state[1])
        seen["relaxed"] = False
        return state

    kernels.sssp_frontier_reset(st, source)
    run = host_while((While(relax, Flag(0)), advance),
                     (st.flags[0], st.flags[1]), Flag(1))
    want = sssp.delta_stepping(g, sssp.DeltaSteppingConfig(
        source, delta, engine="plan"))
    assert torch.equal(st.dist, want.distances)
    assert run.iterations >= 3 and run.inner[0] > run.iterations
    assert seen["entries"] > 1 and seen["far"] > 1
    assert seen["tiles"] > (1000 // tile)  # the hub's arcs: many tiles


def test_buckets_follow_delta_and_edge_cases():
    """Hundreds of buckets at a small delta, one at a large one, zero
    weights, a source without out-arcs, and unreached nodes."""
    _, g, source, _ = _case("kron08")
    many, c_many = _run(g, source, 0.002)
    one, c_one = _run(g, source, 1e9)
    assert torch.equal(many.distances, one.distances)
    assert c_many["buckets"] >= 100 and c_one["buckets"] == 1
    w = g.csr_out.values.clone()
    w[::3] = 0.0
    src = torch.repeat_interleave(torch.arange(g.node_count),
                                  g.out_degrees())
    zero = build_directed(src, g.csr_out.targets, w,
                          node_count=g.node_count, device="cpu")
    got, _ = _run(zero, source, 0.05)
    want = sssp.delta_stepping(zero, sssp.DeltaSteppingConfig(
        source, 0.05, engine="plan"))
    assert torch.equal(got.distances, want.distances)
    assert int((got.distances == 0).sum()) > 1
    sink = int(torch.nonzero(g.out_degrees() == 0)[0])
    alone, c = _run(g, sink, 0.1)
    d = alone.distances_np()
    assert d[sink] == 0 and (np.delete(d, sink) == sssp.INF).all()
    assert c == {"rounds": 1, "buckets": 1, "relaxed": 0}


def test_threads_whose_first_calls_race_share_one_state(monkeypatch):
    """Two threads' first runs on a graph build one near/far state (and so
    share its lock and the loop captured over its buffers), however their
    builds interleave."""
    import threading
    import time

    _, g, _, _ = _case("kron08")
    build = kernels.near_far_state
    builds = []

    def slow(*args):
        builds.append(1)
        time.sleep(0.05)  # the other thread looks the state up meanwhile
        return build(*args)

    monkeypatch.setattr(kernels, "near_far_state", slow)
    gate = threading.Barrier(2)
    got = []

    def first_call():
        gate.wait()
        got.append(sssp._near_far_state(g))

    threads = [threading.Thread(target=first_call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and got[0] is got[1]


def test_the_state_refuses_what_its_counts_cannot_hold():
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="32 bits"):
        kernels.near_far_state(torch.zeros(2, dtype=torch.int64),
                               one.expand(kernels.NEAR_FAR_MAX_ARCS),
                               one.float().expand(kernels.NEAR_FAR_MAX_ARCS))
