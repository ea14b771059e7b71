"""graph_tpu_torch.profile's spans and counters: off and on, nesting and
requests across threads, the trace's time base, the buffer's bound, and
the counters each layer sets (the device loop's, the answer copies', the
graph build's, the plan cache's, the drivers').

The card tests at the end skip without a CUDA device.  The file imports
neither JAX nor graph_tpu, so on the card it runs as

    python -m pytest --noconftest -m requires_cuda tests/test_torch_spans.py
"""

import json
import re
import threading

import numpy as np
import pytest
import torch

import graph_tpu_torch as gtt
from graph_tpu_torch import api, profile
from graph_tpu_torch.algos import triangle_count as ttc
from graph_tpu_torch.engine import kernels, loop
from graph_tpu_torch.engine.engine import EdgeEngine
from graph_tpu_torch.engine.plan import PLAN_CACHE_ENV


@pytest.fixture(autouse=True)
def empty_buffer():
    profile.spans(clear=True)
    yield
    profile.spans(clear=True)


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def _edges(seed=4, n=64, m=400):
    g = np.random.default_rng(seed)
    return g.integers(0, n, m), g.integers(0, n, m)


def test_off_records_nothing_and_adds_no_trace_event(tmp_path):
    assert not profile.on()
    with profile.span("off.outer", bytes=1) as sp:
        assert not sp
        sp.count(bytes=2)
        sp.cuda_events("cpu")
        with profile.annotate("off.inner"):
            profile.count(rounds=3)
    src, dst = _edges()
    gtt.page_rank(gtt.build_directed(src, dst, node_count=64, device="cpu"))
    assert profile.spans() == [] and profile.dropped() == 0
    with profile.trace(str(tmp_path)) as log_dir:
        torch.ones(4).sum()
    names = {e.get("name") for e in json.loads(
        profile.newest_trace(log_dir).read_text())["traceEvents"]}
    assert not names & {"off.outer", "off.inner", "graph.build",
                        "page_rank.run", "loop.run"}


def test_nesting_gives_parents_and_requests_across_two_threads():
    ready = threading.Barrier(2)

    def work(tag):
        for _ in range(2):  # two requests a thread
            with profile.span(f"{tag}.request", who=tag):
                ready.wait()
                with profile.span(f"{tag}.child"):
                    with profile.span(f"{tag}.leaf") as leaf:
                        leaf.count(depth=2)
                    profile.count(closed_leaf=True)
                with profile.span(f"{tag}.second"):
                    pass

    with profile.record():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    spans = profile.spans()
    assert len(spans) == 16
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == 16
    requests = set()
    for tag in "ab":
        roots = _named(spans, f"{tag}.request")
        assert len(roots) == 2 and len({s["thread"] for s in roots}) == 1
        for root in roots:
            assert root["parent"] is None and root["request"] == root["id"]
            assert root["counters"] == {"who": tag}
            requests.add(root["id"])
            kids = [s for s in spans if s["request"] == root["id"]]
            assert {s["name"] for s in kids} == {
                f"{tag}.request", f"{tag}.child", f"{tag}.leaf",
                f"{tag}.second"}
            assert all(s["thread"] == root["thread"] for s in kids)
            child, = (s for s in kids if s["name"] == f"{tag}.child")
            leaf, = (s for s in kids if s["name"] == f"{tag}.leaf")
            second, = (s for s in kids if s["name"] == f"{tag}.second")
            assert child["parent"] == second["parent"] == root["id"]
            assert leaf["parent"] == child["id"]
            assert leaf["counters"] == {"depth": 2}
            assert child["counters"] == {"closed_leaf": True}
            assert (root["start_us"] <= child["start_us"] <= leaf["start_us"]
                    <= leaf["end_us"] <= child["end_us"]
                    <= second["start_us"] <= second["end_us"]
                    <= root["end_us"])
    assert len(requests) == 4
    assert {s["thread"] for s in spans} == {
        r["thread"] for r in _named(spans, "a.request")} | {
        r["thread"] for r in _named(spans, "b.request")}


def _misaligned_us(log_dir) -> float:
    """The largest distance, in µs, between a span's start or end and its
    ``user_annotation`` event's, over five spans and their children."""
    with profile.trace(log_dir) as log_dir:
        assert profile.on()
        with profile.span("first"):  # the profiler's first range is slow
            pass
        for i in range(5):
            with profile.span("aligned.outer", i=i):
                torch.ones(64).cumsum(0)
                with profile.span("aligned.inner"):
                    torch.ones(64).sum()
    data = json.loads(profile.newest_trace(log_dir).read_text())
    # the trace's base (ns before Unix time): the same as the spans', if
    # the exporter writes one
    shift_us = (data.get("baseTimeNanoseconds", profile.BASE_NS)
                - profile.BASE_NS) * 1e-3
    spans = profile.spans(clear=True)
    worst = 0.0
    for name in ("aligned.outer", "aligned.inner"):
        events = sorted((e for e in data["traceEvents"]
                         if e.get("name") == name
                         and e.get("cat") == "user_annotation"),
                        key=lambda e: float(e["ts"]))
        mine = sorted(_named(spans, name), key=lambda s: s["start_us"])
        assert len(events) == len(mine) == 5
        for e, s in zip(events, mine):
            start = float(e["ts"]) + shift_us
            worst = max(worst, abs(s["start_us"] - start),
                        abs(s["end_us"] - (start + float(e["dur"]))))
    return worst


def test_span_times_match_the_trace_within_50us(tmp_path):
    # a busy host may preempt the thread between the two clocks' reads:
    # the best of three traces holds every span to 50 µs
    worst = [_misaligned_us(str(tmp_path / str(i))) for i in range(3)]
    assert min(worst) < 50, worst


def _fake_kernel(x):
    kernels.LAUNCHES["k1_gather"] += 2
    kernels.LAUNCHES["k2_reduce"] += 1
    return x


def _step(state):
    """Three bodies a pass: (x + 1, k + 1, k % 3 != 0, outer flag)."""
    x, k, _, more = state
    k = k + 1
    return _fake_kernel(x) + 1, k, (k % 3 != 0).to(torch.int32), more


def _next_pass(state):
    x, k, _, _ = state
    return x, k, torch.ones_like(k), (x[0] < 6).to(torch.int32)


@pytest.mark.parametrize("nested", [False, True])
def test_loop_run_on_host_while_counts_bodies_and_launches(nested):
    """A host loop's ``loop.run``: its bodies (each loop's, outer first),
    host reads, and the growth of ``kernels.LAUNCHES``."""
    one = torch.tensor(1, dtype=torch.int32)
    state = (torch.zeros(3, dtype=torch.int32),
             torch.tensor(0, dtype=torch.int32), one, one)
    if nested:  # two passes of three bodies
        body, cond = (loop.While(_step, loop.Flag(2)), _next_pass), \
            loop.Flag(3)
    else:  # one pass
        body, cond = _step, loop.Flag(2)
    before = dict(kernels.LAUNCHES)
    with profile.record():
        run = loop.device_while(body, state, cond)
    grown = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
             if v != before[k]}
    span, = _named(profile.spans(), "loop.run")
    c = span["counters"]
    assert (run.iterations, run.inner) == ((2, (6,)) if nested else (3, ()))
    assert c["bodies"] == [run.iterations, *run.inner]
    assert c["host_reads"] == run.host_reads > 0
    steps = 6 if nested else 3
    assert c["launches"] == grown == {"k1_gather": 2 * steps,
                                      "k2_reduce": steps}
    assert "device_ms" not in c and "cached" not in c


class _Answer:
    def __init__(self, t):
        self.scores = self.components = self.distances = t
        self.ran_iterations = 1
        self.error = 0.0
        self.micros = 1


COPIES = {
    "api.PageRankResult.scores": lambda t: api.PageRankResult(
        _Answer(t)).scores(),
    "api.WccResult.components": lambda t: api.WccResult(
        _Answer(t)).components(),
    "api.SsspResult": lambda t: api.SsspResult(_Answer(t)).distances(),
    "WccResult.components_np": lambda t: gtt.WccResult(
        components=t, ran_iterations=1, micros=1).components_np(),
    "SsspResult.distances_np": lambda t: gtt.SsspResult(
        distances=t, micros=1).distances_np(),
    "PageRankResult.scores_np": lambda t: gtt.PageRankResult(
        scores=t, ran_iterations=1, error=0.0, micros=1).scores_np(),
}


@pytest.mark.parametrize("site", sorted(COPIES))
def test_result_to_host_counts_the_arrays_bytes(site):
    t = torch.arange(1000, dtype=torch.float32)
    with profile.record():
        out = COPIES[site](t)
    copies = _named(profile.spans(), "result.to_host")
    assert isinstance(out, np.ndarray) and out.nbytes == 4000
    assert [s["counters"] for s in copies] == [{"bytes": out.nbytes}]


def test_api_spans_over_a_request_and_its_layers():
    src, dst = _edges()
    arr = np.stack([src, dst], axis=1).astype(np.uint32)
    with profile.record():
        g = api.DiGraph.from_numpy(arr, device="cpu")
        res = g.page_rank(max_iterations=5, tolerance=0.0)
        res.scores()
        g.wcc().components()
    spans = profile.spans()
    by_id = {s["id"]: s for s in spans}
    outer, inner = sorted(_named(spans, "graph.build"),
                          key=lambda s: s["start_us"])
    assert outer["parent"] is None and inner["parent"] == outer["id"]
    hosts = _named(spans, "graph.build.host")
    # the int64 cast, then each CSR direction's two column copies
    assert len(hosts) == 5 and all(s["request"] == outer["id"]
                                   for s in hosts)
    assert not _named(spans, "graph.build.h2d")  # the CPU: no transfer
    pr, = _named(spans, "api.page_rank")
    eng = [s for s in _named(spans, "engine.build")
           if s["parent"] == pr["id"]]
    assert len(eng) == 1 and eng[0]["counters"] == {"plan_cache": "off"}
    run, = _named(spans, "page_rank.run")
    assert run["parent"] == pr["id"] and run["counters"] == {
        "rounds": res.ran_iterations} == {"rounds": 5}
    lr = [s for s in _named(spans, "loop.run") if s["parent"] == run["id"]]
    assert len(lr) == 1 and lr[0]["counters"]["bodies"] == [5]
    iters = [s for s in _named(spans, "page_rank.iteration")
             if by_id[s["parent"]]["name"] == "loop.run"]
    assert len(iters) == 5 and all(s["request"] == pr["id"] for s in iters)
    wcc, = _named(spans, "api.wcc")
    wrun, = _named(spans, "wcc.run")
    assert wrun["parent"] == wcc["id"] and wrun["counters"]["rounds"] >= 1
    assert [s["request"] for s in _named(spans, "result.to_host")] == [
        s["id"] for s in _named(spans, "result.to_host")]


def test_sssp_driver_spans_count_rounds():
    src, dst = _edges(seed=6)
    w = np.random.default_rng(1).uniform(0.5, 2.0, src.size).astype(
        np.float32)
    g = gtt.build_directed(src, dst, w, node_count=64, device="cpu")
    with profile.record():
        results = [gtt.delta_stepping(g, gtt.DeltaSteppingConfig(
            0, 1.0, engine=engine)) for engine in ("plan", "xla",
                                                    "frontier")]
    runs = _named(profile.spans(), "sssp.run")
    assert [s["counters"]["rounds"] for s in runs] == [
        r.ran_iterations for r in results]
    assert all(r.ran_iterations > 0 for r in results)


@pytest.mark.parametrize("cache", ["off", "miss", "hit"])
def test_engine_build_counts_the_plan_cache(cache, tmp_path, monkeypatch):
    monkeypatch.delenv(PLAN_CACHE_ENV, raising=False)
    src, dst = _edges(seed=8)
    cache_dir = None if cache == "off" else str(tmp_path)
    if cache == "hit":
        EdgeEngine.build(src, dst, 64, cache_dir=cache_dir, device="cpu")
    with profile.record():
        EdgeEngine.build(src, dst, 64, cache_dir=cache_dir, device="cpu")
    span, = _named(profile.spans(), "engine.build")
    assert span["counters"] == {"plan_cache": cache}


def test_buffer_keeps_the_newest_up_to_its_bound(monkeypatch):
    monkeypatch.setattr(profile, "LIMIT", 4)
    with profile.record():
        for i in range(10):
            with profile.span("bounded", i=i):
                pass
    assert profile.dropped() == 6
    assert [s["counters"]["i"] for s in profile.spans()] == [6, 7, 8, 9]
    # read without clearing: the same again; cleared: empty, none dropped
    assert len(profile.spans(clear=True)) == 4
    assert profile.spans() == [] and profile.dropped() == 0


def test_record_nests_and_ends_with_its_block():
    with profile.record():
        with profile.record():
            assert profile.on()
        assert profile.on()
        with profile.annotate("recorded") as sp:
            assert sp
    assert not profile.on()
    with profile.span("not recorded"):
        pass
    assert [s["name"] for s in profile.spans()] == ["recorded"]


def _tc_graph(device="cpu"):
    """A DEDUPLICATED undirected graph with self-loops and repeated pairs
    in its input, and some 3,600 triangles."""
    src, dst = _edges(seed=9, n=200, m=3000)
    return api.Graph.from_numpy(np.stack([src, dst], axis=1),
                                layout=api.Layout.Deduplicated, device=device)


@pytest.mark.parametrize("host", [False, True])
def test_triangle_count_spans_hold_its_phases(host):
    """The count's spans and counters, from a graph on the CPU (through the
    API) and from a host-resident graph counted on the CPU.  Either way
    the preparation runs where the join runs: ``on_card`` 0 and no child
    span."""
    g = _tc_graph()
    if host:
        src, dst = _edges(seed=9, n=200, m=3000)
        inner = gtt.build_undirected_host(src, dst,
                                          layout=gtt.CsrLayout.DEDUPLICATED)

        def count():
            return ttc.global_triangle_count(inner, device="cpu")
    else:
        inner, count = g._g, g.global_triangle_count
    fwd = ttc._prepare_distinct(inner, {}, torch.device("cpu"))
    with profile.record():
        res = count()
        phases = ttc.global_triangle_count(inner, device="cpu").phases
    spans = profile.spans()
    root = (_named(spans, "triangle_count.run") if host
            else _named(spans, "api.global_triangle_count"))[0]
    run = [s for s in _named(spans, "triangle_count.run")
           if s["request"] == root["id"]]
    assert len(run) == 1 and res.triangles > 0
    run = run[0]
    kids = {s["name"]: s for s in spans if s["parent"] == run["id"]}
    assert sorted(kids) == ["triangle_count.join", "triangle_count.orient",
                            "triangle_count.pack"]
    orient, pack, join = (kids[f"triangle_count.{k}"]
                          for k in ("orient", "pack", "join"))
    assert not [s for s in spans if s["parent"] == orient["id"]]
    assert run["counters"] == {k: phases[k] for k in (
        "forward_edges", "wedges", "wedge_slots", "slabs")}
    assert orient["counters"] == {
        "forward_edges": phases["forward_edges"], "on_card": 0}
    assert pack["counters"] == {
        "wedges": phases["wedges"],
        "heads": fwd.long_heads.numel() + fwd.short_heads.numel(),
        "long_heads": fwd.long_heads.numel()}
    assert phases["wedge_slots"] == phases["wedges"] and phases["slabs"] == 1
    assert join["counters"] == {
        "wedge_slots": phases["wedge_slots"], "slabs": phases["slabs"]}
    assert all(s["request"] == root["id"]
               for s in (run, orient, pack, join))


def test_triangle_count_records_nothing_with_spans_off():
    g = _tc_graph()
    assert g.global_triangle_count().triangles > 0
    assert profile.spans() == []


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device loop has no CPU mode")
    return torch.device("cuda")


def _rmat(device, weighted=False):
    from graph_tpu_torch.generate import host_rmat

    src, dst = host_rmat(12, seed=5)
    w = (np.random.default_rng(3).random(src.size) * 4).astype(np.float32)
    return gtt.build_directed(src, dst, w if weighted else None,
                              node_count=1 << 12, device=device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("algo", ["page_rank", "wcc", "sssp"])
def test_loop_run_device_time_and_bodies_on_card(cuda_device, algo):
    g = _rmat(cuda_device, weighted=True)
    call = {"page_rank": lambda: gtt.page_rank(g),
            "wcc": lambda: gtt.wcc(g),
            "sssp": lambda: gtt.delta_stepping(
                g, gtt.DeltaSteppingConfig(0, 3.0, engine="plan"))}[algo]
    with profile.record():
        first = call()   # captured
        second = call()  # from the cache
    spans = profile.spans()
    runs = _named(spans, "loop.run")
    assert [s["counters"]["cached"] for s in runs] == [False, True]
    assert len(_named(spans, "loop.capture")) == 1
    assert len(_named(spans, "loop.instantiate")) == 1
    drivers = _named(spans, f"{algo}.run")
    for res, run, driver in zip((first, second), runs, drivers):
        c = run["counters"]
        assert c["bodies"] == [res.ran_iterations] and c["host_reads"] == 1
        assert 0 < c["device_ms"] <= (run["end_us"] - run["start_us"]) * 1e-3
        assert run["parent"] == driver["id"]
        want = {"rounds": res.ran_iterations}
        if algo == "sssp":  # every arc slot relaxed each round
            want["relaxed"] = res.ran_iterations * g.edge_count
        assert driver["counters"] == want


@pytest.mark.requires_cuda
def test_near_far_run_device_time_and_bodies_on_card(cuda_device):
    """SSSP's near/far queues (``auto`` on the card): a loop over buckets
    whose body is the settle loop, so the ``loop.run`` span counts
    [buckets, settle steps]; the driver's counters are the steps, the
    buckets and the arcs relaxed, read back after the loop."""
    g = _rmat(cuda_device, weighted=True)
    start = int(g.out_degrees().argmax())
    with profile.record():
        first = gtt.delta_stepping(g, gtt.DeltaSteppingConfig(start, 3.0))
        second = gtt.delta_stepping(g, gtt.DeltaSteppingConfig(start, 3.0))
    spans = profile.spans()
    runs = _named(spans, "loop.run")
    assert [s["counters"]["cached"] for s in runs] == [False, True]
    assert len(_named(spans, "loop.capture")) == 1
    drivers = _named(spans, "sssp.run")
    reached = first.distances < float(np.finfo(np.float32).max)
    arcs = int(g.out_degrees()[reached].sum())
    for res, run, driver in zip((first, second), runs, drivers):
        c, d = run["counters"], driver["counters"]
        assert c["bodies"] == [d["buckets"], res.ran_iterations]
        assert c["host_reads"] == 1 and res.host_reads == 2
        assert 0 < c["device_ms"] <= (run["end_us"] - run["start_us"]) * 1e-3
        assert run["parent"] == driver["id"]
        assert set(d) == {"rounds", "buckets", "relaxed"}
        assert d["rounds"] == res.ran_iterations >= d["buckets"] >= 1
        assert arcs <= d["relaxed"] <= 8 * arcs


@pytest.mark.requires_cuda
def test_wcc_loop_launches_match_its_kernel_nodes_on_card(cuda_device):
    g = _rmat(cuda_device)
    with profile.record():
        res = gtt.wcc(g)
    run, = _named(profile.spans(), "loop.run")
    from graph_tpu_torch.algos.wcc import _sym_engine

    dl = _sym_engine(g).loops["wcc"]
    nodes = {name: [sum(bool(re.search(pattern, n))
                        for n in loop.kernel_nodes(graph))
                    for graph in dl.graphs]
             for name, pattern in kernels.KERNEL_NODES.items()}
    bodies = res.ran_iterations
    expect = {name: sum(k * runs(bodies) for k, (_, runs, _) in
                        zip(per_graph, dl.per_body))
              for name, per_graph in nodes.items()}
    assert run["counters"]["launches"] == {k: v for k, v in expect.items()
                                           if v}
    assert run["counters"]["launches"] == {"k1_gather": bodies,
                                           "k2_reduce_min": bodies}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("pair", [True, False])
def test_page_rank_loop_launches_match_its_kernel_nodes_on_card(
        cuda_device, pair, monkeypatch):
    """The plan engine's captured body holds K1, K2 and each Jacobi tail
    kernel once, on two sets of buffers or one; ``loop.run`` counts each
    once a body."""
    monkeypatch.setattr(loop, "PAIR_MIN_BYTES", 0 if pair else 1 << 62)
    g = _rmat(cuda_device)
    with profile.record():
        res = gtt.page_rank(g, gtt.PageRankConfig(tolerance=0.0))
    run, = _named(profile.spans(), "loop.run")
    from graph_tpu_torch.algos.pagerank import _graph_engine

    dl, = _graph_engine(g).loops.values()
    assert len(dl.graphs) == (2 if pair else 1)
    for graph in dl.graphs:
        names = loop.kernel_nodes(graph)
        assert {name: sum(bool(re.search(pattern, n)) for n in names)
                for name, pattern in kernels.KERNEL_NODES.items()} == {
            "k1_gather": 1, "k1_gather_weighted": 0, "k2_reduce": 1,
            "k2_reduce_min": 0, "jacobi_quantize": 1, "jacobi_update": 1,
            "tc_count": 0, "sssp_frontier_reset": 0,
            "sssp_frontier_relax": 0, "sssp_frontier_advance": 0}
    bodies = res.ran_iterations
    assert bodies == 20
    assert run["counters"]["launches"] == {
        "k1_gather": bodies, "k2_reduce": bodies, "jacobi_quantize": bodies,
        "jacobi_update": bodies}


@pytest.mark.requires_cuda
def test_wcc_and_sssp_loops_launch_no_jacobi_tails_on_card(cuda_device):
    g = _rmat(cuda_device, weighted=True)
    with profile.record():
        gtt.wcc(g)
        gtt.delta_stepping(g, gtt.DeltaSteppingConfig(0, 3.0))
    runs = _named(profile.spans(), "loop.run")
    assert len(runs) == 2
    for run in runs:
        assert not {"jacobi_quantize", "jacobi_update"} & set(
            run["counters"]["launches"])


@pytest.mark.requires_cuda
def test_h2d_spans_carry_bytes_and_device_time_on_card(cuda_device):
    src, dst = _edges(m=1 << 16)
    arr = np.stack([src, dst], axis=1)
    with profile.record():
        api.DiGraph.from_numpy(arr, device=cuda_device)
    h2d = _named(profile.spans(), "graph.build.h2d")
    assert len(h2d) == 4
    for s in h2d:
        assert s["counters"]["bytes"] == 8 << 16
        assert s["counters"]["device_ms"] > 0


@pytest.mark.requires_cuda
def test_triangle_count_join_span_times_the_card(cuda_device):
    g = _tc_graph(cuda_device)
    with profile.record():
        g.global_triangle_count()
    join, = _named(profile.spans(), "triangle_count.join")
    c = join["counters"]
    assert 0 < c["device_ms"] <= (join["end_us"] - join["start_us"]) * 1e-3
    assert c["wedge_slots"] > 0 and c["slabs"] == 1


@pytest.mark.requires_cuda
def test_triangle_count_prepares_on_card(cuda_device):
    """At RMAT scale 16, DEDUPLICATED: the count on the card equals the
    CPU's; the preparation's tensors lie on the card, and the orient span
    reads ``on_card`` 1 and has no child; four shards of ``parallel.tc`` on the one card count the same."""
    from graph_tpu_torch.generate import host_rmat
    from graph_tpu_torch.parallel.mesh import Mesh
    from graph_tpu_torch.parallel.tc import triangle_count_sharded

    src, dst = host_rmat(16, seed=7)
    g, on_cpu = (gtt.build_undirected(src, dst, node_count=1 << 16,
                                      device=d,
                                      layout=gtt.CsrLayout.DEDUPLICATED)
                 for d in (cuda_device, "cpu"))
    fwd = ttc._prepare_distinct(g, {}, cuda_device)
    assert all(t.is_cuda for t in fwd)
    with profile.record():
        res = gtt.global_triangle_count(g)
    spans = profile.spans()
    orient, = _named(spans, "triangle_count.orient")
    assert orient["counters"]["on_card"] == 1
    assert not [s for s in spans if s["parent"] == orient["id"]]
    want = gtt.global_triangle_count(on_cpu).triangles
    assert res.triangles == want > 0
    sharded = triangle_count_sharded(g, Mesh([cuda_device] * 4))
    assert sharded.triangles == want and sharded.phases["shards"] == 4
