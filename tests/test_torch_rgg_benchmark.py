"""The SSSP cell on DIMACS10's random geometric graph
(``dimacs10-rgg-s22.sssp``) on the CPU: the generator against all pairs
compared by brute force, the worklist reference against the full-sweep
one, ``DiGraph.delta_stepping`` with each engine against the reference,
the ``sssp.run`` counter ``relaxed`` and the metrics that read it, the
weighted ``DiGraph.from_numpy``, and the cell itself at scale 9 through
the harness, sound and with faults planted in the port."""

import functools
import json

import numpy as np
import pytest
import torch

from benchmark import harness, spans
from benchmark.generators import graph500_kronecker, rgg
from benchmark.reference import sssp as full_sweep
from benchmark.reference import sssp_worklist
from benchmark.tests.conftest import REPO, load_bench, small_copy
from graph_tpu_torch import api, profile
from graph_tpu_torch.algos import sssp
from graph_tpu_torch.api import DiGraph
from graph_tpu_torch.graph.build import build_directed

CELL = "dimacs10-rgg-s22.sssp"
CONFIG = json.loads(
    (REPO / "benchmark" / "configs" / "dimacs10-rgg-s22.json").read_text())
DELTA = json.loads((REPO / "benchmark" / "traffic" / "rgg-sssp.json")
                   .read_text())["rotation"][0]["params"]["delta"]
ENGINES = ["auto", "plan", "xla", "frontier"]


def _gen(seed):
    g = torch.Generator("cpu")
    g.manual_seed(seed)
    return g


def _rgg(scale, seed):
    return rgg.make(dict(CONFIG, n=1 << scale), _gen(seed))


@functools.lru_cache(maxsize=None)
def _rgg_cached(scale):
    return _rgg(scale, 2**33 + scale)


def _sources(data, count=2):
    return rgg.sources(data, count, _gen(11))


def _as_reference(dist: np.ndarray) -> np.ndarray:
    """The program's float32 distances in the reference's form: float64,
    unreached +inf."""
    out = dist.astype(np.float64)
    out[~(dist < sssp.INF)] = np.inf
    return out


@pytest.mark.parametrize("scale", [8, 9, 10])
def test_the_generator_gives_every_pair_closer_than_r_and_no_other(scale):
    n, seed = 1 << scale, 2**40 + scale
    data = _rgg(scale, seed)
    # the same draws: the points, then the permutation of the ids
    g = _gen(seed)
    xy = torch.rand((n, 2), generator=g, dtype=torch.float64)
    perm = torch.randperm(n, generator=g)
    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(2)
    i, j = torch.nonzero(torch.triu(d2 < rgg.radius(CONFIG | {"n": n}) ** 2,
                                    diagonal=1), as_tuple=True)
    w = torch.round(torch.sqrt(d2[i, j]) * 1e6).clamp(min=1).float()
    want = torch.stack([torch.cat([perm[i], perm[j]]),
                        torch.cat([perm[j], perm[i]])])
    got = torch.stack([data.src, data.dst])
    assert data.n == n and data.m == want.shape[1] > 0
    key_want = want[0] * n + want[1]
    key_got = got[0] * n + got[1]
    assert torch.unique(key_got).numel() == data.m  # each arc once
    order_want, order_got = torch.argsort(key_want), torch.argsort(key_got)
    assert torch.equal(key_got[order_got], key_want[order_want])
    weights = data.weights[order_got]
    assert data.weights.dtype == torch.float32
    assert torch.equal(weights, torch.cat([w, w])[order_want])
    assert bool((weights >= 1).all()) and torch.equal(weights,
                                                      weights.round())
    assert bool((data.src != data.dst).all())


def test_the_same_seed_gives_the_same_graph_in_any_chunking(monkeypatch):
    one = _rgg(10, 5)
    monkeypatch.setattr(rgg, "CHUNK", 7)
    other = _rgg(10, 5)
    assert torch.equal(one.src, other.src) and torch.equal(one.dst, other.dst)
    assert torch.equal(one.weights, other.weights)
    assert not torch.equal(_rgg(10, 6).src[:100], one.src[:100])


def test_the_sources_are_distinct_vertices_with_an_edge():
    data = _rgg_cached(10)
    picked = rgg.sources(data, 64, _gen(3))
    assert len(set(picked)) == 64
    assert bool(torch.isin(torch.tensor(picked), data.src).all())


def _kron(scale):
    return graph500_kronecker.make(
        {"scale": scale, "edgefactor": 8, "A": 0.57, "B": 0.19, "C": 0.19,
         "weights": {"low": 0.0, "high": 1.0}}, _gen(2**35 + scale))


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16],
                         ids=["float64", "bfloat16"])
@pytest.mark.parametrize("graph", ["rgg-8", "rgg-10", "rgg-12", "kron-8",
                                   "kron-10"])
def test_the_worklist_reference_equals_the_full_sweep(graph, dtype):
    family, scale = graph.split("-")
    data = (_rgg_cached(int(scale)) if family == "rgg"
            else _kron(int(scale)))
    for start in [*_sources(data, 3), int(data.n) - 1]:
        want = full_sweep.bellman_ford(data.src, data.dst, data.weights,
                                       data.n, start, dtype=dtype)
        got = sssp_worklist.bellman_ford(data.src, data.dst, data.weights,
                                         data.n, start, dtype=dtype)
        assert got.dtype == dtype and torch.equal(got, want)
        assert bool(torch.isinf(got).any()) == bool(torch.isinf(want).any())


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("scale", [10, 11, 12])
def test_delta_stepping_equals_the_reference_bit_for_bit(scale, engine,
                                                         monkeypatch):
    """Each engine through ``DiGraph.delta_stepping``: the API's config
    made with the engine named."""
    monkeypatch.setattr(api, "DeltaSteppingConfig", functools.partial(
        sssp.DeltaSteppingConfig, engine=engine))
    data = _rgg_cached(scale)
    g = DiGraph(build_directed(data.src, data.dst, data.weights,
                               node_count=data.n, id_dtype=api.ID_DTYPE,
                               device="cpu"))
    for start in _sources(data):
        got = g.delta_stepping(start_node=start, delta=DELTA).distances()
        want = sssp_worklist.bellman_ford(data.src, data.dst, data.weights,
                                          data.n, start).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(_as_reference(got), want)
        assert np.isinf(want).any()  # the small graph has other components


@pytest.mark.parametrize("engine", ["plan", "xla", "frontier"])
def test_relaxed_counts_the_arc_slots_read_with_no_host_read(engine):
    data = _rgg_cached(10)
    g = build_directed(data.src, data.dst, data.weights, node_count=data.n,
                       device="cpu")
    config = sssp.DeltaSteppingConfig(_sources(data)[0], DELTA, engine)
    quiet = sssp.delta_stepping(g, config)
    profile.spans(clear=True)
    with profile.record():
        res = sssp.delta_stepping(g, config)
    run, = [s for s in profile.spans(clear=True) if s["name"] == "sssp.run"]
    rounds = res.ran_iterations
    width = {"plan": g.edge_count, "xla": g.edge_count,
             "frontier": sssp._FRONTIER_CAP * int(g.out_degrees().max())}
    assert rounds > 1 and g.edge_count == data.m
    assert run["counters"] == {"rounds": rounds,
                               "relaxed": rounds * width[engine]}
    assert res.host_reads == quiet.host_reads
    assert torch.equal(res.distances, quiet.distances)


def test_from_numpy_takes_weights():
    data = _rgg_cached(10)
    arr = torch.stack([data.src, data.dst], 1).numpy()
    g = DiGraph.from_numpy(arr, weights=data.weights.numpy(), device="cpu")
    assert (g.node_count(), g.edge_count()) == (data.n, data.m)
    for start in _sources(data):
        got = g.delta_stepping(start_node=start, delta=DELTA).distances()
        want = sssp_worklist.bellman_ford(data.src, data.dst, data.weights,
                                          data.n, start).numpy()
        np.testing.assert_array_equal(_as_reference(got), want)
    with pytest.raises(ValueError, match="weights"):
        DiGraph.from_numpy(arr, weights=data.weights[:-1].numpy(),
                           device="cpu")
    with pytest.raises(ValueError, match="edge weights"):
        DiGraph.from_numpy(arr, device="cpu").delta_stepping(start_node=0,
                                                             delta=DELTA)


@pytest.fixture
def small(tmp_path):
    return load_bench(), small_copy(tmp_path / "benchmark",
                                    {"dimacs10-rgg-s22": {"n": 512}})


def _run(small, trace=False, control=False):
    bench, reg = small
    return harness.run_cell(bench, CELL, 2**33 + 25, 0.3, trace,
                            device="cpu", registry=reg, control=control)


def test_the_cell_reads_correct_with_the_distances_exact(small):
    res = _run(small, control=True)
    assert res["correct"], res["checks"]
    assert res["checks"] == {"sssp.rel_err": {"value": 0.0, "limit": 0.0}}
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"throughput_gevps", "latency_ms.p95",
                                   "setup_s"}
    # the bfloat16 control is off where the program is exact
    assert res["control_numbers"]["sssp.rel_err"] > 0


def _arcs_left_out(monkeypatch, reg):
    """One arc in twenty left out of the program's graph."""
    op = reg.module("ops", "api_delta_stepping")

    def fewer(src, dst, values, **kw):
        keep = torch.arange(src.numel()) % 20 != 0
        return build_directed(src[keep], dst[keep], values[keep], **kw)
    monkeypatch.setattr(op, "build_directed", fewer)


def _plus_one(monkeypatch, reg):
    """One reached node's distance one more."""
    op = reg.module("ops", "api_delta_stepping")
    call = op.call

    def plus_one(cell, req, mark):
        answer = call(cell, req, mark)
        value = answer.value.copy()
        value[int(np.argmax(np.where(value < sssp.INF, value, -1)))] += 1
        return op.Answer(value)
    monkeypatch.setattr(op, "call", plus_one)


@pytest.mark.parametrize("fault", [_arcs_left_out, _plus_one],
                         ids=["arcs-left-out", "plus-one"])
def test_a_fault_in_the_program_reads_not_correct(small, monkeypatch, fault):
    fault(monkeypatch, small[1])
    res = _run(small)
    assert not res["correct"], res["checks"]
    assert res["checks"]["sssp.rel_err"]["value"] > 0


def test_a_traced_run_reads_the_work_per_arc(small, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.2)
    profile.spans(clear=True)
    res = _run(small, trace=True)
    runs = [s for s in profile.spans(clear=True) if s["name"] == "sssp.run"]
    assert res["correct"], res["checks"]
    m = res["metrics"]
    want = sum(s["counters"]["rounds"] for s in runs) / len(runs)
    assert m["relaxed_per_arc.rgg"]["value"] == pytest.approx(want)
    assert m["relaxed_per_arc.rgg"]["unit"] == "arcs/arc"
    # the copies and the requests' events read on the CPU too; the loop's
    # round needs CUDA events
    assert set(m) == {"relaxed_per_arc.rgg", "answer_copy_ms",
                      "device_idle_pct"}
    assert m["answer_copy_ms"]["value"] > 0


def _span(id_, name, parent=None, **counters):
    return {"id": id_, "name": name, "parent": parent, "request": 1,
            "counters": counters}


@pytest.mark.parametrize("recorded,want", [
    # two runs, the loop nested under an API span in one
    ([_span(1, "api.delta_stepping"), _span(2, "sssp.run", 1, rounds=3,
                                            relaxed=3e9),
      _span(3, "loop.run", 2, device_ms=1.0),
      _span(4, "sssp.run", None, rounds=1, relaxed=1e9),
      _span(5, "loop.run", 4, device_ms=1.0),
      _span(6, "loop.run", None, device_ms=9.0)], 500.0),
    # the parent's spans: no counter, the rounds all the same
    ([_span(1, "api.delta_stepping"), _span(2, "sssp.run", 1, rounds=4),
      _span(3, "loop.run", 2, device_ms=2.0)], 500.0),
    # no CUDA events
    ([_span(1, "sssp.run", None, rounds=3, relaxed=30),
      _span(2, "loop.run", 1)], None),
], ids=["two-runs", "no-counter", "no-events"])
def test_the_loop_round_reads_the_api_runs_rounds(monkeypatch, recorded,
                                                  want):
    monkeypatch.setattr(spans, "recorded", lambda: recorded)
    reader = harness.Registry().module("metrics", "loop_round_us")
    got = reader.read(None)
    assert got == (None if want is None else pytest.approx(want))


def test_the_cell_and_its_metrics_are_declared():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    config, = [c for c in spec["configs"] if c["name"] == "dimacs10-rgg-s22"]
    assert config["reduced"] == [] == CONFIG["reduced"]
    assert config["file"] == "benchmark/configs/dimacs10-rgg-s22.json"
    cell, = [w for w in spec["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "dimacs10-rgg-s22", "rgg-sssp", 1)
    by_name = {m["name"]: m for m in spec["end_to_end"] + spec["per_layer"]}
    for name in ("throughput_gevps", "latency_ms.p95", "loop_round_us",
                 "answer_copy_ms", "device_idle_pct"):
        assert CELL in by_name[name]["workloads"]
    assert by_name["relaxed_per_arc.rgg"]["workloads"] == [CELL]
    assert by_name["relaxed_per_arc.rgg"]["moves"] == "throughput_gevps"
    assert by_name["relaxed_per_arc.rgg"]["source"] == "program_span"
    assert CONFIG["limits"] == {"sssp": {"rel_err": 0.0}}
