"""The benchmark's yardstick on the CPU: generators, byte counts, the
end-to-end arithmetic, the reference, and cells found by name."""

import json
import random
import types

import numpy as np
import pytest
import torch

from benchmark import harness, schedule, stats, work
from benchmark.generators import graph500_kronecker
from benchmark.reference import pagerank, sssp, wcc
from benchmark.tests.conftest import load_bench, small_copy


def _gen(seed):
    g = torch.Generator("cpu")
    g.manual_seed(seed)
    return g


KRON = {"scale": 8, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19,
        "weights": {"low": 0.0, "high": 1.0}}


def test_generator_repeats_per_seed_and_differs_across_seeds():
    big = 2**31 + 12345  # the driver's seeds pass 32 signed bits
    module = graph500_kronecker
    a, b = module.make(KRON, _gen(big)), module.make(KRON, _gen(big))
    c = module.make(KRON, _gen(big + 1))
    for x, y in ((a.src, b.src), (a.dst, b.dst), (a.weights, b.weights)):
        assert torch.equal(x, y)
    assert not torch.equal(a.weights, c.weights)
    assert not torch.equal(a.src, c.src)
    assert module.sources(a, 4, _gen(big)) == module.sources(b, 4, _gen(big))


def test_graph500_sizes_and_ranges():
    d = graph500_kronecker.make(KRON, _gen(3))
    assert (d.n, d.m) == (256, 16 * 256)
    assert int(d.src.min()) >= 0 and int(d.src.max()) < d.n
    assert float(d.weights.min()) >= 0.0 and float(d.weights.max()) < 1.0
    keys = graph500_kronecker.sources(d, 64, _gen(4))
    outdeg = torch.bincount(d.src, minlength=d.n)
    assert len(set(keys)) == 64 and all(int(outdeg[k]) > 0 for k in keys)


def test_byte_counts_give_the_kernel_tables_bounds_at_rmat22():
    n, m = 1 << 22, 16 << 22
    assert work.bound_s(work.k1_gather_bytes(n, m)) * 1e3 == \
        pytest.approx(0.1653, abs=5e-5)
    assert work.bound_s(work.k2_reduce_bytes(n, m)) * 1e3 == \
        pytest.approx(0.0952, abs=5e-5)
    assert 20 * work.bound_s(work.jacobi_iteration_bytes(n, m)) * 1e3 == \
        pytest.approx(2.3037, abs=5e-5)


def _rec(op, work_, start, end, micros=None, iterations=None):
    r = types.SimpleNamespace(op=op, kind="page_rank", work=work_,
                              error=None, latency_s=end - start,
                              device={"start": start, "end": end},
                              micros=micros, iterations=iterations,
                              nodes=10, edges=20, extra={})
    return r


def test_throughput_is_all_work_over_the_whole_window_and_p95_all_requests(
        small):
    _, reg = small
    recs = [_rec("x", 100, i, i + 0.5 + 0.01 * i) for i in range(40)]
    failed = _rec("x", 100, 40, 41)
    failed.error = "boom"
    run = harness.Run(None, recs + [failed], window_s=50.0, setup_s=7.0)
    gevps = reg.module("metrics", "throughput_gevps").read(run)
    assert gevps == pytest.approx(40 * 100 / 50.0 / 1e9)
    p95 = reg.module("metrics", "latency_ms.p95").read(run)
    lat = [r.latency_s for r in recs + [failed]]
    assert p95 == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert reg.module("metrics", "setup_s").read(run) == 7.0


def test_round_us_sums_micros_over_rounds(small):
    _, reg = small
    recs = [_rec("delta_stepping", 1, 0, 1, micros=1000, iterations=10),
            _rec("delta_stepping", 1, 1, 2, micros=5000, iterations=40)]
    run = harness.Run(None, recs, window_s=2.0, setup_s=0.0)
    assert reg.module("metrics", "round_us.sssp").read(run) == 120.0
    assert reg.module("metrics", "round_us.wcc").read(run) is None


def test_idle_union_handles_overlapping_intervals(small):
    assert stats.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert stats.union_length([]) == 0.0
    assert stats.gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == \
        [(0, 1), (3, 4), (5, 6)]
    _, reg = small
    recs = [_rec("x", 1, 0.0, 2.0), _rec("x", 1, 1.0, 3.0),
            _rec("x", 1, 4.0, 5.0)]
    run = harness.Run(None, recs, window_s=5.0, setup_s=0.0)
    assert reg.module("metrics", "device_idle_pct").read(run) == \
        pytest.approx(20.0)


def test_reference_sssp_gives_the_reference_crates_golden():
    # crates/algos/src/sssp.rs's six-node graph: a..f = 0..5
    edges = [(0, 1, 4.0), (0, 2, 2.0), (1, 2, 5.0), (1, 3, 10.0),
             (2, 4, 3.0), (3, 5, 11.0), (4, 3, 4.0)]
    src = torch.tensor([e[0] for e in edges])
    dst = torch.tensor([e[1] for e in edges])
    w = torch.tensor([e[2] for e in edges], dtype=torch.float32)
    dist = sssp.bellman_ford(src, dst, w, 6, 0)
    assert dist.tolist() == [0.0, 4.0, 2.0, 9.0, 5.0, 20.0]
    assert sssp.bellman_ford(src, dst, w, 7, 0)[6] == float("inf")


def test_reference_wcc_and_pagerank_on_small_graphs():
    src, dst = torch.tensor([3, 1, 5]), torch.tensor([4, 2, 3])
    assert wcc.min_label(src, dst, 7).tolist() == [0, 1, 1, 3, 3, 3, 6]
    # a 3-cycle: every score stays 1/3
    scores, it = pagerank.jacobi(torch.tensor([0, 1, 2]),
                                 torch.tensor([1, 2, 0]), 3,
                                 damping_factor=0.85, tolerance=1e-4,
                                 max_iterations=20)
    assert it == 1 and torch.allclose(scores, torch.full((3,), 1 / 3,
                                                         dtype=torch.float64))


def test_compare_reads_wrong_answers():
    reg = harness.Registry()
    page_rank, sssp_, wcc_ = (reg.module("kinds", k)
                              for k in ("page_rank", "sssp", "wcc"))
    r = np.array([0.5, 0.3, 0.2])
    assert page_rank.compare(r.astype(np.float32), r)["max_rel"] < 1e-7
    assert page_rank.compare(np.array([0.5, 0.3, 0.1]), r)["max_rel"] == \
        pytest.approx(0.5)
    ref = np.array([0.0, 1.0, np.inf])
    unreached = sssp_.UNREACHED
    assert sssp_.compare(np.array([0.0, 1.0, unreached]), ref)["rel_err"] == 0
    assert sssp_.compare(np.array([0.0, unreached, unreached]),
                         ref)["rel_err"] == float("inf")
    assert sssp_.compare(np.array([0.0, 1.0, 3.0]), ref)["rel_err"] == \
        float("inf")
    assert wcc_.compare(np.array([0, 0, 2]), np.array([0, 0, 0])) == \
        {"mismatched": 1.0}


def test_schedule_keeps_the_mix_and_deals_every_source():
    ops = {"a": types.SimpleNamespace(SOURCE=False),
           "b": types.SimpleNamespace(SOURCE=True)}
    traffic = {"rotation": [{"op": "a", "weight": 2}, {"op": "b"}]}
    for seed in (1, 2):
        stream = schedule.requests(traffic, ops, [10, 11, 12, 13],
                                   random.Random(seed))
        reqs = [next(stream) for _ in range(12)]
        for c in range(4):
            cycle = [r.op_name for r in reqs[3 * c:3 * c + 3]]
            assert sorted(cycle) == ["a", "a", "b"]
        assert sorted(r.source for r in reqs if r.op_name == "b") == \
            [10, 11, 12, 13]


def test_sample_keeps_copies_and_the_longest_request():
    s = schedule.Sample(2, random.Random(0))
    s.reserve("k", np.zeros(3))
    for i in range(50):
        answer = np.full(3, float(i))
        s.offer("k", 10.0 if i == 17 else 1.0, i, answer)
        answer[:] = -1  # the program's array may be reused or freed
    items = s.items()
    assert len(items) == 3 and (17, [17.0] * 3) in [
        (r, v.tolist()) for r, v in items]
    assert all(v.tolist() == [float(r)] * 3 for r, v in items)


def test_a_config_mix_and_metric_added_by_name_are_found(tmp_path,
                                                        monkeypatch):
    """A new configuration, traffic mix and per-layer metric are files;
    the harness runs the new cell without an edit."""
    reg = small_copy(tmp_path / "benchmark")
    root = reg.root
    config = json.loads((root / "configs" / "graph500-s22.json").read_text())
    config.update(name="rmat-7", scale=7, n=128, m=16 * 128)
    (root / "configs" / "rmat-7.json").write_text(json.dumps(config))
    (root / "traffic" / "two-sources.json").write_text(json.dumps(
        {"rotation": [{"op": "delta_stepping", "params": {"delta": 1.0}}],
         "sources": 4, "warmup": 1, "sample": 1}))
    (root / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(len(run.of()))\n")
    bench = load_bench()
    bench["configs"].append({"name": "rmat-7"})
    bench["workloads"].append({"name": "rmat-7.two", "config": "rmat-7",
                               "traffic": "two-sources", "chips": 1})
    bench["per_layer"].append({"name": "requests_done", "unit": "1",
                               "workloads": ["rmat-7.two"]})
    bench["end_to_end"][0]["workloads"].append("rmat-7.two")
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.2)
    res = harness.run_cell(bench, "rmat-7.two", 9, 0.2, True,
                           device="cpu", registry=reg)
    assert res["correct"], res["checks"]
    assert res["metrics"]["requests_done"]["value"] == res["attempted"]
    assert "device_idle_pct" not in res["metrics"]
    assert list(res)[-1] == "checks"
    res = harness.run_cell(bench, "rmat-7.two", 9, 0.2, False,
                           device="cpu", registry=reg)
    assert set(res["metrics"]) == {"throughput_gevps", "setup_s"}


TC_KIND = '''"""One exact count, held against an int64 reference."""

import numpy as np
import torch

REFERENCE = torch.int64
CONTROL = torch.float32


def compare(answer, ref):
    """``off``: how far the count lies from the reference's."""
    a = np.asarray(answer, dtype=np.float64)
    r = np.asarray(ref, dtype=np.float64)
    if a.shape != r.shape:
        return {"off": float("inf")}
    return {"off": float(np.abs(a - r).max())}
'''

TC_OP = '''"""Global triangle count of the DEDUPLICATED undirected graph built in
set-up; the reference is trace(A^3) / 6 of the dense 0/1 matrix."""

import numpy as np
import torch

from benchmark.ops import Answer
from graph_tpu_torch.algos.triangle_count import global_triangle_count
from graph_tpu_torch.graph import CsrLayout
from graph_tpu_torch.graph.build import build_undirected

KIND = "triangle_count"
SOURCE = False


def undirected(cell):
    d = cell.data
    return build_undirected(d.src, d.dst, node_count=d.n,
                            layout=CsrLayout.DEDUPLICATED, device=cell.device)


GRAPH = undirected


def call(cell, req, mark):
    res = global_triangle_count(cell.graph(GRAPH))
    mark("call")
    return Answer(np.array([res.triangles]), micros=res.micros)


def nodes(cell):
    return cell.data.n


def ref_key(req):
    return (KIND,)


def reference(cell, req, dtype):
    d = cell.data
    src, dst = d.src.cpu(), d.dst.cpu()
    a = torch.zeros((d.n, d.n), dtype=dtype)
    a[src, dst] = 1
    a[dst, src] = 1
    a.fill_diagonal_(0)
    return torch.div(torch.trace(a @ a @ a), 6,
                     rounding_mode="floor").reshape(1)
'''


def test_a_kind_added_by_name_is_found(tmp_path, monkeypatch):
    """A triangle-count cell, its kind of answer included, is new files
    only: the harness reads its count exact, and one off as not correct."""
    reg = small_copy(tmp_path / "benchmark")
    root = reg.root
    held = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    config = json.loads((root / "configs" / "graph500-s22.json").read_text())
    config.update(name="graph500-s7", scale=7, n=128, m=16 * 128,
                  limits={"triangle_count": {"off": 0}})
    del config["weights"]
    new = {"configs/graph500-s7.json": json.dumps(config),
           "traffic/tc.json": json.dumps(
               {"rotation": [{"op": "global_triangle_count"}],
                "warmup": 1, "sample": 1}),
           "kinds/triangle_count.py": TC_KIND,
           "ops/global_triangle_count.py": TC_OP}
    for rel, text in new.items():
        assert not (root / rel).exists()
        (root / rel).write_text(text)
    bench = load_bench()
    bench["configs"].append({"name": "graph500-s7"})
    bench["workloads"].append({"name": "graph500-s7.tc",
                               "config": "graph500-s7", "traffic": "tc",
                               "chips": 1})
    res = harness.run_cell(bench, "graph500-s7.tc", 2**31 + 7, 0.2, False,
                           device="cpu", registry=reg)
    assert res["correct"], res["checks"]
    assert res["checks"]["triangle_count.off"]["value"] == 0

    op = reg.module("ops", "global_triangle_count")
    call = op.call
    monkeypatch.setattr(op, "call", lambda cell, req, mark: op.Answer(
        call(cell, req, mark).value + 1))
    res = harness.run_cell(bench, "graph500-s7.tc", 2**31 + 7, 0.2, False,
                           device="cpu", registry=reg)
    assert not res["correct"]
    assert res["checks"]["triangle_count.off"]["value"] == 1
    assert {p: p.read_bytes() for p in held} == held
