"""The triangle-count cell of the benchmark (``gap-kron-s22.tc``) on the
CPU: the plain reference against the dense trace(A^3) / 6 and against
``Graph.global_triangle_count()`` on GAP ``kron`` graphs, its float32
control, and the cell itself at scale 9 through the harness, sound and
with faults planted in the port."""

import hashlib
import json
import math

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.generators import gap_kron
from benchmark.reference import triangles
from benchmark.tests.conftest import REPO, load_bench, small_copy
from graph_tpu_torch import profile
from graph_tpu_torch.api import ID_DTYPE, Graph
from graph_tpu_torch.engine import tc_join
from graph_tpu_torch.graph.build import build_undirected
from graph_tpu_torch.graph.csr import CsrLayout

CELL = "gap-kron-s22.tc"
#: GAP kron at scale 9.
SMALL = {"gap-kron-s22": {"scale": 9, "n": 512, "edges_drawn": 16 * 512}}
KRON = {"edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19}


def _gen(seed):
    g = torch.Generator("cpu")
    g.manual_seed(seed)
    return g


def _dense_count(src, dst, n):
    a = torch.zeros((n, n), dtype=torch.float64)
    a[src, dst] = 1
    a[dst, src] = 1
    a.fill_diagonal_(0)
    return round(float(torch.trace(a @ a @ a)) / 6)


@pytest.mark.parametrize("seed,n,m,chunk", [
    (1, 10, 60, triangles.CHUNK), (2, 50, 400, triangles.CHUNK),
    (3, 120, 2000, 7), (4, 200, 6000, triangles.CHUNK),
    (5, 200, 6000, 1000), (6, 200, 150, 3), (7, 3, 9, triangles.CHUNK)])
def test_reference_equals_the_dense_trace(seed, n, m, chunk):
    g = _gen(seed)
    src = torch.randint(0, n, (m,), generator=g)
    dst = torch.randint(0, n, (m,), generator=g)
    # self-loops, repeated pairs and both directions of a pair
    loops = torch.arange(0, n, 3)
    src = torch.cat([src, loops, dst[: m // 4], src[: m // 4]])
    dst = torch.cat([dst, loops, src[: m // 4], dst[: m // 4]])
    got = triangles.count(src, dst, n, chunk=chunk)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == _dense_count(src, dst, n)


@pytest.mark.parametrize("ordered", [False, True], ids=["as-built",
                                                         "degree-ordered"])
@pytest.mark.parametrize("scale", [8, 9, 10, 11, 12])
def test_graph_count_equals_the_reference_on_gap_kron(scale, ordered):
    d = gap_kron.make(dict(KRON, scale=scale), _gen(2**31 + scale))
    assert bool((d.src < d.dst).all())
    g = Graph(build_undirected(d.src, d.dst, node_count=d.n,
                               layout=CsrLayout.DEDUPLICATED,
                               id_dtype=ID_DTYPE, device="cpu"))
    assert g.edge_count() == d.m
    if ordered:
        g.make_degree_ordered()
    got = g.global_triangle_count().triangles
    assert got > 0 and got == int(triangles.count(d.src, d.dst, d.n))


@pytest.mark.parametrize("n", [200, 471])
def test_the_float32_control_rounds_once_the_count_passes_2_24(n):
    """A clique of n nodes holds C(n, 3) triangles: 1,313,400 at 200
    (below 2**24, exact in float32) and 17,303,755 at 471 (odd, above
    2**24, so no float32 holds it)."""
    src, dst = torch.triu_indices(n, n, 1)
    exact = triangles.count(src, dst, n, chunk=1 << 22)
    low = triangles.count(src, dst, n, dtype=torch.float32, chunk=1 << 22)
    assert int(exact) == math.comb(n, 3)
    kind = harness.Registry().module("kinds", "triangles")
    off = kind.compare(low.reshape(1).numpy(), exact.reshape(1).numpy())
    assert (off["off"] > 0) == (math.comb(n, 3) > 1 << 24)


def test_the_kind_reads_the_difference_of_the_counts():
    kind = harness.Registry().module("kinds", "triangles")
    big = 2_111_261_338
    assert kind.compare(np.array([big]), np.array([big])) == {"off": 0.0}
    assert kind.compare(np.array([big + 3]), np.array([big])) == {"off": 3.0}
    assert kind.compare(np.array([big - 2]), np.array([big])) == {"off": 2.0}
    assert kind.compare(np.array([1, 2]), np.array([3])) == {
        "off": float("inf")}
    assert (kind.REFERENCE, kind.CONTROL) == (torch.int64, torch.float32)


@pytest.fixture
def small(tmp_path):
    return load_bench(), small_copy(tmp_path / "benchmark", SMALL)


def _run(small, trace=False):
    bench, reg = small
    return harness.run_cell(bench, CELL, 2**31 + 21, 0.3, trace,
                            device="cpu", registry=reg)


def test_the_cell_reads_correct_with_the_count_exact(small):
    res = _run(small)
    assert res["correct"], res["checks"]
    assert res["checks"] == {"triangles.off": {"value": 0.0, "limit": 0}}
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"throughput_gevps", "setup_s"}


def _plus_one(monkeypatch, reg):
    op = reg.module("ops", "graph_triangle_count")
    call = op.call
    monkeypatch.setattr(op, "call", lambda cell, req, mark: op.Answer(
        call(cell, req, mark).value + 1))


def _one_slab_skipped(monkeypatch, reg):
    """The first join step of every count adds nothing."""
    lookup = tc_join._lookup_count
    joins = []

    def skipping(v, w, keys):
        if joins and joins[-1] is keys:
            return lookup(v, w, keys)
        joins[:] = [keys]
        return torch.zeros((), dtype=torch.int64, device=v.device)
    monkeypatch.setattr(tc_join, "_lookup_count", skipping)


@pytest.mark.parametrize("fault", [_plus_one, _one_slab_skipped],
                         ids=["plus-one", "one-slab-skipped"])
def test_a_fault_in_the_count_reads_not_correct(small, monkeypatch, fault):
    fault(monkeypatch, small[1])
    res = _run(small)
    assert not res["correct"], res["checks"]
    assert res["checks"]["triangles.off"]["value"] >= 1


def test_a_traced_run_reads_the_drivers_spans(small, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.2)
    profile.spans(clear=True)
    res = _run(small, trace=True)
    profile.spans(clear=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("orient_ms.tc", "pack_ms.tc", "join_ms.tc"):
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms"
    assert "join_gslots_per_s.tc" not in m  # no CUDA events on the CPU


#: The cell's files: everything else under benchmark/ is as the
#: benchmark had it before the cell (sha256 below).
NEW = {"configs/gap-kron-s22.json", "generators/gap_kron.py",
       "kinds/triangles.py", "ops/graph_triangle_count.py",
       "reference/triangles.py", "traffic/gap-tc.json",
       "metrics/orient_ms.tc.py", "metrics/pack_ms.tc.py",
       "metrics/join_ms.tc.py", "metrics/join_gslots_per_s.tc.py"}
BEFORE = {
    "__init__.py":
        "90a76bf743703f484b4502e4addc5ffaa0f0c66e7936ec086f1e323e3cba9e6f",
    "calibrate.py":
        "dbcd5a65dc7ae5b182110d2c0ae9c89795d3fd111281e39314982d4d07ceeaf5",
    "configs/graph500-s22.json":
        "cba57f6568ab96a062184f6f50529d4789772400a42cd7ebf6d68fe568ca10c2",
    "generators/__init__.py":
        "09a4684fb32fc3db86e1ee75a18ad1984f3132ba4bed3d92d1d813dbd4d4132c",
    "generators/graph500_kronecker.py":
        "79d2e8262b8534915f1d029c55e6a462f370701fbdc8af49a501bed21ff358cf",
    "harness.py":
        "c5d3be9335064682e5f6cad67863338517ba245d553a5a4cdde1d821ab23ad2d",
    "kinds/__init__.py":
        "4c743395410495f7bbef3327c0a2e0d57a433b077ef331144193eefa5d8cde4a",
    "kinds/page_rank.py":
        "b20385aa32293fc9f6b9879622383ce4e6ed2a6858434b5a7c53a9b2f514a02a",
    "kinds/sssp.py":
        "92aa956820f073e082e7d20c0ff127ab35d0c61dda94e5b05aad0f64f5369a8c",
    "kinds/wcc.py":
        "e63e4090524442284761dee5cdad2bde81af779a31ade1c96e60caaf37c11319",
    "metrics/answer_copy_ms.py":
        "3e072358ad1ce48be3f883d25411ee9df8cac745b3eea4c490456f0344d3d95c",
    "metrics/build_host_ms.ingest.py":
        "2a2f109eddaed694769a3eca80be5c1c5aa6f769a07db611cd1e832b4ceb2545",
    "metrics/build_ms.ingest.py":
        "0c65ac5d017eae5618755bd8e9ac570b5b220b92d2b653ec285a53192e4c0108",
    "metrics/capture_ms.ingest.py":
        "29fd84f95f20e177b2be1b30ed49170808817a54e334b12a24b8c5448fca5f76",
    "metrics/device_idle_pct.ingest.py":
        "9c8af5bc60b4b77146b577821e0e2b80223558ae4c93b82bfe98f55df5c641b6",
    "metrics/device_idle_pct.py":
        "27d645ac6019ff33e99daae61cc6757364fe069a43ca06ba75f48a9123938ecc",
    "metrics/first_run_ms.ingest.py":
        "513f3643bd60df6c312eb64978faf8b8b913a25cc592dac61f493e304617bd06",
    "metrics/h2d_gbps.ingest.py":
        "33da578e345fe78b2ec4084604e4da3311b93caf704b8339c294997a1f415b43",
    "metrics/ingest_gevps.py":
        "b6d7893655bd3607628c939bb496b157c12fb7ad0e86602a594df36694d8114d",
    "metrics/k1_gather_roofline.py":
        "4a5fd5d75782763562be7b8e6ef91627e7f5541f83a9ac18166bd9ee14c729ec",
    "metrics/k2_reduce_roofline.py":
        "3b21287f952c2de08159298ed0689fc0faf0c8c56e8d10b2abf3e88da2d64077",
    "metrics/latency_ms.p95.py":
        "8705d959891457fe1de59a34f9440ca0d83273a9711048eaf1af57ad2f8f74e9",
    "metrics/loop_round_us.py":
        "f2ed6e3d688a2f1e01e6af5845aa8fbc5633f0654cef9b567651719ad7c72070",
    "metrics/pagerank_iteration_roofline.py":
        "46f2854befba4e69e613d67e7e8a7a9ed5ed9473175180080b4fc534f93d204f",
    "metrics/plan_ms.ingest.py":
        "a2458960c5be392b33c64e3221645d51ef633ef233150c9456928c858cca66d2",
    "metrics/round_us.sssp.py":
        "335598bfb8f1ea9681c8cf9377c84a3acb38f5ccd93e4ad23a1c5201dfdcf1fb",
    "metrics/round_us.wcc.py":
        "7c3679b18e3e0673db6b92bf41915aa1fc3f4b40a062f063ccc89d27828c71ce",
    "metrics/setup_s.py":
        "96e5b65d7090b649b60c961ae1587748018e9b935578edfa05125adca9a6d502",
    "metrics/surface_ms.pagerank.py":
        "b76aee1e61d502f10f839e0ba45701ebf62b700c669fe4e6d834753fbad31c66",
    "metrics/throughput_gevps.py":
        "56ed3f1d88e63f6a23062b77bf29d45703020055106d20c4055c6d1b421d116e",
    "ops/__init__.py":
        "054a40ab5c7327711236f6f137b6d679112d6d4e852c1849b358657b858a8e3c",
    "ops/api_page_rank.py":
        "cffdccb4b6b6cd7d0c8ebac42592714c31f8708415542e063b22914265009555",
    "ops/delta_stepping.py":
        "cb73bbc813e1202ddef2a3cf5f029a3a2ac7164959f490374518eefc147291c7",
    "ops/graphs.py":
        "55b1e21d47e02ec199e4943c76655da49e48e441d3a58ae8f48583e57655132f",
    "ops/ingest_page_rank.py":
        "be40e0a2c28ad78de042d2fe29b0e2c293af8dcbed1eeebf7b2e2c50d273307a",
    "ops/refs.py":
        "18e8d44b69ae314fe44dd858d1182a1084fb49fad6b92776ba52a714bb0a4f79",
    "ops/wcc.py":
        "3d885dd5f919c08188af4ee977915d01d8755f64b5a67464c9b8c2bc56766888",
    "readers.py":
        "18e8d2e49ef93f3d01105e0672e07dc8bf88eef72b2c390d873eb79f4b3d8a89",
    "reference/__init__.py":
        "0fd80c8c6a6740b537ba7d944e640e836a8cc58da888f09ca1ed0fb5587fbaad",
    "reference/pagerank.py":
        "78b32cc7f176d792a1fb1209f771898068ce2da401f073ea2b39983dfe1a22c6",
    "reference/sssp.py":
        "6c637767f1ff612a810531cfc6d0b844b6fbda56f4ee1221b7530ddfbb9786cc",
    "reference/wcc.py":
        "0a9106ec12dc076f177272b4156e421342e874f3b83268e86731fad08ea4c9b1",
    "run.py":
        "8759b40b2ecc87c4ce08ea9905432f2c5a0f93e8a5e953311c8a3aec5cdc0e7d",
    "schedule.py":
        "eb8d6e49ebb6361b18eef2bf7b92eb74b5de75af7549608e0efd5265c6b62cdd",
    "spans.py":
        "84c07e458bfca06af43f6e13d83e0aefc5b1cb99ea4812c5b91ac00a9967e9e8",
    "stats.py":
        "5f3aba432a1a4b7f67b9f4661083af54b18a68d35b4b69c982a118bfe77e268e",
    "tests/__init__.py":
        "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
    "tests/conftest.py":
        "028778f3151e05573f4e1a5814a5fc7bc9c5c22f8fe7ae6ca7425195850a1cf2",
    "tests/test_bench_control.py":
        "f0283fa7175d15afe2a0c293198c91ed5e0ebad76167dcbdbbb447294f487662",
    "tests/test_bench_faults.py":
        "77e17ae777323a58977296c99ae20e3e23d48772fdf3f6f2917e000b0de9d9b8",
    "tests/test_bench_harness.py":
        "aeb3783976362bcfc61c658cbd133526bb6a667ab11641db90a078359de2310a",
    "tests/test_bench_isolation.py":
        "1e98510fbcd9a47ee924f31af46e8a535a46b1f4e1f406e4abb18ded4c754a70",
    "tests/test_bench_spans.py":
        "7e069a836169798a107c86e03bee9524e4b370539ee8e840363792856967e225",
    "trace.py":
        "08063a00d2b651331f56f7366cf82a8766bed71a98c31031c0371637b7b6cb64",
    "traffic/ingest.json":
        "869c7f9ed5937d11ad3f3ceec9b2684c056db811f398ca97dbee84df10d8576e",
    "traffic/pagerank.json":
        "fc6a075eb8d6dfd3b6339d71a85c321933b24205018f6fb15c349f167091c885",
    "traffic/sssp.json":
        "3f728eea31191debb64fafd8cba9aabc9cab1ebbbb22d2cd1bd68655ddcbde47",
    "traffic/wcc.json":
        "e93f62067b59afbe61622f2c29248fc3fcd40dda78af7bc1993994a714fd6a93",
    "work.py":
        "93999d669c8a763558c149f3676d2ae896b538a092e1a857ece8ba55556240fc",
}


def test_the_cell_is_new_files_only():
    bench = REPO / "benchmark"
    files = {str(p.relative_to(bench)) for p in bench.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert NEW | set(BEFORE) <= files
    changed = [rel for rel, digest in BEFORE.items() if hashlib.sha256(
        (bench / rel).read_bytes()).hexdigest() != digest]
    assert changed == []
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cell, = [w for w in spec["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "gap-kron-s22", "gap-tc", 1)
