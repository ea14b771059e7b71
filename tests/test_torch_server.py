"""graph_tpu_torch.server against graph_tpu.server, over loopback Flight.

Mirrors tests/test_server.py test for test: a ``graph_tpu`` server and a
port server (``device="cpu"``) run in this process on
``grpc://localhost:0`` and get the same actions, on inputs made here from
seeds (tests/test_torch_api.py's ``write_inputs``).  Their result JSON
must be equal without the ``*_millis`` fields; fetched tables must have
the same schema and batch count, and the same values (PageRank within
1e-6, the rest exactly).  The request path (``service``, ``catalog``,
``actions``) must import neither pyarrow nor pandas.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")
flight = pytest.importorskip("pyarrow.flight")

from graph_tpu.algos import triangle_count as jtc
from graph_tpu.server.flight import GraphFlightServer as JaxServer
from graph_tpu_torch.engine import tc_join
from graph_tpu_torch.server.flight import GraphFlightServer

from test_torch_api import write_inputs

ROOT = Path(__file__).resolve().parents[1]
#: PageRank scores: the port's plan engine against graph_tpu's cumsum.
PR_ATOL = 1e-6


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("server"))


@pytest.fixture(autouse=True)
def small_slab(monkeypatch):
    """graph_tpu pads each triangle join step to 2**25 wedge slots."""
    monkeypatch.setattr(jtc, "SLAB", 1 << 20)
    monkeypatch.setattr(tc_join, "SLAB", 1 << 12)


@pytest.fixture(scope="module")
def clients():
    """(port client, graph_tpu client), each to its own server."""
    servers = [GraphFlightServer("grpc://localhost:0", device="cpu"),
               JaxServer("grpc://localhost:0")]
    cs = [flight.connect(f"grpc://localhost:{s.port}") for s in servers]
    yield cs
    for c, s in zip(cs, servers):
        c.close()
        s.shutdown()


def do(client, action, body):
    res = client.do_action(flight.Action(action, json.dumps(body).encode()))
    return json.loads(next(iter(res)).body.to_pybytes())


def no_millis(obj):
    if isinstance(obj, dict):
        return {k: no_millis(v) for k, v in obj.items()
                if not k.endswith("_millis")}
    return obj


def do_both(clients, action, body):
    """One action on both servers; equal results without ``*_millis``."""
    got, want = (no_millis(do(c, action, body)) for c in clients)
    assert got == want
    return got


def fetch_both(clients, pid, atol=0.0):
    """One property from both servers: the same schema, batch count and
    values (within ``atol``).  Returns the port's column."""
    tables = [c.do_get(flight.Ticket(json.dumps(pid).encode())).read_all()
              for c in clients]
    got, want = tables
    assert got.schema == want.schema
    assert len(got.to_batches()) == len(want.to_batches())
    col, jcol = (t.column(0).to_numpy() for t in tables)
    if atol:
        np.testing.assert_allclose(col, jcol, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(col, jcol)
    return col


def test_create_list_remove(clients, paths):
    r = do_both(clients, "create", {
        "graph_name": "g1",
        "file_format": "EdgeList",
        "path": paths[1],
        "csr_layout": "Sorted",
        "orientation": "Directed",
    })
    assert (r["node_count"], r["edge_count"]) == (64, 256)
    names = [g["graph_name"]
             for g in do_both(clients, "list", {})["graph_infos"]]
    assert "g1" in names
    removed = do_both(clients, "remove", {"graph_name": "g1"})
    assert removed == {"graph_name": "g1", "graph_type": "Directed",
                       "node_count": 64, "edge_count": 256}
    listing = do_both(clients, "list", {})
    assert "g1" not in [g["graph_name"] for g in listing["graph_infos"]]


def test_compute_pagerank_and_get(clients, paths):
    do_both(clients, "create", {"graph_name": "pr",
                                "file_format": "Graph500",
                                "path": paths[0], "csr_layout": "Sorted"})
    r = do_both(clients, "compute", {
        "graph_name": "pr",
        "algorithm": {"PageRank": {"max_iterations": 20, "tolerance": 1e-4,
                                   "damping_factor": 0.85}},
        "property_key": "page_rank",
    })
    assert r["algo_result"]["iterations"] >= 1
    scores = fetch_both(clients, r["property_id"], atol=PR_ATOL)
    assert scores.dtype == np.float32 and len(scores) == 256
    assert (scores > 0).all()


def test_compute_wcc_unit_and_sssp(clients, paths):
    do_both(clients, "create", {"graph_name": "w",
                                "file_format": "EdgeListWeighted",
                                "path": paths[2], "csr_layout": "Sorted"})
    r = do_both(clients, "compute", {"graph_name": "w",
                                     "algorithm": {"Wcc": {}},
                                     "property_key": "components"})
    components = fetch_both(clients, r["property_id"])
    assert components.dtype == np.uint64 and len(components) == 64
    r = do_both(clients, "compute", {
        "graph_name": "w",
        "algorithm": {"Sssp": {"start_node": 0, "delta": 2.0}},
        "property_key": "dist",
    })
    dist = fetch_both(clients, r["property_id"])
    assert dist[0] == 0.0


def test_to_undirected_and_triangle_count(clients, paths):
    do_both(clients, "create", {"graph_name": "t",
                                "file_format": "Graph500",
                                "path": paths[0], "csr_layout": "Sorted"})
    do_both(clients, "to_undirected", {"graph_name": "t",
                                       "csr_layout": "Deduplicated"})
    r = do_both(clients, "compute", {"graph_name": "t",
                                     "algorithm": "TriangleCount",
                                     "property_key": "tc"})
    assert r["algo_result"]["triangle_count"] > 0  # the distinct count
    count = fetch_both(clients, r["property_id"])
    assert count.tolist() == [r["algo_result"]["triangle_count"]]


def test_to_relabeled_then_multiset_golden(clients, paths):
    do_both(clients, "create", {"graph_name": "t2",
                                "file_format": "Graph500",
                                "path": paths[0], "csr_layout": "Sorted",
                                "orientation": "Undirected"})
    do_both(clients, "to_relabeled", {"graph_name": "t2"})
    r = do_both(clients, "compute", {"graph_name": "t2",
                                     "algorithm": "TriangleCount",
                                     "property_key": "tc"})
    assert r["algo_result"]["triangle_count"] > 0  # the multiset count


def put(client, name, src, dst, orientation="Directed"):
    schema = pa.schema([("source", pa.int64()), ("target", pa.int64())])
    cmd = json.dumps({"graph_name": name, "edge_count": len(src),
                      "csr_layout": "Sorted",
                      "orientation": orientation}).encode()
    writer, reader = client.do_put(
        flight.FlightDescriptor.for_command(cmd), schema)
    for lo in range(0, len(src), 4096):  # several batches
        writer.write_batch(pa.record_batch(
            [pa.array(src[lo:lo + 4096], pa.int64()),
             pa.array(dst[lo:lo + 4096], pa.int64())], schema=schema))
    writer.done_writing()
    result = json.loads(reader.read().to_pybytes())
    writer.close()
    return no_millis(result)


def test_do_put_builds_graph(clients):
    results = [put(c, "put_g", [0, 1, 2], [1, 2, 0]) for c in clients]
    assert results[0] == results[1] == {"node_count": 3, "edge_count": 3}
    listing = do_both(clients, "list", {})
    assert "put_g" in [g["graph_name"] for g in listing["graph_infos"]]
    # a ring of 25,000 nodes: its component column takes three batches
    n = 25_000
    src = np.arange(n)
    results = [put(c, "ring", src, (src + 1) % n, "Undirected")
               for c in clients]
    assert results[0] == results[1] == {"node_count": n, "edge_count": n}
    r = do_both(clients, "compute", {"graph_name": "ring",
                                     "algorithm": {"Wcc": {}},
                                     "property_key": "c"})
    tables = [c.do_get(flight.Ticket(json.dumps(r["property_id"]).encode()))
              .read_all() for c in clients]
    assert [len(t.to_batches()) for t in tables] == [3, 3]
    assert not fetch_both(clients, r["property_id"]).any()


def test_unknown_graph_errors(clients):
    for c in clients:
        with pytest.raises(flight.FlightServerError, match="nope"):
            do(c, "compute", {"graph_name": "nope",
                              "algorithm": "TriangleCount",
                              "property_key": "x"})
        with pytest.raises(flight.FlightServerError, match="Unknown action"):
            do(c, "frobnicate", {})


def test_list_actions(clients):
    got, want = ([a.type for a in c.list_actions()] for c in clients)
    assert got == want == ["create", "list", "remove", "compute",
                           "to_relabeled", "to_undirected"]


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_server_process_honors_plan_cache(tmp_path, paths):
    """``python -m graph_tpu_torch.server <uri> <cache-dir> cpu`` points
    engine builds at the cache: a second graph of the same edges hits the
    persisted plan instead of rebuilding it."""
    cache = tmp_path / "plans"
    uri = f"grpc://localhost:{free_port()}"
    log = open(tmp_path / "server.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "graph_tpu_torch.server", uri, str(cache),
         "cpu"], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    try:
        client = flight.connect(uri)
        deadline = time.monotonic() + 120
        while True:
            try:
                client.list_actions()
                break
            except flight.FlightUnavailableError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        for name in ("a", "b"):
            do(client, "create", {"graph_name": name,
                                  "file_format": "EdgeList",
                                  "path": paths[1]})
            do(client, "compute", {"graph_name": name,
                                   "algorithm": {"PageRank": {}},
                                   "property_key": "pr"})
            assert len(list(cache.glob("torchplan-*.npz"))) == 1
        client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        log.seek(0)
        out = log.read()
        log.close()
    assert "EdgePlan cache hit" in out, out


def test_examples_run_against_server():
    """examples/common.py's client (numpy and pyarrow only) drives the
    port's server end to end."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import common as excommon
    finally:
        sys.path.pop(0)

    server = GraphFlightServer("grpc://localhost:0", device="cpu")
    try:
        c = excommon.connect(f"grpc://localhost:{server.port}")
        path = excommon._tiny_graph(weighted=False, scale=6, ef=4)
        try:
            r = excommon.action(c, "create", {
                "graph_name": "exdemo", "file_format": "EdgeList",
                "path": path, "csr_layout": "Sorted",
                "orientation": "Directed",
            })
        finally:
            os.unlink(path)
        assert r["edge_count"] > 0
        rr = excommon.action(c, "compute", {
            "graph_name": "exdemo",
            "algorithm": {"PageRank": {"max_iterations": 5,
                                       "tolerance": 1e-4,
                                       "damping_factor": 0.85}},
            "property_key": "page_rank",
        })
        table = excommon.fetch_property(c, rr["property_id"])
        assert len(table.column("page_rank")) == r["node_count"]
        excommon.action(c, "remove", {"graph_name": "exdemo"})
        c.close()
    finally:
        server.shutdown()


# -- the port's own: the request path without pyarrow, the device rule -------


def test_request_path_imports_no_pyarrow():
    code = ("import sys\n"
            "import graph_tpu_torch.server.service\n"
            "import graph_tpu_torch.server.catalog\n"
            "import graph_tpu_torch.server.actions\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('pyarrow', 'pandas')))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_service_answers_without_transport(paths):
    """The service alone gives the dicts the Flight actions return, and
    keeps each column as one host array, cut into 10,000-row chunks."""
    from graph_tpu_torch.server import catalog
    from graph_tpu_torch.server.service import GraphService

    svc = GraphService(device="cpu")
    body = json.dumps({"graph_name": "g", "file_format": "Graph500",
                       "path": paths[0]}).encode()
    assert no_millis(svc.action("create", body)) == {"node_count": 256,
                                                     "edge_count": 4096}
    assert svc.catalog.get("g").device.type == "cpu"
    r = svc.action("compute", json.dumps({
        "graph_name": "g", "algorithm": "Wcc",
        "property_key": "c"}).encode())
    field, values = svc.properties.get("g", "c")
    assert field == "component" and values.dtype == np.uint64
    assert r["property_id"] == {"graph_name": "g", "property_key": "c"}
    assert [len(c) for c in catalog.chunks(values)] == [256]
    assert [len(c) for c in catalog.chunks(np.zeros(20_001))] == [
        10_000, 10_000, 1]
    assert [len(c) for c in catalog.chunks(np.zeros(0))] == [0]


def test_no_device_and_no_card_raises(monkeypatch):
    from graph_tpu_torch.server.service import GraphService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (GraphService,
                 lambda: GraphFlightServer("grpc://localhost:0")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
