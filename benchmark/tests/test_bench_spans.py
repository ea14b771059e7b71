"""The per-layer metrics read from the program's spans, on hand-made
spans, against a program that records none, and in a traced run of the
small cells on the CPU."""

import pytest

from benchmark import harness, spans
from benchmark.tests.conftest import load_bench

import graph_tpu_torch.profile as profile

READERS = ("answer_copy_ms", "loop_round_us", "plan_ms.ingest",
           "capture_ms.ingest", "build_host_ms.ingest", "h2d_gbps.ingest")


def _span(id_, name, start_us, end_us, parent=None, request=None, **c):
    return {"name": name, "start_us": start_us, "end_us": end_us,
            "id": id_, "parent": parent,
            "request": id_ if request is None else request, "thread": 1,
            "counters": c}


def _read(name, given, monkeypatch):
    monkeypatch.setattr(profile, "spans", lambda clear=False: list(given))
    return harness.Registry().module("metrics", name).read(None)


#: Two requests of the resident-graph cells: a PageRank call (api span,
#: driver, loop) and its answer copy; a WCC driver and its copy.
RESIDENT = [
    _span(3, "loop.run", 100, 12_800, parent=2, request=1,
          device_ms=12.6, bodies=[20], launches={"k1_gather": 20}),
    _span(2, "page_rank.run", 50, 12_900, parent=1, request=1, rounds=20),
    _span(1, "api.page_rank", 0, 13_000),
    _span(4, "result.to_host", 13_100, 14_500, bytes=16 << 20),
    _span(6, "loop.run", 20_100, 28_000, parent=5, request=5,
          device_ms=7.5, bodies=[5]),
    _span(5, "wcc.run", 20_000, 28_100, rounds=5),
    _span(7, "result.to_host", 28_200, 29_400, bytes=16 << 20),
    # a loop outside any driver: not a round of one
    _span(8, "loop.run", 30_000, 31_000, device_ms=0.9, bodies=[3]),
]

#: One ingest request: the build (host copies, transfers) and the first
#: PageRank (plan, capture, instantiation, run).
INGEST = [
    _span(11, "graph.build.host", 10, 410, parent=10, request=10),
    _span(13, "graph.build.host", 500, 800, parent=12, request=10),
    _span(14, "graph.build.h2d", 800, 900, parent=12, request=10,
          bytes=500_000_000, device_ms=90.0),
    _span(15, "graph.build.host", 900, 1_000, parent=12, request=10),
    _span(16, "graph.build.h2d", 1_000, 1_100, parent=12, request=10,
          bytes=500_000_000, device_ms=110.0),
    _span(12, "graph.build", 450, 1_200, parent=10, request=10),
    _span(10, "graph.build", 0, 1_300),
    _span(21, "engine.build", 1_400, 31_400, parent=20, request=20,
          plan_cache="off"),
    _span(23, "loop.capture", 31_500, 36_500, parent=22, request=20),
    _span(24, "loop.instantiate", 36_500, 37_000, parent=22, request=20),
    _span(25, "loop.run", 37_000, 50_000, parent=22, request=20,
          device_ms=12.7, bodies=[20], cached=False),
    _span(22, "page_rank.run", 31_450, 50_100, parent=20, request=20,
          rounds=20),
    _span(20, "api.page_rank", 1_350, 50_200),
]


def test_readers_on_hand_made_spans(monkeypatch):
    def read(name, given=RESIDENT):
        return _read(name, given, monkeypatch)

    assert read("answer_copy_ms") == pytest.approx((1.4 + 1.2) / 2)
    assert read("loop_round_us") == pytest.approx(
        (12.6 + 7.5) / (20 + 5) * 1e3)
    assert read("plan_ms.ingest", INGEST) == pytest.approx(30.0)
    assert read("capture_ms.ingest", INGEST) == pytest.approx(5.5)
    assert read("build_host_ms.ingest", INGEST) == pytest.approx(0.8)
    assert read("h2d_gbps.ingest", INGEST) == pytest.approx(
        1e9 / 0.2 / 1e9)


def test_host_self_time_and_requests(monkeypatch):
    """A host copy's child is not its own time; requests average."""
    given = [
        _span(2, "graph.build.host", 0, 1_000, parent=1, request=1),
        _span(3, "graph.build.h2d", 200, 700, parent=2, request=1,
              bytes=10, device_ms=0.5),
        _span(1, "graph.build", 0, 2_000),
        _span(5, "graph.build.host", 3_000, 4_500, parent=4, request=4),
        _span(4, "graph.build", 3_000, 5_000),
    ]
    assert _read("build_host_ms.ingest", given, monkeypatch) == \
        pytest.approx((0.5 + 1.5) / 2)
    assert spans.self_ms(given[2], given) == pytest.approx(1.0)


#: The spans each reader reads.
KINDS = {"answer_copy_ms": ("result.to_host",),
         "loop_round_us": ("loop.run",),
         "plan_ms.ingest": ("engine.build",),
         "capture_ms.ingest": ("loop.capture", "loop.instantiate"),
         "build_host_ms.ingest": ("graph.build.host",),
         "h2d_gbps.ingest": ("graph.build.h2d",)}


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_their_spans(name, monkeypatch):
    # every span but those it reads, then none at all
    other = [s for s in RESIDENT + INGEST if s["name"] not in KINDS[name]]
    assert _read(name, other, monkeypatch) is None
    assert _read(name, [], monkeypatch) is None
    # loops timed on the host only (the CPU): no device time to read
    host_only = [dict(s, counters={k: v for k, v in s["counters"].items()
                                   if k != "device_ms"})
                 for s in RESIDENT + INGEST]
    if name in ("loop_round_us", "h2d_gbps.ingest"):
        assert _read(name, host_only, monkeypatch) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_against_a_program_without_spans(name,
                                                           monkeypatch):
    monkeypatch.delattr(profile, "spans")
    assert harness.Registry().module("metrics", name).read(None) is None


@pytest.mark.parametrize("cell, present, absent", [
    ("graph500-s22.pagerank", {"answer_copy_ms"}, {"loop_round_us"}),
    ("graph500-s22.ingest", {"plan_ms.ingest", "build_host_ms.ingest"},
     {"capture_ms.ingest", "h2d_gbps.ingest"}),
])
def test_traced_small_cell_on_the_cpu_reports_its_span_metrics(
        cell, present, absent, small, monkeypatch):
    """On the CPU the program records every span but has no device loop
    to capture and no CUDA events: those metrics stay out of the line."""
    bench, reg = small
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.2)
    profile.spans(clear=True)
    res = harness.run_cell(bench, cell, 5, 0.2, True, device="cpu",
                           registry=reg)
    profile.spans(clear=True)
    assert res["correct"], res["checks"]
    assert present <= set(res["metrics"])
    assert not absent & set(res["metrics"])
    for name in present:
        assert res["metrics"][name]["value"] > 0


def test_the_new_entries_read_program_spans():
    bench = load_bench()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert entries[name]["source"] == "program_span"
        cells = entries[name]["workloads"]
        assert all(c.endswith(".ingest") == name.endswith(".ingest")
                   for c in cells)
