"""The text-load cell of the benchmark (``ldbc-graph500-22.load-wcc``) on
the CPU: the LDBC ``.e`` writer against the plain text reference, the
native parser and pandas against that reference, ``Graph.load`` of the
written file against the build of the generator's arrays and its WCC
against the min-label reference, the ``api.load`` and ``io.parse`` spans
and the metrics that read them, and the cell itself at scale 9 through
the harness, sound and with a fault planted in the parser."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness, spans
from benchmark.generators import gap_kron
from benchmark.ops import ldbc_text
from benchmark.reference import edge_text, wcc as min_label
from benchmark.tests.conftest import REPO, load_bench, small_copy
from graph_tpu_torch import profile
from graph_tpu_torch.api import ID_DTYPE, DiGraph, FileFormat, Graph
from graph_tpu_torch.graph.build import build_undirected
from graph_tpu_torch.io import datasets, edgelist
from graph_tpu_torch.native import edge_list_parser

CELL = "ldbc-graph500-22.load-wcc"
CONFIG = json.loads(
    (REPO / "benchmark" / "configs" / "ldbc-graph500-22.json").read_text())
#: The configuration at scale 9.
SMALL = {"ldbc-graph500-22": {"scale": 9, "n": 512,
                              "edges_drawn": 16 * 512}}
SCALES = [9, 12]


@functools.lru_cache(maxsize=None)
def _written(scale):
    """GAP kron edges at ``scale`` and their ``.e`` file."""
    g = torch.Generator("cpu")
    g.manual_seed(2**41 + scale)
    data = gap_kron.make(dict(CONFIG, scale=scale), g)
    return data, ldbc_text.write(data.src, data.dst, scale)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("scale", [9, 10, 11, 12])
def test_the_writer_round_trips_through_the_reference(scale):
    data, text = _written(scale)
    assert text.path == datasets.graph500_path(
        scale, os.path.dirname(os.path.dirname(text.path)))
    raw = _bytes(text.path)
    want = "".join(f"{s} {d}\n" for s, d in zip(data.src.tolist(),
                                                data.dst.tolist()))
    assert raw == want.encode()
    src, dst = edge_text.parse(raw)
    assert torch.equal(src, data.src) and torch.equal(dst, data.dst)
    # each undirected edge once, as lo < hi, lines in (lo, hi) order
    keys = src * data.n + dst
    assert bool((src < dst).all()) and bool((keys[1:] > keys[:-1]).all())


@pytest.mark.parametrize("text,want", [
    (b"0 1\n2 3\n", ([0, 2], [1, 3])),
    (b"0 1\r\n\r\n10\t2\r\n", ([0, 10], [1, 2])),
    (b"\n  4194303 7\n\n0 0", ([4194303, 0], [7, 0])),
    (b"123456789012345678 9\n", ([123456789012345678], [9])),
    (b"", ([], [])),
    (b"1 2 3\n", "two ids"),
    (b"1\n2\n", "two ids"),
    (b"1 -2\n", "no digit"),
    (b"# c\n1 2\n", "no digit"),
], ids=["lf", "crlf-tab-blank", "no-final-lf", "wide", "empty",
        "three-ids", "one-id", "sign", "comment"])
def test_the_reference_reads_ids_by_digits_and_refuses_other_text(text,
                                                                  want):
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            edge_text.parse(text)
        return
    src, dst = edge_text.parse(text)
    assert src.dtype == dst.dtype == torch.int64
    assert (src.tolist(), dst.tolist()) == want


def _pandas(path):
    return edgelist._parse_pandas(path, False)[:2]


def _native(path):
    parsed = edge_list_parser.parse(path, False)
    assert parsed is not None, edge_list_parser.load_error()
    return parsed[:2]


@pytest.mark.parametrize("parser", [_native, _pandas],
                         ids=["native", "pandas"])
def test_the_parsers_equal_the_reference(parser):
    _, text = _written(12)
    want = edge_text.parse(_bytes(text.path))
    for got, w in zip(parser(text.path), want):
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, w.numpy())


@pytest.mark.parametrize("scale", SCALES)
def test_graph_load_equals_the_build_of_the_generated_arrays(scale):
    data, text = _written(scale)
    got = Graph.load(text.path, file_format=FileFormat.EdgeList,
                     device="cpu")
    want = build_undirected(data.src, data.dst, id_dtype=ID_DTYPE,
                            device="cpu")
    nodes = int(torch.maximum(data.src.max(), data.dst.max())) + 1
    assert (got.node_count(), got.edge_count()) == (nodes, data.m)
    assert (want.node_count, want.edge_count) == (nodes, data.m)
    for field in ("offsets", "sources", "targets"):
        a, b = getattr(got._g.csr, field), getattr(want.csr, field)
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)


@pytest.mark.parametrize("scale", SCALES)
def test_graph_wcc_equals_the_min_label_reference(scale):
    data, text = _written(scale)
    g = Graph.load(text.path, file_format=FileFormat.EdgeList, device="cpu")
    labels = g.wcc().components()
    ref = min_label.min_label(data.src, data.dst, g.node_count())
    kind = harness.Registry().module("kinds", "wcc")
    assert kind.compare(labels, ref.numpy()) == {"mismatched": 0.0}
    assert len(np.unique(labels)) > 1  # isolated ids are their own


def _no_native(monkeypatch):
    monkeypatch.setattr(edgelist.edge_list_parser, "parse",
                        lambda p, w: None)


@pytest.mark.parametrize("native", [1, 0], ids=["native", "pandas"])
@pytest.mark.parametrize("cls", [Graph, DiGraph], ids=["Graph", "DiGraph"])
def test_load_and_parse_spans_count_the_file(cls, native, monkeypatch):
    data, text = _written(12)
    if not native:
        _no_native(monkeypatch)
    size = os.path.getsize(text.path)
    profile.spans(clear=True)
    with profile.record():
        g = cls.load(text.path, file_format=FileFormat.EdgeList,
                     device="cpu")
    recorded = profile.spans(clear=True)
    load, = [s for s in recorded if s["name"] == "api.load"]
    parse, = [s for s in recorded if s["name"] == "io.parse"]
    build, = [s for s in recorded if s["name"] == "graph.build"]
    assert load["parent"] is None
    assert parse["parent"] == build["parent"] == load["id"]
    assert load["counters"] == {"bytes": size, "edges": data.m,
                                "nodes": g.node_count()}
    assert parse["counters"] == {
        "bytes": size, "edges": data.m, "native": native,
        "threads": edge_list_parser.threads(size) if native else 1}
    assert load["start_us"] <= parse["start_us"] < parse["end_us"] <= \
        build["start_us"] < build["end_us"] <= load["end_us"]


def test_the_parser_splits_files_from_1_mib():
    many = edge_list_parser.threads(1 << 30)
    assert edge_list_parser.threads((1 << 20) - 1) == 1
    assert edge_list_parser.threads(1 << 20) == many >= 1


def _span(id_, name, parent=None, start=0.0, end=0.0, **counters):
    return {"id": id_, "name": name, "parent": parent, "request": 1,
            "start_us": start, "end_us": end, "counters": counters}


@pytest.mark.parametrize("recorded,parse_gbps,build_ms", [
    # two loads; a build outside any load is not counted
    ([_span(1, "api.load", None, 0, 3000),
      _span(2, "io.parse", 1, 0, 1000, bytes=2e6),
      _span(3, "graph.build", 1, 1000, 3000),
      _span(4, "api.load", None, 5000, 9000),
      _span(5, "io.parse", 4, 5000, 8000, bytes=6e6),
      _span(6, "graph.build", 4, 8000, 9000),
      _span(7, "graph.build", None, 9000, 19000)], 2.0, 1.5),
    # the parent's program: no spans of either kind
    ([_span(1, "graph.build", None, 0, 1000),
      _span(2, "api.wcc", None, 1000, 2000)], None, None),
], ids=["two-loads", "no-spans"])
def test_the_readers_read_the_load_spans(monkeypatch, recorded,
                                         parse_gbps, build_ms):
    monkeypatch.setattr(spans, "recorded", lambda: recorded)
    reg = harness.Registry()
    for name, want in (("parse_gbps.load", parse_gbps),
                       ("build_ms.load", build_ms)):
        got = reg.module("metrics", name).read(None)
        assert got == (None if want is None else pytest.approx(want))


@pytest.fixture
def small(tmp_path):
    return load_bench(), small_copy(tmp_path / "benchmark", SMALL)


def _run(small, trace=False):
    bench, reg = small
    return harness.run_cell(bench, CELL, 2**33 + 27, 0.3, trace,
                            device="cpu", registry=reg)


def test_the_cell_reads_correct_with_the_loaded_counts(small, monkeypatch):
    op = small[1].module("ops", "load_text_wcc")
    call, extras = op.call, []

    def kept(cell, req, mark):
        answer = call(cell, req, mark)
        extras.append((cell.data, answer))
        return answer
    monkeypatch.setattr(op, "call", kept)
    res = _run(small)
    assert res["correct"], res["checks"]
    assert res["checks"] == {"wcc.mismatched": {"value": 0.0, "limit": 0}}
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"ingest_gevps", "setup_s"}
    data, _ = extras[0]
    nodes = int(torch.maximum(data.src.max(), data.dst.max())) + 1
    for _, answer in extras:
        assert answer.extra["nodes"] == nodes == answer.value.size
        assert answer.extra["edges"] == data.m > 0
        assert answer.extra["load_s"] > 0 and answer.extra["wcc_s"] > 0


def test_a_parser_that_skips_a_line_in_twenty_reads_not_correct(
        small, monkeypatch):
    parse = edge_list_parser.parse

    def skipping(path, weighted):
        src, dst, values = parse(path, weighted)
        keep = np.arange(src.size) % 20 != 0
        return src[keep], dst[keep], values
    monkeypatch.setattr(edge_list_parser, "parse", skipping)
    res = _run(small)
    assert not res["correct"], res["checks"]
    assert res["checks"]["wcc.mismatched"]["value"] > 0


def test_a_traced_run_reads_the_parse_and_the_build(small, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.2)
    profile.spans(clear=True)
    res = _run(small, trace=True)
    profile.spans(clear=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert set(m) == {"parse_gbps.load", "build_ms.load",
                      "device_idle_pct.ingest"}
    assert m["parse_gbps.load"]["unit"] == "GB/s"
    assert m["build_ms.load"]["unit"] == "ms"
    assert m["parse_gbps.load"]["value"] > 0
    assert m["build_ms.load"]["value"] > 0
    # a window of one request (a loaded machine) has no idle time at all
    assert m["device_idle_pct.ingest"]["value"] >= 0


def test_the_cell_and_its_metrics_are_declared():
    spec = load_bench()
    config, = [c for c in spec["configs"] if c["name"] == "ldbc-graph500-22"]
    assert config["reduced"] == [] == CONFIG["reduced"]
    assert config["file"] == "benchmark/configs/ldbc-graph500-22.json"
    cell, = [w for w in spec["workloads"] if w["name"] == CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "ldbc-graph500-22", "load-wcc", 1)
    by_name = {m["name"]: m for m in spec["end_to_end"] + spec["per_layer"]}
    for name in ("ingest_gevps", "device_idle_pct.ingest"):
        assert by_name[name]["workloads"] == ["graph500-s22.ingest", CELL]
    for name in ("parse_gbps.load", "build_ms.load"):
        m = by_name[name]
        assert m["workloads"] == [CELL] and m["layer"] == "graph input"
        assert (m["moves"], m["source"]) == ("ingest_gevps", "program_span")
    assert CONFIG["limits"] == {"wcc": {"mismatched": 0}}
