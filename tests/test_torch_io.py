"""The port's readers, snapshots and dataset loader against graph_tpu's.

Every fixture is written into ``tmp_path``: the inline contents that
tests/test_io.py and tests/test_dotgraph.py read from their resource
files, and seeded RMAT edge lists.  Each reader's output (arrays and
dtypes) and each graph built from it must equal graph_tpu's exactly, and
a snapshot written by either package must load in the other.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest

import graph_tpu_torch as gtt
from graph_tpu import GraphBuilder as JaxBuilder
from graph_tpu.errors import GraphError as JaxGraphError
from graph_tpu.errors import InvalidIdType as JaxInvalidIdType
from graph_tpu.graph.build import build_directed as jax_build_directed
from graph_tpu.graph.build import build_undirected as jax_build_undirected
from graph_tpu.graph.csr import CsrLayout as JaxLayout
from graph_tpu.io import binary as jax_binary
from graph_tpu.io import datasets as jax_datasets
from graph_tpu.io import dotgraph as jax_dotgraph
from graph_tpu.io.edgelist import read_edge_list as jax_read_edge_list
from graph_tpu.io.gdl import _Parser as JaxGdlParser
from graph_tpu.io.gdl import _tokenize as jax_tokenize
from graph_tpu.io.gdl import parse_gdl as jax_parse_gdl
from graph_tpu.io.graph500 import read_graph500 as jax_read_graph500
from graph_tpu_torch.generate import host_rmat
from graph_tpu_torch.io import dotgraph, edgelist
from graph_tpu_torch.io.gdl import _Parser, _tokenize, parse_gdl
from graph_tpu_torch.io.graph500 import read_graph500, write_graph500
from graph_tpu_torch.native import edge_list_parser

TEST_EL = "0 1\n0 2\n1 2\n1 3\n2 4\n3 4\n"
TEST_WEL = "0 1 0.1\n0 2 0.2\n1 2 0.3\n1 3 0.4\n2 4 0.5\n3 4 0.6\n"
WINDOWS_EL = "0 1\r\n0 2\r\n1 3\r\n"
#: resources/test.graph of the reference (dotgraph.rs:534-625's fixture).
TEST_GRAPH = ("t 5 6\nv 0 0 2\nv 1 1 3\nv 2 2 3\nv 3 1 2\nv 4 2 2\n"
              "e 0 1\ne 0 2\ne 1 2\ne 1 3\ne 2 4\ne 3 4\n")
LAYOUTS = ["UNSORTED", "SORTED", "DEDUPLICATED"]


def _same(got, want):
    """A port array (tensor or numpy) equals a graph_tpu one exactly."""
    if want is None:
        assert got is None
        return
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _same_csr(got, want):
    for f in ("offsets", "sources", "targets", "values"):
        _same(getattr(got, f), getattr(want, f))


def _same_graph(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.layout.name == want.layout.name
    if hasattr(want, "csr_out"):
        _same_csr(got.csr_out, want.csr_out)
        _same_csr(got.csr_in, want.csr_in)
    else:
        _same_csr(got.csr, want.csr)


def _rmat_text(tmp_path, weighted=False):
    src, dst = host_rmat(8, seed=11)
    lines = [f"{s} {d}" for s, d in zip(src, dst)]
    if weighted:
        w = np.random.default_rng(4).random(src.size).astype(np.float32)
        lines = [f"{line} {v!r}" for line, v in zip(lines, w.tolist())]
    p = tmp_path / ("rmat.wel" if weighted else "rmat.el")
    p.write_text("\n".join(lines) + "\n")
    return str(p)


@pytest.mark.parametrize("name,text", [
    ("test.el", TEST_EL), ("test.wel", TEST_WEL), ("windows.el", WINDOWS_EL),
    ("rmat.el", None), ("rmat.wel", None)])
def test_read_edge_list_matches_graph_tpu(tmp_path, name, text):
    if text is None:
        path = _rmat_text(tmp_path, weighted=name.endswith(".wel"))
    else:
        path = str(tmp_path / name)
        (tmp_path / name).write_bytes(text.encode())
    got = edgelist.read_edge_list(path)
    assert edge_list_parser.load_error() is None  # the native parser ran
    want = jax_read_edge_list(path)
    for g, w in zip(got, want):
        _same(g, w)
    if name == "windows.el":
        assert got[0].tolist() == [0, 0, 1] and got[1].tolist() == [1, 2, 3]
    if name.endswith(".wel"):
        assert got[2].dtype == np.float32


@pytest.mark.parametrize("weighted", [False, True])
def test_pandas_fallback_matches_native(tmp_path, weighted):
    path = _rmat_text(tmp_path, weighted)
    for g, w in zip(edgelist._parse_pandas(path, weighted),
                    edgelist.read_edge_list(path)):
        _same(g, w)


def test_pandas_fallback_runs_without_the_native_parser(tmp_path,
                                                       monkeypatch):
    path = tmp_path / "windows.el"
    path.write_bytes(WINDOWS_EL.encode())
    monkeypatch.setattr(edgelist.edge_list_parser, "parse", lambda p, w: None)
    ran, pandas = [], edgelist._parse_pandas
    monkeypatch.setattr(edgelist, "_parse_pandas",
                        lambda p, w: ran.append(p) or pandas(p, w))
    src, dst, _ = edgelist.read_edge_list(str(path))
    assert ran == [str(path)]
    assert src.tolist() == [0, 0, 1] and dst.tolist() == [1, 2, 3]


def test_native_parser_reports_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        edgelist.read_edge_list(str(tmp_path / "absent.el"))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_builder_from_edge_list_matches_graph_tpu(tmp_path, layout):
    path = _rmat_text(tmp_path, weighted=True)
    got = (gtt.GraphBuilder(device="cpu").csr_layout(gtt.CsrLayout[layout])
           .path(path).build_directed())
    want = JaxBuilder().csr_layout(JaxLayout[layout]).path(path) \
        .build_directed()
    _same_graph(got, want)


def test_graph500_roundtrip_matches_graph_tpu(tmp_path):
    src, dst = host_rmat(8, seed=5)
    path = str(tmp_path / "rmat.graph500")
    write_graph500(path, src, dst)
    got, want = read_graph500(path), jax_read_graph500(path)
    for g, w in zip(got, want):
        _same(g, w)
    assert got[2] == src.size // 16
    np.testing.assert_array_equal(got[0], src)
    np.testing.assert_array_equal(got[1], dst)
    b = gtt.GraphBuilder(device="cpu").file_format(gtt.Graph500Input())
    from graph_tpu.io.graph500 import Graph500Input as JaxGraph500Input
    _same_graph(b.path(path).build_directed(),
                JaxBuilder().file_format(JaxGraph500Input()).path(path)
                .build_directed())


def test_graph500_ids_above_2_32(tmp_path):
    """The high word carries bits 32-47 of both ids."""
    src = np.array([0, 2**32 + 5, 2**40 + 1, 2**47 - 1], np.int64)
    dst = np.array([2**33, 7, 2**44 + 3, 2**46], np.int64)
    path = str(tmp_path / "wide.graph500")
    write_graph500(path, src, dst)
    for read in (read_graph500, jax_read_graph500):
        s, d, n = read(path)
        np.testing.assert_array_equal(s, src)
        np.testing.assert_array_equal(d, dst)
        assert n == 0


GDL_CASES = [
    "(a)-->(b),(b)-->(c)",
    "(a)-->()-->()<--(a)",
    "(a:A)(b:B)(a)-[{cost: 4.0}]->(b)",
    "(a { value: 42 })-->(b { value: 7 })",
    "(a)<--(b), (b)-[:T {w: 1.0}]->(c)-->(a)",
]


@pytest.mark.parametrize("text", GDL_CASES)
def test_gdl_matches_graph_tpu(text):
    for g, w in zip(parse_gdl(text), jax_parse_gdl(text)):
        if isinstance(w, int):
            assert g == w
        else:
            _same(g, w)
    p, q = _Parser(_tokenize(text)).parse(), JaxGdlParser(
        jax_tokenize(text)).parse()
    assert (p.node_values, p.node_labels, p.edges) == (
        q.node_values, q.node_labels, q.edges)


def test_gdl_error_matches_graph_tpu():
    with pytest.raises(gtt.GraphError):
        parse_gdl("(a)-x(b)")
    with pytest.raises(JaxGraphError):
        jax_parse_gdl("(a)-x(b)")


def _dotgraph_files(tmp_path):
    (tmp_path / "test.graph").write_text(TEST_GRAPH)
    g = np.random.default_rng(9)
    n, m = 40, 120
    lines = [f"t {n} {m}"]
    lines += [f"v {v} {g.integers(0, 6)} 0" for v in range(n)]
    lines += [f"e {s} {t}" for s, t in g.integers(0, n, (m, 2))]
    (tmp_path / "rand.graph").write_text("\n".join(lines) + "\n")
    return [str(tmp_path / "test.graph"), str(tmp_path / "rand.graph")]


def test_dotgraph_matches_graph_tpu(tmp_path):
    for path in _dotgraph_files(tmp_path):
        got = dotgraph.read_dotgraph(path)
        want = jax_dotgraph.read_dotgraph(path)
        for f in ("labels", "src", "dst"):
            _same(getattr(got, f), getattr(want, f))
        assert (got.max_degree, got.max_label, got.label_frequency,
                got.node_count, got.max_label_frequency()) == (
            want.max_degree, want.max_label, want.label_frequency,
            want.node_count, want.max_label_frequency())
        b = gtt.GraphBuilder(device="cpu").file_format(gtt.DotGraphInput())
        _same_graph(b.path(path).build_undirected(),
                    JaxBuilder().file_format(jax_dotgraph.DotGraphInput())
                    .path(path).build_undirected())


def test_dotgraph_label_statistics_match_graph_tpu(tmp_path):
    for path in _dotgraph_files(tmp_path):
        dg = dotgraph.read_dotgraph(path)
        got = gtt.build_undirected(dg.src, dg.dst, node_count=dg.node_count,
                                   layout=gtt.CsrLayout.SORTED,
                                   node_values=dg.labels, device="cpu")
        want = jax_build_undirected(dg.src, dg.dst, node_count=dg.node_count,
                                    layout=JaxLayout.SORTED,
                                    node_values=dg.labels)
        gs, ws = (dotgraph.LabelStats.from_graph(got),
                  jax_dotgraph.LabelStats.from_graph(want))
        assert gs.__dict__ == ws.__dict__
        gn = dotgraph.NeighborLabelFrequencies(got)
        wn = jax_dotgraph.NeighborLabelFrequencies(want)
        for v in range(dg.node_count):
            a, b = gn.neighbor_frequency(v), wn.neighbor_frequency(v)
            assert list(a.items()) == list(b.items()) and len(a) == len(b)
            assert [a.get(x) for x in range(-1, 8)] == \
                [b.get(x) for x in range(-1, 8)]
        labels = dg.labels
        gi = dotgraph.NodeLabelIndex.from_stats(
            dg.node_count, gs, lambda v: int(labels[v]))
        wi = jax_dotgraph.NodeLabelIndex.from_stats(
            dg.node_count, ws, lambda v: int(labels[v]))
        for lab in range(int(labels.max()) + 1):
            _same(gi.nodes(lab), wi.nodes(lab))


def test_dotgraph_reference_goldens(tmp_path):
    """The reference's expectations on test.graph (dotgraph.rs:565-624)."""
    path = _dotgraph_files(tmp_path)[0]
    dg = dotgraph.read_dotgraph(path)
    g = gtt.build_undirected(dg.src, dg.dst, node_count=dg.node_count,
                             layout=gtt.CsrLayout.SORTED,
                             node_values=dg.labels, device="cpu")
    stats = dotgraph.LabelStats.from_graph(g)
    assert (stats.max_degree, stats.max_label, stats.max_label_frequency,
            stats.label_frequency) == (3, 2, 2, {0: 1, 1: 2, 2: 2})
    nlf = dotgraph.NeighborLabelFrequencies(g)
    assert [nlf.neighbor_frequency(0).get(x) for x in range(3)] == \
        [None, 1, 1]
    assert [nlf.neighbor_frequency(1).get(x) for x in range(3)] == [1, 1, 1]
    idx = dotgraph.NodeLabelIndex(dg.labels)
    assert [idx.nodes(x).tolist() for x in range(3)] == [[0], [1, 3], [2, 4]]


def _snapshot_graphs():
    src, dst = host_rmat(7, seed=2)
    w = np.random.default_rng(1).random(src.size).astype(np.float32)
    nv = np.random.default_rng(2).random(1 << 7).astype(np.float32)
    for layout in LAYOUTS:
        for values in (None, w):
            yield ("directed", layout, values, None, src, dst)
        yield ("undirected", layout, w, nv, src, dst)


@pytest.mark.parametrize("case", list(range(9)))
def test_snapshots_interchange_with_graph_tpu(tmp_path, case):
    kind, layout, values, nv, src, dst = list(_snapshot_graphs())[case]
    n = 1 << 7
    if kind == "directed":
        port = gtt.build_directed(src, dst, values, node_count=n,
                                  layout=gtt.CsrLayout[layout],
                                  node_values=nv, device="cpu")
        ref = jax_build_directed(src.astype(np.int32), dst.astype(np.int32),
                                 None if values is None else
                                 jnp.asarray(values), node_count=n,
                                 layout=JaxLayout[layout], node_values=nv)
    else:
        port = gtt.build_undirected(src, dst, values, node_count=n,
                                    layout=gtt.CsrLayout[layout],
                                    node_values=nv, device="cpu")
        ref = jax_build_undirected(src.astype(np.int32),
                                   dst.astype(np.int32), jnp.asarray(values),
                                   node_count=n, layout=JaxLayout[layout],
                                   node_values=nv)
    p_port, p_ref = tmp_path / "port.bin", tmp_path / "ref.bin"
    gtt.save_graph(str(p_port), port)
    jax_binary.save_graph(str(p_ref), ref)
    assert p_port.read_bytes() == p_ref.read_bytes()
    _same_graph(gtt.load_graph(str(p_ref), device="cpu"),
                jax_binary.load_graph(str(p_port)))
    _same_graph(gtt.load_graph(str(p_ref), device="cpu"), ref)
    _same(gtt.load_graph(str(p_ref), device="cpu").node_values,
          jax_binary.load_graph(str(p_port)).node_values)


def test_snapshot_id_dtype_and_kind_checks(tmp_path):
    g = gtt.GraphBuilder(device="cpu").edges([(0, 1), (1, 2)]) \
        .build_directed()
    p = str(tmp_path / "g.bin")
    gtt.save_graph(p, g)
    with pytest.raises(gtt.InvalidIdType):
        gtt.load_graph(p, id_dtype=np.int64, device="cpu")
    with pytest.raises(JaxInvalidIdType):
        jax_binary.load_graph(p, id_dtype=np.int64)
    with pytest.raises(gtt.InvalidIdType):
        gtt.GraphBuilder(device="cpu").file_format(
            gtt.BinaryInput(np.int64)).path(p)
    (tmp_path / "bad.bin").write_bytes(b"nope")
    with pytest.raises(gtt.GraphError, match="not a graph_tpu snapshot"):
        gtt.load_graph(str(tmp_path / "bad.bin"), device="cpu")
    (tmp_path / "short.bin").write_bytes(open(p, "rb").read()[:-3])
    with pytest.raises(gtt.GraphError, match="truncated"):
        gtt.load_graph(str(tmp_path / "short.bin"), device="cpu")


def test_dataset_loader_local_checksummed(tmp_path):
    from graph_tpu_torch.io.datasets import graph500_path, load_graph500

    root = tmp_path / "datasets"
    d = root / "graph-500-22"
    d.mkdir(parents=True)
    e = d / "graph500-22.e"
    e.write_text("0 1\n1 2\n2 0\n")
    assert graph500_path(22, str(root)) == str(e)
    for directed in (False, True):
        _same_graph(load_graph500(22, str(root), directed=directed,
                                  device="cpu"),
                    jax_datasets.load_graph500(22, str(root),
                                               directed=directed))
    good = hashlib.sha256(e.read_bytes()).hexdigest()
    (d / "graph500-22.e.sha256").write_text(good + "  graph500-22.e\n")
    assert graph500_path(22, str(root)) == str(e)
    (d / "graph500-22.e.sha256").write_text("deadbeef\n")
    with pytest.raises(gtt.GraphError, match="checksum mismatch"):
        graph500_path(22, str(root))
    with pytest.raises(gtt.GraphError, match="not found at .*graph-500-23"):
        graph500_path(23, str(root))


def test_dataset_dir_is_the_ports_own(monkeypatch, tmp_path):
    from graph_tpu_torch.io.datasets import dataset_dir

    monkeypatch.delenv("GRAPH_TPU_TORCH_DATASETS", raising=False)
    monkeypatch.setenv("GRAPH_TPU_DATASETS", str(tmp_path / "jax"))
    assert dataset_dir().endswith(".cache/datasets")
    monkeypatch.setenv("GRAPH_TPU_TORCH_DATASETS", str(tmp_path))
    assert dataset_dir() == str(tmp_path)
