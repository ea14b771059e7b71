"""User-facing API: ``Graph`` / ``DiGraph`` classes.

Counterpart of ``graph_tpu.api`` (reference analog: the ``graph_mate``
PyO3 bindings, crates/mate/src/: ``Graph`` (undirected, u32 ids),
``DiGraph`` (directed), ``Layout``, ``FileFormat``, result classes with
timing, kwargs-only algorithm configs, crates/mate/graph_mate.pyi:1-199).

Graphs live on ``device``: every constructor and ``load`` takes
``device=None``, which means the card, and raises when there is none
(:func:`graph_tpu_torch.device.resolve_device`); pass ``device="cpu"`` to
run on the CPU.  Algorithms run where the graph lies.

Every algorithm call is an ``api.<method>`` span and every copy of an
answer to the host a ``result.to_host`` span (counter ``bytes``),
``from_numpy`` a ``graph.build`` span, and ``load`` an ``api.load`` span
with counters ``bytes`` (the file's size), ``edges`` and ``nodes`` (the
loaded graph's) (:mod:`graph_tpu_torch.profile`).

Zero-copy semantics: neighbor queries return read-only numpy *views* into
one cached host copy of each CSR's offsets and targets (the analog of
mate's ``SharedSlice`` aliasing Rust memory, crates/mate/src/graphs/
shared_slice.rs:29-161).  Views stay valid after the graph is dropped,
because they hold the base buffer alive.

Example (mirrors the runnable examples on every public API in the
reference, crates/builder/src/lib.rs:44-251):

    >>> import numpy as np
    >>> from graph_tpu_torch.api import Graph, DiGraph, Layout
    >>> g = Graph.from_numpy(np.array([[0, 1], [1, 2], [2, 0]],
    ...                               dtype=np.uint32), layout=Layout.Sorted,
    ...                      device="cpu")
    >>> (g.node_count(), g.edge_count())
    (3, 3)
    >>> g.degree(0)
    2
    >>> sorted(g.copy_neighbors(1))
    [0, 2]
    >>> g.global_triangle_count().triangles
    1
    >>> dg = DiGraph.from_numpy(np.array([[0, 1], [0, 2]], dtype=np.uint32),
    ...                         device="cpu")
    >>> (dg.out_degree(0), dg.in_degree(2))
    (2, 1)
"""

from __future__ import annotations

import os
import time

import numpy as np

from graph_tpu_torch import profile
from graph_tpu_torch.algos.pagerank import PageRankConfig, page_rank
from graph_tpu_torch.algos.sssp import DeltaSteppingConfig, delta_stepping
from graph_tpu_torch.algos.triangle_count import global_triangle_count
from graph_tpu_torch.algos.wcc import WccConfig, wcc
from graph_tpu_torch.device import resolve_device, to_host
from graph_tpu_torch.graph import ops as _ops
from graph_tpu_torch.graph.build import build_directed, build_undirected
from graph_tpu_torch.graph.csr import CsrLayout

#: Node ids of API graphs: u32 in graph_mate, int32 here.
ID_DTYPE = np.int32


class Layout:
    """mate ``Layout`` analog (graphs/mod.rs:50-75)."""

    Sorted = CsrLayout.SORTED
    Unsorted = CsrLayout.UNSORTED
    Deduplicated = CsrLayout.DEDUPLICATED


class FileFormat:
    """mate ``FileFormat`` analog."""

    Graph500 = "graph500"
    EdgeList = "edge-list"


class PageRankResult:
    """mate ``PageRankResult`` analog (crates/mate/src/page_rank.rs:42-74).

    ``scores()`` copies the scores to the host on its FIRST call and
    caches the array, so that constructing a result never waits for the
    copy.
    """

    def __init__(self, inner):
        self._device_scores = inner.scores
        self._scores = None
        self.ran_iterations = inner.ran_iterations
        self.error = inner.error
        self.micros = inner.micros

    def scores(self) -> np.ndarray:
        if self._scores is None:
            self._scores = to_host(self._device_scores)
        return self._scores

    def __repr__(self):
        return (
            f"PageRankResult {{ ran_iterations: {self.ran_iterations}, "
            f"error: {self.error}, took: {self.micros}us }}"
        )


class WccResult:
    """mate ``WccResult`` analog (crates/mate/src/wcc.rs:43-88)."""

    def __init__(self, inner):
        self._device_components = inner.components
        self._components = None  # copied lazily, like PageRankResult
        self.micros = inner.micros

    def components(self) -> np.ndarray:
        if self._components is None:
            self._components = to_host(self._device_components)
        return self._components

    def __repr__(self):
        return f"WccResult {{ took: {self.micros}us }}"


class TriangleCountResult:
    """mate ``TriangleCountResult`` analog."""

    def __init__(self, inner):
        self.triangles = inner.triangles
        self.micros = inner.micros

    def __repr__(self):
        return (
            f"TriangleCountResult {{ triangles: {self.triangles}, "
            f"took: {self.micros}us }}"
        )


class SsspResult:
    """Server sssp analog (no mate class; the server exposes it)."""

    def __init__(self, inner):
        self._distances = to_host(inner.distances)
        self.micros = inner.micros

    def distances(self) -> np.ndarray:
        return self._distances


def _load(build, path, layout, file_format, device):
    """``build`` over the edges of the file at ``path``, in an ``api.load``
    span; returns the graph and the load's microseconds."""
    device = resolve_device(device)
    with profile.span("api.load") as sp:
        t0 = time.perf_counter()
        src, dst, values, n = _load_coo(path, file_format)
        g = build(src, dst, values, node_count=n, layout=layout,
                  id_dtype=ID_DTYPE, device=device)
        if sp:
            sp.count(bytes=os.path.getsize(path), edges=g.edge_count,
                     nodes=g.node_count)
        return g, int((time.perf_counter() - t0) * 1e6)


def _load_coo(path, file_format, weighted=False):
    if file_format == FileFormat.Graph500:
        from graph_tpu_torch.io.graph500 import read_graph500

        src, dst, n = read_graph500(path)
        return src, dst, None, n
    from graph_tpu_torch.io.edgelist import read_edge_list

    src, dst, values = read_edge_list(path, weighted or None)
    return src, dst, values, None


def _edge_array(arr) -> np.ndarray:
    """An ``(m, 2)`` edge array as int64 ids (unsigned inputs included)."""
    arr = np.asarray(arr)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"expected (m, 2) edge array, got {arr.shape}")
    with profile.span("graph.build.host"):
        return arr.astype(np.int64)


def _wcc_config(chunk_size, neighbor_rounds, sampling_size) -> WccConfig:
    return WccConfig(
        chunk_size=chunk_size or WccConfig.DEFAULT_CHUNK_SIZE,
        neighbor_rounds=neighbor_rounds or WccConfig.DEFAULT_NEIGHBOR_ROUNDS,
        sampling_size=sampling_size or WccConfig.DEFAULT_SAMPLING_SIZE,
    )


class _GraphBase:
    def __init__(self, inner, load_micros=0):
        self._g = inner
        self._load_micros = load_micros
        self._host_cache = {}

    @property
    def device(self):
        """Where the graph's tensors lie."""
        return self._g.device

    def node_count(self) -> int:
        return self._g.node_count

    def edge_count(self) -> int:
        return self._g.edge_count

    def _np(self, key, tensor) -> np.ndarray:
        """The one read-only host copy of ``tensor``, made on first use."""
        cached = self._host_cache.get(key)
        if cached is None:
            cached = tensor.cpu().numpy()
            cached.flags.writeable = False
            self._host_cache[key] = cached
        return cached

    def _neighbor_view(self, csr_key, csr, node) -> np.ndarray:
        offsets = self._np(csr_key + ".offsets", csr.offsets)
        targets = self._np(csr_key + ".targets", csr.targets)
        return targets[offsets[node] : offsets[node + 1]]

    def _degree(self, csr_key, csr, node) -> int:
        offsets = self._np(csr_key + ".offsets", csr.offsets)
        return int(offsets[node + 1] - offsets[node])


class Graph(_GraphBase):
    """Undirected graph with 32-bit node ids (mate ``Graph`` analog)."""

    @staticmethod
    def load(path: str, layout=Layout.Unsorted,
             file_format=FileFormat.Graph500, device=None) -> "Graph":
        return Graph(*_load(build_undirected, path, layout, file_format,
                            device))

    @staticmethod
    def from_numpy(arr: np.ndarray, layout=Layout.Unsorted,
                   device=None) -> "Graph":
        with profile.span("graph.build"):
            arr = _edge_array(arr)
            return Graph(build_undirected(
                arr[:, 0], arr[:, 1], layout=layout, id_dtype=ID_DTYPE,
                device=resolve_device(device)))

    @staticmethod
    def from_pandas(df, layout=Layout.Unsorted, device=None) -> "Graph":
        return Graph.from_numpy(df.to_numpy(), layout=layout, device=device)

    def degree(self, node: int) -> int:
        return self._degree("csr", self._g.csr, node)

    def neighbors(self, node: int) -> np.ndarray:
        return self._neighbor_view("csr", self._g.csr, node)

    def copy_neighbors(self, node: int) -> list:
        return self.neighbors(node).tolist()

    def make_degree_ordered(self) -> None:
        """In-place degree-descending relabel (mate semantics)."""
        self._g = _ops.make_degree_ordered(self._g)
        self._host_cache.clear()

    def global_triangle_count(self) -> TriangleCountResult:
        with profile.span("api.global_triangle_count"):
            return TriangleCountResult(global_triangle_count(self._g))

    def wcc(self, *, chunk_size=None, neighbor_rounds=None,
            sampling_size=None) -> WccResult:
        with profile.span("api.wcc"):
            return WccResult(wcc(self._g, _wcc_config(
                chunk_size, neighbor_rounds, sampling_size)))

    def __repr__(self):
        return (
            f"Graph {{ node_count: {self.node_count()}, "
            f"edge_count: {self.edge_count()}, load_took: {self._load_micros}us }}"
        )


class DiGraph(_GraphBase):
    """Directed graph with 32-bit node ids (mate ``DiGraph`` analog)."""

    @staticmethod
    def load(path: str, layout=Layout.Unsorted,
             file_format=FileFormat.Graph500, device=None) -> "DiGraph":
        return DiGraph(*_load(build_directed, path, layout, file_format,
                              device))

    @staticmethod
    def from_numpy(arr: np.ndarray, layout=Layout.Unsorted, device=None, *,
                   weights=None) -> "DiGraph":
        """A directed graph of the ``(m, 2)`` edge array ``arr``;
        ``weights``, of shape ``(m,)``, are its edges' values, which
        ``delta_stepping`` needs."""
        with profile.span("graph.build"):
            arr = _edge_array(arr)
            if weights is not None:
                weights = np.asarray(weights)
                if weights.shape != (arr.shape[0],):
                    raise ValueError(f"expected ({arr.shape[0]},) weights, "
                                     f"got {weights.shape}")
            return DiGraph(build_directed(
                arr[:, 0], arr[:, 1], weights, layout=layout,
                id_dtype=ID_DTYPE, device=resolve_device(device)))

    @staticmethod
    def from_pandas(df, layout=Layout.Unsorted, device=None) -> "DiGraph":
        return DiGraph.from_numpy(df.to_numpy(), layout=layout, device=device)

    def out_degree(self, node: int) -> int:
        return self._degree("out", self._g.csr_out, node)

    def in_degree(self, node: int) -> int:
        return self._degree("in", self._g.csr_in, node)

    def out_neighbors(self, node: int) -> np.ndarray:
        return self._neighbor_view("out", self._g.csr_out, node)

    def in_neighbors(self, node: int) -> np.ndarray:
        return self._neighbor_view("in", self._g.csr_in, node)

    def copy_out_neighbors(self, node: int) -> list:
        return self.out_neighbors(node).tolist()

    def copy_in_neighbors(self, node: int) -> list:
        return self.in_neighbors(node).tolist()

    def to_undirected(self, layout=None) -> Graph:
        return Graph(_ops.to_undirected(self._g, layout))

    def page_rank(self, *, max_iterations=None, tolerance=None,
                  damping_factor=None) -> PageRankResult:
        cfg = PageRankConfig(
            max_iterations=(max_iterations if max_iterations is not None
                            else PageRankConfig.DEFAULT_MAX_ITERATIONS),
            tolerance=(tolerance if tolerance is not None
                       else PageRankConfig.DEFAULT_TOLERANCE),
            damping_factor=(damping_factor if damping_factor is not None
                            else PageRankConfig.DEFAULT_DAMPING_FACTOR),
        )
        with profile.span("api.page_rank"):
            return PageRankResult(page_rank(self._g, cfg))

    def wcc(self, *, chunk_size=None, neighbor_rounds=None,
            sampling_size=None) -> WccResult:
        with profile.span("api.wcc"):
            return WccResult(wcc(self._g, _wcc_config(
                chunk_size, neighbor_rounds, sampling_size)))

    def delta_stepping(self, *, start_node: int, delta: float) -> SsspResult:
        with profile.span("api.delta_stepping"):
            return SsspResult(delta_stepping(
                self._g, DeltaSteppingConfig(int(start_node), float(delta))))

    def __repr__(self):
        return (
            f"DiGraph {{ node_count: {self.node_count()}, "
            f"edge_count: {self.edge_count()}, load_took: {self._load_micros}us }}"
        )
