"""Fluent graph builder.

Counterpart of ``graph_tpu.builder`` (reference analog: the type-state
``GraphBuilder``, crates/builder/src/builder.rs:12-540, with states
``Uninitialized → FromEdges | FromEdgesWithValues | FromGdlString |
FromInput → FromPath → build()``).  One fluent class; the target graph
type is chosen at ``build(...)`` (the reference selects it through the
turbofish type parameter, builder.rs:530).  ``device`` goes through to
the builds and to snapshot loads: the card unless the caller passes
``device="cpu"``.

>>> from graph_tpu_torch import GraphBuilder
>>> g = (GraphBuilder(device="cpu").edges([(0, 1), (0, 2), (1, 2)])
...      .build_directed())
>>> (g.node_count, g.edge_count)
(3, 3)
>>> g.csr_out.neighbors_np(0).tolist()
[1, 2]
>>> w = (GraphBuilder(device="cpu")
...      .edges_with_values([(0, 1, 0.5), (1, 2, 0.25)])
...      .build_directed())
>>> float(w.csr_out.values[0])
0.5
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np
import torch

from graph_tpu_torch.errors import GraphError, InvalidNodeValues
from graph_tpu_torch.graph.build import (
    _infer_node_count, build_directed, build_undirected,
    build_undirected_host)
from graph_tpu_torch.graph.csr import (
    CsrLayout, DirectedCsrGraph, UndirectedCsrGraph)


def _as_ids(a):
    """An edge endpoint array as given: tensors stay tensors."""
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


class GraphBuilder:
    def __init__(self, device=None):
        self._device = device
        self._layout = CsrLayout.UNSORTED
        self._id_dtype = np.int32
        self._format = None
        self._src = None
        self._dst = None
        self._values = None
        self._node_values = None
        self._node_count = None
        self._prebuilt = None  # a whole graph, loaded from a snapshot

    # -- configuration ----------------------------------------------------

    def csr_layout(self, layout: CsrLayout) -> "GraphBuilder":
        """builder.rs:173 analog."""
        self._layout = layout
        return self

    def id_dtype(self, dtype) -> "GraphBuilder":
        """``Idx`` type-parameter analog (int32 default, int64 supported)."""
        self._id_dtype = dtype
        return self

    def node_count(self, n: int) -> "GraphBuilder":
        """Override the inferred max_node_id + 1."""
        self._node_count = int(n)
        return self

    # -- inputs -------------------------------------------------------------

    def edges(self, edges: Iterable[Tuple[int, int]]) -> "GraphBuilder":
        """builder.rs ``edges()`` analog. Accepts (m,2) arrays or tuples."""
        arr = np.asarray(edges if isinstance(edges, np.ndarray)
                         else list(edges))
        if arr.size == 0:
            arr = arr.reshape(0, 2)
        if arr.ndim != 2 or arr.shape[1] != 2:
            raise GraphError(f"edges must be (m, 2)-shaped, got {arr.shape}")
        self._src, self._dst = arr[:, 0], arr[:, 1]
        return self

    def edges_with_values(
        self, edges: Iterable[Tuple[int, int, float]]
    ) -> "GraphBuilder":
        """builder.rs ``edges_with_values()`` analog."""
        rows = list(edges) if not isinstance(edges, np.ndarray) else edges
        arr = np.asarray([(s, t) for s, t, _ in rows], dtype=np.int64)
        if arr.size == 0:
            arr = arr.reshape(0, 2)
        self._src, self._dst = arr[:, 0], arr[:, 1]
        self._values = np.asarray([v for _, _, v in rows], dtype=np.float32)
        return self

    def coo(self, src, dst, values=None) -> "GraphBuilder":
        """Array input, numpy arrays or tensors (graph_mate ``from_numpy``
        analog, crates/mate/src/graphs/mod.rs:169-200)."""
        self._src, self._dst = _as_ids(src), _as_ids(dst)
        self._values = None if values is None else _as_ids(values)
        return self

    def node_values(self, values: Sequence) -> "GraphBuilder":
        """builder.rs ``node_values()`` analog."""
        self._node_values = _as_ids(values)
        return self

    def gdl(self, gdl: str) -> "GraphBuilder":
        """builder.rs ``gdl_str()`` analog (test DSL, input/gdl.rs)."""
        from graph_tpu_torch.io.gdl import parse_gdl

        src, dst, values, node_count = parse_gdl(gdl)
        self._src, self._dst = src, dst
        self._values = values
        if self._node_count is None:
            self._node_count = node_count
        return self

    def file_format(self, fmt) -> "GraphBuilder":
        """builder.rs ``file_format()`` analog; fmt from graph_tpu_torch.io."""
        self._format = fmt
        return self

    def path(self, path: str) -> "GraphBuilder":
        """builder.rs ``path()`` analog: reads the file in the chosen
        format, an edge list by default.  A snapshot format
        (``read_graph``) loads its whole graph onto the builder's device."""
        fmt = self._format
        if fmt is None:
            from graph_tpu_torch.io.edgelist import EdgeListInput

            fmt = EdgeListInput()
        if hasattr(fmt, "read_graph"):
            # snapshot formats carry a whole graph (input/binary.rs:21-28)
            self._prebuilt = fmt.read_graph(path, self._id_dtype,
                                            device=self._device)
            return self
        src, dst, values, node_count = fmt.read(path)
        self._src, self._dst, self._values = src, dst, values
        if self._node_count is None and node_count is not None:
            self._node_count = node_count
        return self

    # -- build --------------------------------------------------------------

    def _check(self):
        if self._src is None and self._prebuilt is None:
            raise GraphError("no edge input provided (edges/coo/gdl/path)")
        if self._node_values is not None:
            n = _infer_node_count(self._src, self._dst, self._node_count)
            if len(self._node_values) != n:
                raise InvalidNodeValues(
                    f"node_values has {len(self._node_values)} entries, "
                    f"graph has {n} nodes"
                )

    def _args(self):
        return dict(node_count=self._node_count, layout=self._layout,
                    id_dtype=self._id_dtype, node_values=self._node_values)

    def build_directed(self) -> DirectedCsrGraph:
        self._check()
        if self._prebuilt is not None:
            if not isinstance(self._prebuilt, DirectedCsrGraph):
                raise GraphError("snapshot contains an undirected graph")
            return self._prebuilt
        return build_directed(self._src, self._dst, self._values,
                              device=self._device, **self._args())

    def build_undirected(self, host: bool = False) -> UndirectedCsrGraph:
        """``host=True`` keeps the CSR in host memory
        (:func:`build_undirected_host`), for pipelines whose next step
        reads the edge list back on the host (triangle counting); an
        algorithm given that graph still runs on the card unless its
        caller passes ``device="cpu"``."""
        self._check()
        if self._prebuilt is not None:
            if not isinstance(self._prebuilt, UndirectedCsrGraph):
                raise GraphError("snapshot contains a directed graph")
            return self._prebuilt
        if host:
            return build_undirected_host(self._src, self._dst, self._values,
                                         **self._args())
        return build_undirected(self._src, self._dst, self._values,
                                device=self._device, **self._args())

    def build(self, graph_type=DirectedCsrGraph):
        """``.build::<G>()`` analog: pass the target class."""
        if graph_type is DirectedCsrGraph:
            return self.build_directed()
        if graph_type is UndirectedCsrGraph:
            return self.build_undirected()
        raise GraphError(f"unknown graph type {graph_type!r}")
