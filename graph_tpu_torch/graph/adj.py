"""Mutable adjacency-list graphs: edge buffer + snapshot CSR rebuild.

Counterpart of ``graph_tpu.graph.adj`` (reference analog:
``DirectedALGraph`` / ``UndirectedALGraph``,
crates/builder/src/graph/adj_list.rs:16-601, with the ``EdgeMutation`` /
``EdgeMutationWithValues`` traits, crates/builder/src/lib.rs:414-456).

Mutation appends to a host-side COO buffer; reads snapshot the buffer
into an immutable CSR graph on the graph's device, built lazily and
cached until the next mutation.  The observable semantics match the
reference: the layout is applied to neighbor lists (the reference
maintains it per insert, this applies it per snapshot) and adding an
edge to an unknown node raises :class:`MissingNode`.
"""

from __future__ import annotations

import threading

import numpy as np

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.errors import GraphError
from graph_tpu_torch.graph.build import build_directed, build_undirected
from graph_tpu_torch.graph.csr import CsrLayout


class MissingNode(GraphError):
    """Reference analog: ``Error::MissingNode`` (builder/src/lib.rs)."""

    def __init__(self, node):
        super().__init__(f"Node {node} does not exist in the graph")


class _ALGraphBase:
    _build_fn = None  # build_directed or build_undirected

    def __init__(self, node_count: int, edges=None, values=None,
                 layout=CsrLayout.UNSORTED, id_dtype=np.int32, device=None):
        self._node_count = int(node_count)
        self._id_dtype = id_dtype
        self.device = resolve_device(device)
        edges = [] if edges is None else list(edges)
        self._src = [int(s) for s, _ in edges]
        self._dst = [int(t) for _, t in edges]
        self._values = None
        if values is not None:
            self._values = [float(v) for v in values]
        self.layout = layout
        self._snapshot = None
        # The reference's AL graphs are safe under parallel insertion
        # (adj_list.rs:16-19 Vec<RwLock<Vec<Target>>>); the COO buffer
        # appends to two (three) lists, so concurrent add_edge calls
        # could misalign src/dst pairs without this lock.
        self._mutate_lock = threading.Lock()

    @property
    def node_count(self) -> int:
        return self._node_count

    @property
    def edge_count(self) -> int:
        return len(self._src)

    def _check_node(self, node: int):
        if not (0 <= node < self._node_count):
            raise MissingNode(node)

    def add_edge(self, source: int, target: int) -> None:
        """EdgeMutation::add_edge analog (lib.rs:414-433)."""
        if self._values is not None:
            raise GraphError("weighted graph requires add_edge_with_value")
        self._check_node(source)
        self._check_node(target)
        with self._mutate_lock:
            self._src.append(int(source))
            self._dst.append(int(target))
            self._snapshot = None

    def add_edge_with_value(self, source: int, target: int,
                            value: float) -> None:
        """EdgeMutationWithValues analog (lib.rs:435-456)."""
        self._check_node(source)
        self._check_node(target)
        with self._mutate_lock:
            if self._values is None:
                if self._src:
                    raise GraphError(
                        "unweighted graph cannot take weighted edges")
                self._values = []
            self._src.append(int(source))
            self._dst.append(int(target))
            self._values.append(float(value))
            self._snapshot = None

    def snapshot(self):
        """Immutable CSR view of the current edge buffer, on the graph's
        device."""
        with self._mutate_lock:
            if self._snapshot is None:
                vals = (None if self._values is None
                        else np.asarray(self._values, dtype=np.float32))
                self._snapshot = self._build_fn(
                    np.asarray(self._src, dtype=np.int64),
                    np.asarray(self._dst, dtype=np.int64), vals,
                    node_count=self._node_count, layout=self.layout,
                    id_dtype=self._id_dtype, device=self.device)
            return self._snapshot

    def _csr(self):
        g = self.snapshot()
        return g.csr_out if hasattr(g, "csr_out") else g.csr

    def degrees(self) -> np.ndarray:
        """Per-node (out-)degree, on the host."""
        return self._csr().degrees().cpu().numpy()

    def neighbors(self, node: int) -> np.ndarray:
        """Host copy of one node's (out-)neighbor list."""
        self._check_node(node)
        return self._csr().neighbors_np(node)


class DirectedALGraph(_ALGraphBase):
    """adj_list.rs:279-283 analog."""

    _build_fn = staticmethod(build_directed)


class UndirectedALGraph(_ALGraphBase):
    """adj_list.rs:452-455 analog."""

    _build_fn = staticmethod(build_undirected)
