"""Named-graph catalog + property store.

Counterpart of ``graph_tpu.server.catalog`` (reference analog:
crates/server/src/catalog.rs:14-288): a ``GraphType`` enum over
directed/undirected (the CSR graphs are held directly), a named-graph
map, and a ``PropertyId -> column`` store.

Unlike ``graph_tpu``'s store, which builds Arrow record batches on
insert, a property is one host numpy array, and the Flight transport
cuts it into batches of ``CHUNK_SIZE`` rows when it is fetched
(:func:`chunks`): the request path imports no pyarrow, so it runs on
machines that have none.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import numpy as np

from graph_tpu_torch.errors import GraphNotFound
from graph_tpu_torch.graph.csr import DirectedCsrGraph

CHUNK_SIZE = 10_000  # rows per record batch (server.rs:34)


def graph_type_name(g) -> str:
    if isinstance(g, DirectedCsrGraph):
        return "Directed" if g.csr_out.values is None else "DirectedWeighted"
    return "Undirected" if g.csr.values is None else "UndirectedWeighted"


def chunks(values: np.ndarray) -> List[np.ndarray]:
    """The record batches' rows of a column: views of ``CHUNK_SIZE`` rows,
    and one empty view for an empty column."""
    return [values[i : i + CHUNK_SIZE]
            for i in range(0, len(values), CHUNK_SIZE)] or [values[:0]]


class GraphCatalog:
    """Thread-safe named graph map (catalog.rs:148-213)."""

    def __init__(self):
        self._graphs = {}
        self._lock = threading.RLock()

    def get(self, name: str):
        with self._lock:
            try:
                return self._graphs[name]
            except KeyError:
                raise GraphNotFound(f"Graph with name '{name}' not found")

    def insert(self, name: str, graph) -> None:
        with self._lock:
            self._graphs[name] = graph

    def remove(self, name: str) -> Tuple[str, str, int, int]:
        """Remove and return the graph's info tuple.

        The reference returns the removed graph's ``GraphInfo``
        (catalog.rs:191-205), which the server serializes back to the
        client (server.rs:333-339).
        """
        with self._lock:
            if name not in self._graphs:
                raise GraphNotFound(f"Graph with name '{name}' not found")
            g = self._graphs.pop(name)
            return (name, graph_type_name(g), g.node_count, g.edge_count)

    def list(self) -> List[Tuple[str, str, int, int]]:
        with self._lock:
            return [
                (name, graph_type_name(g), g.node_count, g.edge_count)
                for name, g in self._graphs.items()
            ]


class PropertyStore:
    """(graph, key) -> (field name, host column) (catalog.rs:240-268)."""

    def __init__(self):
        self._props: Dict[Tuple[str, str], Tuple[str, np.ndarray]] = {}
        self._lock = threading.RLock()

    def insert(self, graph_name: str, key: str, field_name: str,
               values: np.ndarray) -> None:
        with self._lock:
            self._props[(graph_name, key)] = (field_name, np.asarray(values))

    def get(self, graph_name: str, key: str) -> Tuple[str, np.ndarray]:
        with self._lock:
            try:
                return self._props[(graph_name, key)]
            except KeyError:
                raise GraphNotFound(
                    f"Property '{key}' for graph '{graph_name}' not found"
                )
