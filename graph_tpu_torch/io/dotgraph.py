"""DotGraph (``.graph``) labeled-graph input + label machinery.

Counterpart of ``graph_tpu.io.dotgraph`` (reference analog:
crates/builder/src/input/dotgraph.rs:63-532) — the textual format
``t N M`` / ``v id label degree`` / ``e s t`` used by
subgraph-isomorphism tooling, plus:

* ``LabelStats`` — max degree/label, label frequencies (reference:
  parallel range-split + DashMap + CAS max, dotgraph.rs:246-313; here
  one ``bincount`` and a max),
* ``NeighborLabelFrequencies`` — per-node neighbor-label histograms
  (dotgraph.rs:367-429), one accumulated ``index_put_``,
* ``NodeLabelIndex`` — label → nodes CSR by one stable sort
  (dotgraph.rs:440-532's prefix-sum + fetch_add scatter).

The statistics run where the graph's tensors lie and return host values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from graph_tpu_torch.errors import GraphError


@dataclasses.dataclass
class DotGraph:
    """Parsed .graph file (dotgraph.rs:87-119 analog)."""

    labels: np.ndarray  # (n,) int64
    src: np.ndarray
    dst: np.ndarray
    max_degree: int
    max_label: int
    label_frequency: Dict[int, int]

    @property
    def node_count(self) -> int:
        return len(self.labels)

    @property
    def label_count(self) -> int:
        return self.max_label + 1

    def max_label_frequency(self) -> int:
        return max(self.label_frequency.values(), default=0)


def read_dotgraph(path: str) -> DotGraph:
    labels = None
    degrees = None
    srcs = []
    dsts = []
    n = m = 0
    with open(path, "rb") as f:
        for raw in f:
            line = raw.split()
            if not line:
                continue
            kind = line[0]
            if kind == b"t":
                n, m = int(line[1]), int(line[2])
                labels = np.zeros(n, dtype=np.int64)
                degrees = np.zeros(n, dtype=np.int64)
            elif kind in (b"v", b"n"):  # 'n' tolerated (resources/example.graph)
                if labels is None:
                    raise GraphError(f"{path}: node line before 't' header")
                node, label, degree = int(line[1]), int(line[2]), int(line[3])
                labels[node] = label
                degrees[node] = degree
            elif kind == b"e":
                srcs.append(int(line[1]))
                dsts.append(int(line[2]))
            else:
                raise GraphError(f"{path}: unknown line type {kind!r}")
    if labels is None:
        raise GraphError(f"{path}: missing 't N M' header")
    if len(srcs) != m:
        raise GraphError(f"{path}: expected {m} edges, found {len(srcs)}")
    uniques, counts = np.unique(labels, return_counts=True)
    return DotGraph(
        labels=labels,
        src=np.asarray(srcs, dtype=np.int64),
        dst=np.asarray(dsts, dtype=np.int64),
        max_degree=int(degrees.max()) if n else 0,
        max_label=int(labels.max()) if n else 0,
        label_frequency={int(u): int(c) for u, c in zip(uniques, counts)},
    )


class DotGraphInput:
    """``InputCapabilities`` analog; node labels become node values."""

    def read(self, path: str):
        dg = read_dotgraph(path)
        return dg.src, dg.dst, None, dg.node_count

    def read_labeled(self, path: str) -> DotGraph:
        return read_dotgraph(path)


@dataclasses.dataclass
class LabelStats:
    """dotgraph.rs:217-313 analog."""

    max_degree: int
    label_count: int
    max_label: int
    max_label_frequency: int
    label_frequency: Dict[int, int]

    @staticmethod
    def from_graph(graph) -> "LabelStats":
        """graph: UndirectedCsrGraph with integer node_values (labels)."""
        labels = graph.node_values.long()
        degrees = graph.csr.degrees()
        counts = torch.bincount(labels).cpu().numpy()
        present = np.nonzero(counts)[0]
        return LabelStats(
            max_degree=int(degrees.max()) if degrees.numel() else 0,
            label_count=len(present),
            max_label=int(labels.max()) if labels.numel() else 0,
            max_label_frequency=int(counts.max()) if counts.size else 0,
            label_frequency={int(l): int(counts[l]) for l in present},
        )


class NeighborLabelFrequencies:
    """dotgraph.rs:367-429 analog.

    The per-node hash maps become one dense (n, label_count) count
    matrix, built with one accumulated ``index_put_``.
    """

    def __init__(self, graph):
        labels = graph.node_values.long()
        sources = graph.csr.sources.long()
        targets = graph.csr.targets.long()
        label_count = int(labels.max()) + 1 if labels.numel() else 0
        counts = torch.zeros((graph.node_count, label_count),
                             dtype=torch.int64, device=labels.device)
        counts.index_put_((sources, labels[targets]),
                          torch.ones_like(sources), accumulate=True)
        self._counts = counts.cpu().numpy()

    def neighbor_frequency(self, node: int) -> "NeighborLabelFrequency":
        return NeighborLabelFrequency(self._counts[node])


class NeighborLabelFrequency:
    def __init__(self, row: np.ndarray):
        self._row = row

    def get(self, label: int) -> Optional[int]:
        if 0 <= label < len(self._row) and self._row[label] > 0:
            return int(self._row[label])
        return None

    def __len__(self) -> int:
        return int((self._row > 0).sum())

    def items(self):
        for label in np.nonzero(self._row)[0]:
            yield int(label), int(self._row[label])


class NodeLabelIndex:
    """label -> sorted node list CSR (dotgraph.rs:440-532 analog)."""

    def __init__(self, labels):
        labels = torch.as_tensor(labels).long()
        order = torch.sort(labels, stable=True).indices
        counts = torch.bincount(labels)
        offsets = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                              device=labels.device)
        torch.cumsum(counts, 0, out=offsets[1:])
        self._offsets = offsets.cpu().numpy()
        self._nodes = order.cpu().numpy()

    @staticmethod
    def from_stats(node_count: int, stats: LabelStats,
                   label_func) -> "NodeLabelIndex":
        return NodeLabelIndex([label_func(v) for v in range(node_count)])

    def nodes(self, label: int) -> np.ndarray:
        return self._nodes[self._offsets[label]: self._offsets[label + 1]]
