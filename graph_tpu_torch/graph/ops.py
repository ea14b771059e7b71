"""Graph transforms over built graphs.

Counterpart of ``graph_tpu.graph.ops`` (reference analog:
crates/builder/src/graph_ops.rs — degree-descending relabel
(graph_ops.rs:135-174,511-638), to_undirected (graph_ops.rs:176-230;
csr.rs:391-464), degree partitioning (graph_ops.rs:17-50,331-440)).

A relabel is one stable sort for the new ids and a CSR rebuild from the
relabeled edges, run where the graph's tensors lie.  Graphs are
immutable, so every op returns a new graph (the reference mutates in
place via ``swap_csr``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from graph_tpu_torch.errors import InvalidPartitioning
from graph_tpu_torch.graph.build import csr_from_coo
from graph_tpu_torch.graph.csr import (
    CsrLayout, DirectedCsrGraph, UndirectedCsrGraph)


def degree_order_permutation(degrees: np.ndarray) -> np.ndarray:
    """Map old node id → new node id, degree-descending.

    Exact reference semantics (graph_ops.rs:542-558): pairs
    ``(degree, node)`` sorted by the reversed tuple ordering — descending
    degree, ties broken by *descending* old node id.
    """
    n = degrees.shape[0]
    order = np.lexsort((-np.arange(n), -degrees.astype(np.int64)))
    new_id = np.empty(n, dtype=np.int64)
    new_id[order] = np.arange(n)
    return new_id


def _degree_order(degrees: torch.Tensor) -> torch.Tensor:
    """New id → old id: :func:`degree_order_permutation`'s order, on the
    degrees' device.  The old ids enter in descending order, so one
    stable sort by descending degree keeps ties in descending old id."""
    n = degrees.numel()
    desc = torch.arange(n - 1, -1, -1, device=degrees.device)
    return desc[torch.sort(-degrees.long()[desc], stable=True).indices]


def make_degree_ordered(graph: UndirectedCsrGraph) -> UndirectedCsrGraph:
    """Relabel node ids by descending degree; returns a new graph.

    Reference analog: ``RelabelByDegreeOp::make_degree_ordered``
    (graph_ops.rs:135-174).  The result always has sorted neighbor lists
    (the reference sorts relabeled targets, graph_ops.rs:632); a
    DEDUPLICATED input stays deduplicated.  The relabel runs where the
    graph lies: on its device, or on the host for a host-resident graph,
    whose result stays host-resident.  Node values follow their nodes.

    >>> from graph_tpu_torch.graph.build import build_undirected
    >>> g = build_undirected([3, 3, 3, 0], [0, 1, 2, 1], node_count=4,
    ...                      device="cpu")
    >>> g2 = make_degree_ordered(g)  # hub node 3 becomes node 0
    >>> g2.degrees().tolist()
    [3, 2, 2, 1]
    """
    csr = graph.csr
    old_id = _degree_order(csr.degrees())
    new_id = torch.empty_like(old_id)
    new_id[old_id] = torch.arange(old_id.numel(), device=old_id.device)
    # relabel never re-dedups; the lists come out sorted
    new_csr = csr_from_coo(
        new_id[csr.sources.long()], new_id[csr.targets.long()], csr.values,
        node_count=graph.node_count, layout=CsrLayout.SORTED,
        id_dtype=csr.id_dtype, device=csr.device)
    layout = (CsrLayout.DEDUPLICATED
              if graph.layout is CsrLayout.DEDUPLICATED else CsrLayout.SORTED)
    node_values = graph.node_values
    if node_values is not None:
        node_values = node_values[old_id]
    return UndirectedCsrGraph(csr=new_csr, node_values=node_values,
                              layout=layout, host=graph.host)


def to_undirected(
    graph: DirectedCsrGraph, layout: Optional[CsrLayout] = None
) -> UndirectedCsrGraph:
    """Directed → undirected by streaming out-edges both ways, on the
    graph's device.

    Reference analog: ``ToUndirectedOp`` (graph_ops.rs:176-230,
    csr.rs:391-464); default layout is UNSORTED (``CsrLayout::default``).
    """
    layout = layout or CsrLayout.UNSORTED
    out = graph.csr_out
    vals = (None if out.values is None
            else torch.cat([out.values, out.values]))
    csr = csr_from_coo(
        torch.cat([out.sources, out.targets]),
        torch.cat([out.targets, out.sources]), vals,
        node_count=graph.node_count, layout=layout, id_dtype=out.id_dtype,
        device=graph.device)
    return UndirectedCsrGraph(csr=csr, node_values=graph.node_values,
                              layout=layout)


def degree_partition(degrees, concurrency: int) -> list:
    """Greedy ranges of ≈equal total degree.

    Reference analog: ``degree_partition`` / ``greedy_node_map_partition``
    (graph_ops.rs:331-440): the host-side split used to row-block a CSR
    across devices.  ``degrees`` is a sequence, array or tensor.

    >>> degree_partition([1, 1, 1, 1], 2)
    [(0, 2), (2, 4)]
    >>> degree_partition([9, 1, 1, 1], 2)  # hub gets its own range
    [(0, 1), (1, 4)]
    """
    if isinstance(degrees, torch.Tensor):
        degrees = degrees.cpu().numpy()
    degrees = np.asarray(degrees, dtype=np.int64)
    if concurrency < 1:
        # Reference: partitioning with an invalid config is an
        # Error::InvalidPartitioning (builder/src/lib.rs:274-302), not a
        # silent clamp.
        raise InvalidPartitioning(
            f"concurrency must be >= 1, got {concurrency}")
    if (degrees < 0).any():
        raise InvalidPartitioning("degrees must be non-negative")
    n = degrees.shape[0]
    total = int(degrees.sum()) + n
    batch = max(total // concurrency, 1)
    partitions = []
    start = 0
    acc = 0
    for u in range(n):
        acc += int(degrees[u]) + 1
        if acc >= batch and u + 1 > start:
            partitions.append((start, u + 1))
            start = u + 1
            acc = 0
    if start < n or not partitions:
        partitions.append((start, n))
    return partitions
