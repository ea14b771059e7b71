"""graph_tpu_torch — the PyTorch and CUDA port of graph_tpu, for an NVIDIA H100.

A package of its own beside ``graph_tpu`` (the JAX reference it is held
against); it imports torch and numpy and nothing of JAX or graph_tpu.
Ported so far: the graph front door (``GraphBuilder``, the edge-list,
Graph500, GDL, DotGraph and binary snapshot inputs, local LDBC datasets,
the host C++ parser and CSR builder), CSR graphs (directed and
undirected) built on the device or the host with their transforms
(degree relabel, ``to_undirected``, degree partitioning) and mutable
adjacency-list graphs, the EdgeEngine with its hand-written CUDA kernels
K1 and K2 and its whole semiring surface (sums, mins, weighted
combines), the out-of-core engine that streams slab plans from pinned
host memory, PageRank, WCC and SSSP on every engine (the plan engine and
the segment-op engines), triangle counting, and the user's surfaces: the
graph_mate-style ``api`` (``Graph``/``DiGraph``), the ``cli`` and the
Arrow Flight ``server``.

Entry points run on the card unless the caller passes ``device="cpu"``,
and raise when no card is present and no device is given.
"""

from graph_tpu_torch.algos import (
    DeltaSteppingConfig, PageRankConfig, PageRankResult, SsspResult,
    TriangleCountResult, WccConfig, WccResult, delta_stepping,
    global_triangle_count, page_rank, page_rank_reference, wcc,
    wcc_afforest, wcc_afforest_dss, wcc_baseline, wcc_components)
from graph_tpu_torch.builder import GraphBuilder
from graph_tpu_torch.engine import (
    EdgeEngine, EdgePlan, OocEdgeEngine, build_plan)
from graph_tpu_torch.errors import (
    GraphError, InvalidIdType, InvalidNodeValues, InvalidPartitioning)
from graph_tpu_torch.graph import (
    Csr, CsrLayout, DirectedCsrGraph, UndirectedCsrGraph, build_directed,
    build_undirected, build_undirected_host, csr_from_coo,
    degree_order_permutation, degree_partition, make_degree_ordered,
    to_undirected)
from graph_tpu_torch.io import (
    BinaryInput, DotGraphInput, EdgeListInput, Graph500Input, graph500_path,
    load_graph, load_graph500, save_graph)

__all__ = [
    "BinaryInput",
    "Csr",
    "CsrLayout",
    "DeltaSteppingConfig",
    "DirectedCsrGraph",
    "DotGraphInput",
    "EdgeEngine",
    "EdgeListInput",
    "EdgePlan",
    "Graph500Input",
    "GraphBuilder",
    "GraphError",
    "InvalidIdType",
    "InvalidNodeValues",
    "InvalidPartitioning",
    "OocEdgeEngine",
    "PageRankConfig",
    "PageRankResult",
    "SsspResult",
    "TriangleCountResult",
    "UndirectedCsrGraph",
    "WccConfig",
    "WccResult",
    "build_directed",
    "build_plan",
    "build_undirected",
    "build_undirected_host",
    "csr_from_coo",
    "degree_order_permutation",
    "degree_partition",
    "delta_stepping",
    "global_triangle_count",
    "graph500_path",
    "load_graph",
    "load_graph500",
    "make_degree_ordered",
    "page_rank",
    "page_rank_reference",
    "save_graph",
    "to_undirected",
    "wcc",
    "wcc_afforest",
    "wcc_afforest_dss",
    "wcc_baseline",
    "wcc_components",
]
