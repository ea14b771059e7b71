from graph_tpu_torch.graph.csr import (
    Csr, CsrLayout, DirectedCsrGraph, UndirectedCsrGraph)
from graph_tpu_torch.graph.build import (
    build_directed, build_undirected, build_undirected_host, csr_from_coo)
from graph_tpu_torch.graph.ops import (
    degree_order_permutation, degree_partition, make_degree_ordered,
    to_undirected)

__all__ = [
    "Csr",
    "CsrLayout",
    "DirectedCsrGraph",
    "UndirectedCsrGraph",
    "build_directed",
    "build_undirected",
    "build_undirected_host",
    "csr_from_coo",
    "degree_order_permutation",
    "degree_partition",
    "make_degree_ordered",
    "to_undirected",
]
