from graph_tpu_torch.graph.csr import (
    Csr, CsrLayout, DirectedCsrGraph, UndirectedCsrGraph)
from graph_tpu_torch.graph.build import (
    build_directed, build_undirected, csr_from_coo)

__all__ = [
    "Csr",
    "CsrLayout",
    "DirectedCsrGraph",
    "UndirectedCsrGraph",
    "build_directed",
    "build_undirected",
    "csr_from_coo",
]
