from graph_tpu_torch.graph.csr import Csr, CsrLayout, DirectedCsrGraph
from graph_tpu_torch.graph.build import build_directed, csr_from_coo

__all__ = [
    "Csr",
    "CsrLayout",
    "DirectedCsrGraph",
    "build_directed",
    "csr_from_coo",
]
