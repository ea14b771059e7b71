"""graph_tpu_torch — the PyTorch and CUDA port of graph_tpu, for an NVIDIA H100.

A package of its own beside ``graph_tpu`` (the JAX reference it is held
against); it imports torch and numpy and nothing of JAX or graph_tpu.
Ported so far: the plan-engine PageRank path — CSR build, the
EdgeEngine with its hand-written CUDA kernels K1 and K2, and PageRank.

Entry points run on the card unless the caller passes ``device="cpu"``,
and raise when no card is present and no device is given.
"""

from graph_tpu_torch.algos import PageRankConfig, PageRankResult, page_rank
from graph_tpu_torch.engine import EdgeEngine, EdgePlan
from graph_tpu_torch.graph import (
    Csr, CsrLayout, DirectedCsrGraph, build_directed, csr_from_coo)

__all__ = [
    "Csr",
    "CsrLayout",
    "DirectedCsrGraph",
    "EdgeEngine",
    "EdgePlan",
    "PageRankConfig",
    "PageRankResult",
    "build_directed",
    "csr_from_coo",
    "page_rank",
]
