"""graph_tpu_torch — the PyTorch and CUDA port of graph_tpu, for an NVIDIA H100.

A package of its own beside ``graph_tpu`` (the JAX reference it is held
against); it imports torch and numpy and nothing of JAX or graph_tpu.
Ported so far: CSR graphs (directed and undirected) built on the device,
the EdgeEngine with its hand-written CUDA kernels K1 and K2 and its whole
semiring surface (sums, mins, weighted combines), and the plan-engine
paths of PageRank, WCC and SSSP.

Entry points run on the card unless the caller passes ``device="cpu"``,
and raise when no card is present and no device is given.
"""

from graph_tpu_torch.algos import (
    DeltaSteppingConfig, PageRankConfig, PageRankResult, SsspResult,
    WccConfig, WccResult, delta_stepping, page_rank, wcc, wcc_afforest,
    wcc_afforest_dss, wcc_baseline, wcc_components)
from graph_tpu_torch.engine import EdgeEngine, EdgePlan
from graph_tpu_torch.graph import (
    Csr, CsrLayout, DirectedCsrGraph, UndirectedCsrGraph, build_directed,
    build_undirected, csr_from_coo)

__all__ = [
    "Csr",
    "CsrLayout",
    "DeltaSteppingConfig",
    "DirectedCsrGraph",
    "EdgeEngine",
    "EdgePlan",
    "PageRankConfig",
    "PageRankResult",
    "SsspResult",
    "UndirectedCsrGraph",
    "WccConfig",
    "WccResult",
    "build_directed",
    "build_undirected",
    "csr_from_coo",
    "delta_stepping",
    "page_rank",
    "wcc",
    "wcc_afforest",
    "wcc_afforest_dss",
    "wcc_baseline",
    "wcc_components",
]
