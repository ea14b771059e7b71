from graph_tpu_torch.algos.pagerank import (
    PageRankConfig, PageRankResult, page_rank)
from graph_tpu_torch.algos.sssp import (
    DeltaSteppingConfig, SsspResult, delta_stepping)
from graph_tpu_torch.algos.wcc import (
    WccConfig, WccResult, wcc, wcc_afforest, wcc_afforest_dss, wcc_baseline,
    wcc_components)

__all__ = [
    "DeltaSteppingConfig",
    "PageRankConfig",
    "PageRankResult",
    "SsspResult",
    "WccConfig",
    "WccResult",
    "delta_stepping",
    "page_rank",
    "wcc",
    "wcc_afforest",
    "wcc_afforest_dss",
    "wcc_baseline",
    "wcc_components",
]
