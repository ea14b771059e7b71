from graph_tpu_torch.algos.pagerank import (
    PageRankConfig, PageRankResult, page_rank, page_rank_reference)
from graph_tpu_torch.algos.sssp import (
    DeltaSteppingConfig, SsspResult, delta_stepping)
from graph_tpu_torch.algos.triangle_count import (
    TriangleCountResult, global_triangle_count)
from graph_tpu_torch.algos.wcc import (
    WccConfig, WccResult, wcc, wcc_afforest, wcc_afforest_dss, wcc_baseline,
    wcc_components)

__all__ = [
    "DeltaSteppingConfig",
    "PageRankConfig",
    "PageRankResult",
    "SsspResult",
    "TriangleCountResult",
    "WccConfig",
    "WccResult",
    "delta_stepping",
    "global_triangle_count",
    "page_rank",
    "page_rank_reference",
    "wcc",
    "wcc_afforest",
    "wcc_afforest_dss",
    "wcc_baseline",
    "wcc_components",
]
