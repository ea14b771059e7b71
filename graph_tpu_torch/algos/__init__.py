from graph_tpu_torch.algos.pagerank import (
    PageRankConfig, PageRankResult, page_rank)

__all__ = ["PageRankConfig", "PageRankResult", "page_rank"]
