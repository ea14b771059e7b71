"""GAP's ``kron`` graph, on the device: the Graph500 Kronecker draws
(:mod:`benchmark.generators.graph500_kronecker`, labels permuted) made
undirected, with self-loops and repeated pairs dropped.

Each undirected edge is returned once, as (lo, hi) with lo < hi, so the
edge count is the graph's as GAP counts it (about 64.2 M of the 67.1 M
draws at scale 22).  No mix on this graph starts from a source, so the
module has no ``sources``.
"""

from __future__ import annotations

import torch

from benchmark.generators import GraphData, graph500_kronecker


def make(config: dict, gen: torch.Generator) -> GraphData:
    drawn = graph500_kronecker.make(config, gen)
    n = drawn.n
    lo = torch.minimum(drawn.src, drawn.dst)
    hi = torch.maximum(drawn.src, drawn.dst)
    del drawn
    keep = lo != hi
    keys = torch.unique(lo[keep] * n + hi[keep])
    del lo, hi, keep
    return GraphData(src=keys // n, dst=keys % n, n=n)

