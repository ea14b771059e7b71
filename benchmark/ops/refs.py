"""The plain reference's answer to each kind of request, over the edge
arrays the benchmark made (``cell.data``), never the program's graph."""

from __future__ import annotations

import torch

from benchmark.reference import pagerank, sssp, wcc


def page_rank(cell, n: int, params: dict, dtype: torch.dtype) -> torch.Tensor:
    d = cell.data
    return pagerank.jacobi(
        d.src, d.dst, n, damping_factor=float(params["damping_factor"]),
        tolerance=float(params["tolerance"]),
        max_iterations=int(params["max_iterations"]), dtype=dtype)[0]


def components(cell, n: int, dtype: torch.dtype) -> torch.Tensor:
    d = cell.data
    return wcc.min_label(d.src, d.dst, n, dtype=dtype)


def distances(cell, n: int, start: int, dtype: torch.dtype) -> torch.Tensor:
    d = cell.data
    return sssp.bellman_ford(d.src, d.dst, d.weights, n, start, dtype=dtype)
