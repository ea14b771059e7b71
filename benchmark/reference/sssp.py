"""Single-source shortest paths by Bellman-Ford, in plain PyTorch:
relax every edge, ``dist[v] = min(dist[v], dist[u] + w)``, until no
distance changes.  Unreached nodes keep +inf."""

from __future__ import annotations

import torch


def bellman_ford(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
                 n: int, start: int, *,
                 dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Distances from ``start`` in ``dtype``, on the edges' device."""
    w = weights.to(dtype)
    dist = torch.full((n,), float("inf"), dtype=dtype, device=src.device)
    dist[start] = 0
    while True:
        new = dist.scatter_reduce(0, dst, dist[src] + w, reduce="amin",
                                  include_self=True)
        if torch.equal(new, dist):
            return dist
        dist = new
