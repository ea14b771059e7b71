"""Single-source shortest paths by Bellman-Ford over a worklist, in plain
PyTorch: each round relaxes only the out-arcs of the nodes whose
distance changed in the round before, ``dist[v] = min(dist[v], dist[u] +
w)``, until no distance changes.  Unreached nodes keep +inf.

The same least fixpoint as :func:`benchmark.reference.sssp.bellman_ford`,
which relaxes every edge each round: on a graph whose shortest paths
have thousands of arcs, that is thousands of sweeps of the whole graph,
where this relaxes about as many arcs as a few sweeps.
"""

from __future__ import annotations

import torch


def bellman_ford(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
                 n: int, start: int, *,
                 dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Distances from ``start`` in ``dtype``, on the edges' device."""
    dev = src.device
    order = torch.argsort(src)
    out_dst, out_w = dst[order], weights[order].to(dtype)
    del order
    degree = torch.bincount(src, minlength=n)
    offsets = torch.cumsum(degree, 0) - degree
    dist = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    dist[start] = 0
    changed = torch.tensor([start], device=dev)
    while changed.numel():
        k = degree[changed]
        arc = torch.repeat_interleave(offsets[changed] - torch.cumsum(k, 0)
                                      + k, k) + torch.arange(
            int(k.sum()), device=dev)
        tail = torch.repeat_interleave(changed, k)
        new = dist.scatter_reduce(0, out_dst[arc], dist[tail] + out_w[arc],
                                  reduce="amin", include_self=True)
        changed = torch.nonzero(new < dist).flatten()
        dist = new
    return dist
