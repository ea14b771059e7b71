"""Global triangle count of an undirected graph, in plain PyTorch: each
triangle counted once.

The edge list may hold self-loops, repeated pairs and both directions of
a pair; they are dropped first, so the graph is simple.  Each edge is
then oriented from its lower to its higher end by (degree, id), and a
triangle is the one path u -> v -> w of forward edges whose ends u, w
are joined by a forward edge too.  For each forward edge (u -> v), in
chunks of about ``chunk`` paths, the paths u -> v -> w are enumerated
from the forward CSR (built with ``sort`` and ``bincount``) and the pair
(u, w) is looked up among the sorted forward keys.

Each chunk's matches are counted in int64 and added into a total held in
``dtype``: int64 gives the exact count; float32 (the control) rounds the
total, and every chunk's count, once they pass 2**24.
"""

from __future__ import annotations

import torch

#: Paths enumerated a chunk.  A path holds at most about 64 bytes of
#: temporaries at once, so a chunk about 9 GB: the reference runs on one
#: card at scale 22 once the program has freed its graph.
CHUNK = 1 << 27


def _simple_edges(src: torch.Tensor, dst: torch.Tensor, n: int):
    """Each undirected pair once, as (lo, hi) with lo < hi, sorted."""
    lo, hi = torch.minimum(src, dst).long(), torch.maximum(src, dst).long()
    keep = lo != hi
    keys = torch.unique(lo[keep] * n + hi[keep])
    return keys // n, keys % n


def count(src: torch.Tensor, dst: torch.Tensor, n: int, *,
          dtype: torch.dtype = torch.int64,
          chunk: int = CHUNK) -> torch.Tensor:
    """The triangles of the graph of edges (src, dst) over nodes 0..n-1,
    a 0-dim tensor in ``dtype`` on the edges' device."""
    dev = src.device
    total = torch.zeros((), dtype=dtype, device=dev)
    lo, hi = _simple_edges(src, dst, n)
    if lo.numel() == 0:
        return total
    deg = torch.bincount(lo, minlength=n) + torch.bincount(hi, minlength=n)
    # forward: from the lower to the higher end by (degree, id)
    up = (deg[lo] < deg[hi]) | ((deg[lo] == deg[hi]) & (lo < hi))
    u = torch.where(up, lo, hi)
    v = torch.where(up, hi, lo)
    keys = torch.sort(u * n + v).values
    u, v = keys // n, keys % n
    out = torch.bincount(u, minlength=n)
    starts = torch.cumsum(out, 0) - out
    # paths u -> v -> w a forward edge starts; edges are cut into chunks
    # of about ``chunk`` paths (one edge's paths never exceed n)
    paths = out[v]
    ends = torch.cumsum(paths, 0)
    marks = range(chunk, int(ends[-1]), chunk)
    cuts = torch.searchsorted(
        ends, torch.tensor(marks, dtype=ends.dtype, device=dev),
        right=True).tolist()
    for e0, e1 in zip([0] + cuts, cuts + [u.numel()]):
        if e1 <= e0:
            continue
        p = paths[e0:e1]
        edge = torch.repeat_interleave(torch.arange(e0, e1, device=dev), p)
        first = torch.cumsum(p, 0) - p
        pos = torch.arange(edge.numel(), device=dev) - \
            torch.repeat_interleave(first, p)
        w = v[starts[v[edge]] + pos]
        q = u[edge] * n + w
        i = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
        total += (keys[i] == q).sum().to(dtype)
    return total
