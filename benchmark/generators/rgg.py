"""DIMACS10's random geometric graph ``rgg_n_2_k``, on the device.

``n`` points uniform in the unit square; an undirected edge joins two
points closer than ``r = c * sqrt(ln n / n)`` (``c`` the configuration's
``radius_coefficient``, 0.55 in DIMACS10; Holtgrewe, Sanders and Schulz,
IPDPS 2010).  Each edge weighs its length in units of
``1 / per_unit_length`` of the square's side, rounded, at least ``low``.

The points are binned into square cells of side at least ``r``, so two
points closer than ``r`` lie in one cell or in two neighbouring ones.
Each point is compared with the points after it in its own cell and with
those of four of its eight neighbouring cells (east, north-west, north,
north-east), so every pair is compared once; the comparisons run in
chunks of at most ``CHUNK`` pairs.  Both arcs of each edge are returned,
with the same weight, after a seeded permutation of the ids.
"""

from __future__ import annotations

import math

import torch

from benchmark.generators import GraphData, graph500_kronecker

#: Pairs compared a chunk: at 16 bytes a coordinate pair and a few
#: temporaries of each, about 2 GB at most.
CHUNK = 1 << 25
#: The neighbouring cells each point is compared with, besides its own.
HALF = ((1, 0), (-1, 1), (0, 1), (1, 1))


def radius(config: dict) -> float:
    n = int(config["n"])
    return float(config["radius_coefficient"]) * math.sqrt(math.log(n) / n)


def make(config: dict, gen: torch.Generator) -> GraphData:
    n, r = int(config["n"]), radius(config)
    xy = torch.rand((n, 2), generator=gen, device=gen.device,
                    dtype=torch.float64)
    a, b, d2 = near_pairs(xy, r)
    del xy
    w = config["weights"]
    weights = torch.round(torch.sqrt(d2) * float(w["per_unit_length"]))
    weights = weights.clamp_(min=float(w["low"])).to(torch.float32)
    perm = torch.randperm(n, generator=gen, device=gen.device)
    a, b = perm[a], perm[b]
    return GraphData(src=torch.cat([a, b]), dst=torch.cat([b, a]), n=n,
                     weights=torch.cat([weights, weights]))


def near_pairs(xy: torch.Tensor, r: float):
    """Each pair of the points ``xy`` ((n, 2) float64) closer than ``r``,
    once: their indices ``a``, ``b`` and their squared distance."""
    n, dev = xy.shape[0], xy.device
    side = max(1, int(1.0 / r))  # cells a side, each at least r wide
    cxy = (xy * side).long().clamp_(max=side - 1)
    order = torch.argsort(cxy[:, 1] * side + cxy[:, 0])
    xy, cxy = xy[order], cxy[order]
    cell = cxy[:, 1] * side + cxy[:, 0]
    count = torch.bincount(cell, minlength=side * side)
    start = torch.cumsum(count, 0) - count
    # for each point and each cell it is compared with: the first point
    # there and how many
    pos = torch.arange(n, device=dev)
    firsts = [pos + 1]
    lengths = [start[cell] + count[cell] - pos - 1]
    for dx, dy in HALF:
        tx, ty = cxy[:, 0] + dx, cxy[:, 1] + dy
        inside = (tx >= 0) & (tx < side) & (ty < side)
        t = (ty * side + tx).clamp_(0, side * side - 1)
        firsts.append(start[t])
        lengths.append(torch.where(inside, count[t], 0))
    del cxy, cell, count, start
    owner = pos.repeat(len(firsts))
    first, length = torch.cat(firsts), torch.cat(lengths)
    del firsts, lengths, pos
    ends = torch.cumsum(length, 0)
    marks = range(CHUNK, int(ends[-1]), CHUNK)
    cuts = torch.searchsorted(ends, torch.tensor(
        marks, dtype=ends.dtype, device=dev), right=True).tolist()
    r2 = r * r
    a_parts, b_parts, d2_parts = [], [], []
    for e0, e1 in zip([0] + cuts, cuts + [owner.numel()]):
        if e1 <= e0:
            continue
        k = length[e0:e1]
        entry = torch.repeat_interleave(torch.arange(e0, e1, device=dev), k)
        offset = torch.arange(entry.numel(), device=dev) - \
            torch.repeat_interleave(torch.cumsum(k, 0) - k, k)
        a = owner[entry]
        b = first[entry] + offset
        d2 = ((xy[a] - xy[b]) ** 2).sum(1)
        near = d2 < r2
        a_parts.append(order[a[near]])
        b_parts.append(order[b[near]])
        d2_parts.append(d2[near])
    return torch.cat(a_parts), torch.cat(b_parts), torch.cat(d2_parts)


def sources(data: GraphData, count: int, gen: torch.Generator) -> list:
    """``count`` distinct sources among the vertices with an edge (every
    one has an out-arc)."""
    return graph500_kronecker.sources(data, count, gen)
