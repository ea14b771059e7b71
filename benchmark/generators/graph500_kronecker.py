"""The Graph500 Kronecker (R-MAT) generator, on the device.

Graph500 specification, section 3: ``edgefactor << scale`` edges, each
drawn bit by bit from the quadrant probabilities A, B, C (D = 1 - A - B -
C), then the vertex labels permuted at random.  Edges are independent
draws, so the specification's shuffle of the edge list changes no
distribution and is left out.  Duplicates and self-loops are kept.
Kernel 3's weights are uniform in [0, 1).  The 64 search keys are drawn
among the vertices with an out-edge.
"""

from __future__ import annotations

import torch

from benchmark.generators import GraphData, uniform_weights


def make(config: dict, gen: torch.Generator) -> GraphData:
    scale, edgefactor = int(config["scale"]), int(config["edgefactor"])
    a, b, c = float(config["A"]), float(config["B"]), float(config["C"])
    n, m = 1 << scale, edgefactor << scale
    dev = gen.device
    src = torch.zeros(m, dtype=torch.int64, device=dev)
    dst = torch.zeros(m, dtype=torch.int64, device=dev)
    # P(src bit) = C + D; given it, P(dst bit) = D / (C + D); else B / (A + B)
    p_src = 1.0 - a - b
    p_dst_hi = (1.0 - a - b - c) / p_src
    p_dst_lo = b / (a + b)
    for bit in range(scale):
        r = torch.rand((2, m), generator=gen, device=dev)
        s_bit = r[0] < p_src
        d_bit = torch.where(s_bit, r[1] < p_dst_hi, r[1] < p_dst_lo)
        src |= s_bit.to(torch.int64) << bit
        dst |= d_bit.to(torch.int64) << bit
        del r, s_bit, d_bit
    perm = torch.randperm(n, generator=gen, device=dev)
    src, dst = perm[src], perm[dst]
    weights = None
    if config.get("weights"):
        w = config["weights"]
        weights = uniform_weights(m, float(w["low"]), float(w["high"]), gen)
    return GraphData(src=src, dst=dst, n=n, weights=weights)


def sources(data: GraphData, count: int, gen: torch.Generator) -> list:
    """``count`` distinct search keys among the vertices with an out-edge."""
    outdeg = torch.bincount(data.src, minlength=data.n)
    keys = torch.nonzero(outdeg > 0).flatten()
    pick = torch.randperm(keys.numel(), generator=gen, device=gen.device)
    return keys[pick[:count].to(keys.device)].tolist()
