"""PageRank as a Jacobi iteration, in plain PyTorch.

``scores = (1 - d) / n + d * sum over in-edges (s -> v) of scores[s] /
outdeg(s)``, from ``1 / n``; dangling nodes give nothing away.  The loop
runs while fewer than ``max_iterations`` have run and the last L1 change
is at least ``tolerance`` (the reference crate's rule,
crates/algos/src/page_rank.rs).  Duplicate edges count once each.
"""

from __future__ import annotations

from typing import Tuple

import torch


def jacobi(src: torch.Tensor, dst: torch.Tensor, n: int, *,
           damping_factor: float, tolerance: float, max_iterations: int,
           dtype: torch.dtype = torch.float64) -> Tuple[torch.Tensor, int]:
    """Scores (``dtype``, on the edges' device) and iterations run."""
    outdeg = torch.bincount(src, minlength=n).to(dtype)
    inv = torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1), 0.0).to(dtype)
    scores = torch.full((n,), 1.0 / n, dtype=dtype, device=src.device)
    base = (1.0 - damping_factor) / n
    iterations = 0
    while iterations < max_iterations:
        y = torch.zeros_like(scores).index_add_(0, dst, (scores * inv)[src])
        new = base + damping_factor * y
        err = float((new - scores).abs().sum())
        scores = new
        iterations += 1
        if err < tolerance:
            break
    return scores, iterations
