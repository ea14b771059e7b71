"""Weakly connected components by min-label propagation, in plain
PyTorch: every node starts with its own id and takes the least label
among itself and its neighbours, over the edges in both directions,
until nothing changes.  A node's label is then the least id of its
component."""

from __future__ import annotations

import torch


def min_label(src: torch.Tensor, dst: torch.Tensor, n: int, *,
              dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Labels, stored in ``dtype``, on the edges' device.  Each round
    takes its minimum over the stored labels, widened to int64."""
    a = torch.cat([src, dst])
    b = torch.cat([dst, src])
    labels = torch.arange(n, device=src.device).to(dtype)
    while True:
        wide = labels.to(torch.int64)
        new = wide.scatter_reduce(0, b, wide[a], reduce="amin",
                                  include_self=True).to(dtype)
        if torch.equal(new, labels):
            return labels
        labels = new
