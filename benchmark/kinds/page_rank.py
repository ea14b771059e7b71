"""PageRank scores, held against float64 Jacobi."""

from __future__ import annotations

import numpy as np
import torch

#: The reference's precision and the control's (below float32 scores).
REFERENCE = torch.float64
CONTROL = torch.bfloat16
#: The highest-ranked nodes of the reference that ``top_rel`` looks at.
TOP = 1000


def compare(answer: np.ndarray, ref: np.ndarray) -> dict:
    """``l1_rel``: the L1 distance over the reference's L1 norm;
    ``max_rel``: the largest relative error of a node; ``top_rel``: the
    largest relative error among the reference's ``TOP`` highest."""
    a = np.asarray(answer, dtype=np.float64)
    r = np.asarray(ref, dtype=np.float64)
    if a.shape != r.shape:
        return {"l1_rel": float("inf"), "max_rel": float("inf"),
                "top_rel": float("inf")}
    diff = np.abs(a - r)
    rel = diff / np.abs(r)
    top = np.argpartition(-r, min(TOP, r.size) - 1)[:TOP]
    return {"l1_rel": float(diff.sum() / np.abs(r).sum()),
            "max_rel": float(np.nan_to_num(rel, nan=np.inf).max()),
            "top_rel": float(np.nan_to_num(rel[top], nan=np.inf).max())}
