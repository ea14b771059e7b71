"""Shortest distances, held against float64 Bellman-Ford."""

from __future__ import annotations

import numpy as np
import torch

#: The reference's precision and the control's (below float32 distances).
REFERENCE = torch.float64
CONTROL = torch.bfloat16
#: The program's mark of an unreached node (the reference crate's f32::MAX).
UNREACHED = float(np.finfo(np.float32).max)


def compare(answer: np.ndarray, ref: np.ndarray) -> dict:
    """``rel_err``: the largest relative error of a distance; a node
    reached on one side only, or a wrong distance to the source, reads
    infinite."""
    a = np.asarray(answer, dtype=np.float64)
    r = np.asarray(ref, dtype=np.float64)
    if a.shape != r.shape:
        return {"rel_err": float("inf")}
    a_unreached = ~(a < UNREACHED)  # NaN counts as unreached
    r_unreached = np.isinf(r)
    if np.any(a_unreached != r_unreached):
        return {"rel_err": float("inf")}
    both = ~r_unreached
    diff = np.abs(a[both] - r[both])
    scale = np.abs(r[both])
    if np.any((scale == 0) & (diff > 0)):
        return {"rel_err": float("inf")}
    rel = np.divide(diff, scale, out=np.zeros_like(diff), where=scale > 0)
    return {"rel_err": float(rel.max(initial=0.0))}
