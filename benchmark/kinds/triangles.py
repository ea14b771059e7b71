"""A global triangle count, held against the int64 count."""

from __future__ import annotations

import numpy as np
import torch

#: The reference's precision and the control's: a float32 total rounds
#: above 2**24, where an int64 count is exact.
REFERENCE = torch.int64
CONTROL = torch.float32


def compare(answer: np.ndarray, ref: np.ndarray) -> dict:
    """``off``: the absolute difference of the counts; infinite where
    the answer's shape is not the reference's."""
    a = np.asarray(answer)
    r = np.asarray(ref)
    if a.shape != r.shape:
        return {"off": float("inf")}
    diff = np.abs(a.astype(np.float64) - r.astype(np.float64))
    return {"off": float(diff.max(initial=0.0))}
