"""Component labels, held against the min-label reference."""

from __future__ import annotations

import numpy as np
import torch

#: The reference's precision and the control's (below int32 labels).
REFERENCE = torch.int64
CONTROL = torch.int16


def compare(answer: np.ndarray, ref: np.ndarray) -> dict:
    """``mismatched``: nodes whose label is not the least id of their
    component."""
    a = np.asarray(answer).astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    if a.shape != r.shape:
        return {"mismatched": float(max(a.size, r.size))}
    return {"mismatched": float(np.count_nonzero(a != r))}
