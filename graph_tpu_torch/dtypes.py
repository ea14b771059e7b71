"""Node-id dtype policy (the port's own copy of ``graph_tpu.dtypes``).

Graphs are parametrized by an integer dtype for ids: int32 by default
(the reference's Python bindings fix ids to u32), int64 for graphs with
more than 2^31 nodes.  PyTorch has int64 natively, so unlike the JAX
package no 64-bit mode has to be switched on first.
"""

from __future__ import annotations

import numpy as np
import torch

#: Default id dtype — mirrors graph_mate's fixed u32 ids.
DEFAULT_ID_DTYPE = np.int32

#: Default edge-value / score dtype (the reference uses f32 throughout).
DEFAULT_VALUE_DTYPE = np.float32

_TORCH_IDS = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64}


def canonical_id_dtype(dtype) -> np.dtype:
    """Validate and canonicalize an id dtype.

    Unsigned inputs map onto the signed dtype of the same width (ids are
    always < 2^31 / 2^63).  Accepts numpy dtypes and torch dtypes.
    """
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty(0, dtype=dtype).numpy().dtype
    dt = np.dtype(dtype)
    if dt in (np.dtype(np.uint32), np.dtype(np.int32)):
        return np.dtype(np.int32)
    if dt in (np.dtype(np.uint64), np.dtype(np.int64)):
        return np.dtype(np.int64)
    raise TypeError(
        f"Unsupported id dtype {dt!r}; expected one of int32/uint32/int64/uint64"
    )


def torch_id_dtype(dtype) -> torch.dtype:
    """The torch dtype of a canonical id dtype."""
    return _TORCH_IDS[canonical_id_dtype(dtype)]


def check_node_count_fits(node_count: int, dtype) -> None:
    """Raise if ``node_count`` does not fit the id dtype."""
    dt = canonical_id_dtype(dtype)
    if node_count > np.iinfo(dt).max:
        raise OverflowError(
            f"node_count {node_count} exceeds id dtype {dt} "
            f"(max {np.iinfo(dt).max}); use int64 ids"
        )
