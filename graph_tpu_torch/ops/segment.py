"""Segment reductions over sorted edge arrays.

Counterpart of ``graph_tpu.ops.segment``: the segment sums and mins that
the algorithm paths outside the EdgeEngine (PageRank ``"cumsum"`` and
``"scatter"``, WCC and SSSP ``"xla"``) run over a CSR's row-sorted edge
arrays, as torch operations on the arrays' device.

* :func:`segment_sum_sorted` adds with ``index_add_``.  On the CPU it adds
  in index order; on a card the order of f32 additions is not fixed, so
  its sums agree with another order's only to rounding.
* :func:`segment_sum_fixedpoint` and :func:`segment_sum_quanta` quantize
  to ``round(x * 2**bits)`` (half to even) and take prefix differences of
  the int32 quanta, wrapped mod 2**32: every order gives the same bits,
  and the same bits as ``graph_tpu``.
* :func:`segment_min_sorted` and :func:`segment_max_sorted` start from
  ``jax.ops.segment_min``/``segment_max``'s fills for empty segments:
  +inf / -inf for floats, the dtype's max / min for integers.
"""

from __future__ import annotations

import numpy as np
import torch


def segment_sum_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sum ``data`` into ``num_segments`` buckets; ids must be ascending."""
    out = torch.zeros(num_segments, dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def _prefix(data: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``[0, cumsum(data)]`` in ``dtype``."""
    c = torch.zeros(data.numel() + 1, dtype=dtype, device=data.device)
    torch.cumsum(data, 0, dtype=dtype, out=c[1:])
    return c


def segment_sum_cumsum(data: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """Segment sum via an f32 cumulative sum and offset differences.

    ``offsets`` is the CSR offsets array (n+1).  Subtracting nearly equal
    prefixes loses precision on long streams, as in ``graph_tpu``.
    """
    c = _prefix(data, torch.float32)
    offsets = offsets.long()
    return c[offsets[1:]] - c[offsets[:-1]]


def _scale(bound: float, bits: int) -> float:
    """``float32(2**bits) / float32(bound)``, rounded to f32 as in JAX."""
    return float(np.float32(1 << bits) / np.float32(bound))


def segment_sum_quanta(data: torch.Tensor, offsets: torch.Tensor, *,
                       bound: float = 1.0, bits: int = 30) -> torch.Tensor:
    """Per-segment sums of ``round(data * 2**bits / bound)`` as int32 quanta,
    wrapped mod 2**32 (exact while every true segment sum is below 2**31).

    The prefix sums run in int64 and the differences are cast to int32,
    which wraps: the same bits as ``graph_tpu``'s int32 prefix sums."""
    q = torch.round(data * _scale(bound, bits)).to(torch.int32)
    c = _prefix(q, torch.int64)
    offsets = offsets.long()
    return (c[offsets[1:]] - c[offsets[:-1]]).to(torch.int32)


def segment_sum_fixedpoint(data: torch.Tensor, offsets: torch.Tensor, *,
                           bound: float = 1.0, bits: int = 30
                           ) -> torch.Tensor:
    """Exact-to-quantization segment sum: :func:`segment_sum_quanta`,
    dequantized to f32.

    ``bound`` must upper-bound every segment sum; the quantization error
    per element is 2**-bits * bound (PageRank row sums are <= 1)."""
    seg = segment_sum_quanta(data, offsets, bound=bound, bits=bits)
    return seg.to(torch.float32) / _scale(bound, bits)


def _fill(dtype: torch.dtype, high: bool):
    if dtype.is_floating_point:
        return float("inf") if high else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if high else info.min


def _segment_reduce(data, segment_ids, num_segments, op, high_fill):
    out = torch.full((num_segments,), _fill(data.dtype, high_fill),
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, segment_ids.long(), data, op)


def segment_min_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Min-reduce ``data`` per segment; empty segments get +inf/max."""
    return _segment_reduce(data, segment_ids, num_segments, "amin", True)


def segment_max_sorted(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Max-reduce ``data`` per segment; empty segments get -inf/min."""
    return _segment_reduce(data, segment_ids, num_segments, "amax", False)
