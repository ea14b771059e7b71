"""Graph500 binary edge input.

Counterpart of ``graph_tpu.io.graph500`` (reference analog:
``Graph500Input``, crates/builder/src/input/graph500.rs:7-127): the file
is a run of 12-byte ``PackedEdge {v0_low, v1_low, high}`` records, read
as one structured numpy view; ``node_count = edge_count / 16`` (the
Graph500 edge-factor convention, graph500.rs:73-74).  Ids above 2**31
need the int64 id dtype in the build.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PACKED = np.dtype([("v0_low", "<u4"), ("v1_low", "<u4"), ("high", "<u4")])


def read_graph500(path: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """Returns (src, dst, node_count), ids as int64."""
    raw = np.fromfile(path, dtype=PACKED)
    node_count = raw.shape[0] // 16
    high = raw["high"].astype(np.int64)
    # The high word holds bits 32-47 of both ids (graph500.rs:119-127).
    src = raw["v0_low"].astype(np.int64) | ((high & 0xFFFF) << 32)
    dst = raw["v1_low"].astype(np.int64) | ((high >> 16) << 32)
    return src, dst, node_count


def write_graph500(path: str, src, dst) -> None:
    """Write (src, dst) as packed Graph500 records (ids below 2**48)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    rec = np.empty(src.size, dtype=PACKED)
    rec["v0_low"] = src & 0xFFFFFFFF
    rec["v1_low"] = dst & 0xFFFFFFFF
    rec["high"] = ((src >> 32) & 0xFFFF) | (((dst >> 32) & 0xFFFF) << 16)
    rec.tofile(path)


class Graph500Input:
    def read(self, path: str):
        src, dst, node_count = read_graph500(path)
        return src, dst, None, node_count
