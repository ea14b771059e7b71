"""Edge-list text input (``.el`` / weighted ``.wel``).

Counterpart of ``graph_tpu.io.edgelist`` (reference analog:
``EdgeListInput``, crates/builder/src/input/edgelist.rs:15-278: mmap +
one parser thread per page-aligned chunk, byte-level ASCII digit
parsing, Windows newlines).

Parsing is host work: the native C++ chunked parser
(:mod:`graph_tpu_torch.native.edge_list_parser`) is the fast path and
pandas' C csv engine the fallback when the parser cannot be built;
``edge_list_parser.load_error()`` then says why.

Each parse is an ``io.parse`` span (:mod:`graph_tpu_torch.profile`)
with counters ``bytes`` (the file's size), ``edges`` (the lines
parsed), ``threads`` (the threads the parser split the file over) and
``native`` (1 for the native parser, 0 for pandas).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from graph_tpu_torch import profile
from graph_tpu_torch.native import edge_list_parser


def _parse_pandas(path: str, weighted: bool):
    import pandas as pd

    df = pd.read_csv(
        path,
        sep=r"\s+",
        header=None,
        comment=None,
        engine="c",
        dtype={0: np.int64, 1: np.int64,
               **({2: np.float32} if weighted else {})},
    )
    src = df[0].to_numpy()
    dst = df[1].to_numpy()
    values = (df[2].to_numpy(dtype=np.float32)
              if weighted and df.shape[1] > 2 else None)
    return src, dst, values


def read_edge_list(
    path: str, weighted: Optional[bool] = None
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Parse an edge-list file into int64 COO arrays (and f32 values).

    ``weighted=None`` infers from the extension (``.wel`` = weighted,
    mirroring the reference's ``.el``/``.wel`` convention,
    edgelist.rs:23-31).
    """
    if weighted is None:
        weighted = str(path).endswith(".wel")
    with profile.span("io.parse") as sp:
        parsed = edge_list_parser.parse(path, weighted)
        native = parsed is not None
        if not native:
            parsed = _parse_pandas(path, weighted)
        if sp:
            size = os.path.getsize(path)
            sp.count(bytes=size, edges=len(parsed[0]), native=int(native),
                     threads=edge_list_parser.threads(size) if native else 1)
        return parsed


class EdgeListInput:
    """``InputCapabilities`` analog for edge lists (edgelist.rs:15-45)."""

    def __init__(self, weighted: Optional[bool] = None):
        self.weighted = weighted

    def read(self, path: str):
        src, dst, values = read_edge_list(path, self.weighted)
        # Reference: node_count = max_node_id + 1 (edgelist.rs:84-90).
        return src, dst, values, None
