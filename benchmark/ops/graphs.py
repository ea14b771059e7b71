"""The graphs that set-up hands to the ops, built once per run.

* :func:`api`: a ``graph_tpu_torch.api.DiGraph`` over
  ``graph_tpu_torch.graph.build.build_directed`` of the edge tensors on
  the card, unweighted, built as ``DiGraph.from_numpy`` builds it (32-bit
  ids, the largest id plus one nodes) without the edges' round trip
  through the host.
* :func:`weighted`: ``graph_tpu_torch.graph.build.build_directed`` with
  the weights (the function ``DiGraph.load`` calls; the API has no
  weighted in-memory constructor), with the configuration's node count.
* :func:`edges_host`: the ``(m, 2)`` int64 edge array on the host, for
  ops that build their own graph per request.
"""

from __future__ import annotations

import numpy as np
import torch

from graph_tpu_torch.api import ID_DTYPE, DiGraph
from graph_tpu_torch.graph import build


def edges_host(cell) -> np.ndarray:
    d = cell.data
    return torch.stack([d.src, d.dst], dim=1).cpu().numpy()


def api_nodes(cell) -> int:
    """``DiGraph.from_numpy``'s node count: the largest id plus one."""
    d = cell.data
    return int(torch.maximum(d.src.max(), d.dst.max())) + 1


def api(cell) -> DiGraph:
    d = cell.data
    return DiGraph(build.build_directed(d.src, d.dst, id_dtype=ID_DTYPE,
                                        device=cell.device))


def weighted(cell):
    d = cell.data
    return build.build_directed(d.src, d.dst, d.weights, node_count=d.n,
                                device=cell.device)
