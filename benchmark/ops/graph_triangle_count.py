"""``Graph.global_triangle_count()`` on the DEDUPLICATED undirected
``graph_tpu_torch.api.Graph`` built in set-up over the card's edge
tensors (32-bit ids, the configuration's node count), the count returned
as a one-element host array."""

from __future__ import annotations

import numpy as np

from benchmark.ops import Answer
from benchmark.reference import triangles
from graph_tpu_torch.api import ID_DTYPE, Graph
from graph_tpu_torch.graph.build import build_undirected
from graph_tpu_torch.graph.csr import CsrLayout

KIND = "triangles"
SOURCE = False


def deduplicated(cell) -> Graph:
    d = cell.data
    return Graph(build_undirected(d.src, d.dst, node_count=d.n,
                                  layout=CsrLayout.DEDUPLICATED,
                                  id_dtype=ID_DTYPE, device=cell.device))


GRAPH = deduplicated


def call(cell, req, mark) -> Answer:
    res = cell.graph(GRAPH).global_triangle_count()
    mark("call")
    return Answer(np.array([res.triangles], dtype=np.int64),
                  micros=res.micros)


def nodes(cell) -> int:
    return cell.data.n


def ref_key(req):
    return (KIND,)


def reference(cell, req, dtype):
    d = cell.data
    return triangles.count(d.src, d.dst, d.n, dtype=dtype).reshape(1)
