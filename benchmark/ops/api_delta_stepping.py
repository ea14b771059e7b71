"""``DiGraph.delta_stepping(start_node=..., delta=...)`` then
``.distances()`` on the weighted ``graph_tpu_torch.api.DiGraph`` built
in set-up over the card's edge tensors (32-bit ids, the configuration's
node count).  The API's result copies the distances to the host as it
is made, so ``mark("call")`` follows that copy."""

from __future__ import annotations

from benchmark.ops import Answer
from benchmark.reference import sssp_worklist
from graph_tpu_torch.api import ID_DTYPE, DiGraph
from graph_tpu_torch.graph.build import build_directed

KIND = "sssp"
SOURCE = True


def weighted_api(cell) -> DiGraph:
    d = cell.data
    return DiGraph(build_directed(d.src, d.dst, d.weights, node_count=d.n,
                                  id_dtype=ID_DTYPE, device=cell.device))


GRAPH = weighted_api


def call(cell, req, mark) -> Answer:
    res = cell.graph(GRAPH).delta_stepping(
        start_node=req.source, delta=float(req.params["delta"]))
    mark("call")
    return Answer(res.distances(), micros=res.micros)


def nodes(cell) -> int:
    return cell.data.n


def ref_key(req):
    return (KIND, req.source)


def reference(cell, req, dtype):
    d = cell.data
    return sssp_worklist.bellman_ford(d.src, d.dst, d.weights, d.n,
                                      req.source, dtype=dtype)
