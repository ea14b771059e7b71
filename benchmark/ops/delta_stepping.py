"""``graph_tpu_torch.algos.sssp.delta_stepping(graph,
DeltaSteppingConfig(source, delta))`` on the weighted graph built in
set-up, the distances copied to the host."""

from __future__ import annotations

from benchmark.ops import Answer, graphs, refs
from graph_tpu_torch.algos import sssp

KIND = "sssp"
GRAPH = graphs.weighted
SOURCE = True


def call(cell, req, mark) -> Answer:
    res = sssp.delta_stepping(cell.graph(GRAPH), sssp.DeltaSteppingConfig(
        req.source, float(req.params["delta"])))
    mark("call")
    return Answer(res.distances_np(), micros=res.micros,
                  iterations=res.ran_iterations)


def nodes(cell) -> int:
    return cell.data.n


def ref_key(req):
    return (KIND, req.source)


def reference(cell, req, dtype):
    return refs.distances(cell, nodes(cell), req.source, dtype)
