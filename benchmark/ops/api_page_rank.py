"""``DiGraph.page_rank(...)`` then ``.scores()`` on the graph built in
set-up by ``DiGraph.from_numpy``."""

from __future__ import annotations

from benchmark.ops import Answer, graphs, refs

KIND = "page_rank"
GRAPH = graphs.api
SOURCE = False


def call(cell, req, mark) -> Answer:
    res = cell.graph(GRAPH).page_rank(**req.params)
    mark("call")
    return Answer(res.scores(), micros=res.micros,
                  iterations=res.ran_iterations)


def nodes(cell) -> int:
    return cell.memo(graphs.api_nodes)


def ref_key(req):
    return (KIND, tuple(sorted(req.params.items())))


def reference(cell, req, dtype):
    return refs.page_rank(cell, nodes(cell), req.params, dtype)
